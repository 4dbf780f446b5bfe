"""A traced run: the profiler over the window, reduced to what the
per-layer readers take.

Device time is the union of the card's intervals (kernels, copies,
sets) inside the window, so overlapping records count once.  Each kernel
is tied to the host thread and label that launched it: through the
launch call's correlation id to the innermost benchmark label (``train.
step``, ``serve.prefill``, ...) open on that thread at the launch.  A
launch call whose device record is missing is counted as lost (the
profiler can drop records under load)."""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

WINDOW = "bench.window"
#: launch calls of the CUDA runtime and driver that run device work
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
            "cudaMemcpy", "cudaMemset", "cudaLaunchCooperativeKernel")


class Ev(NamedTuple):
    name: str
    start: int          # ns
    end: int            # ns
    thread: int
    corr: int


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    kernels: Dict[str, float]               # name -> device seconds
    by_label: Dict[Tuple[str, str], float]  # (label, kernel) -> seconds
    launches: Dict[Tuple[str, str], int]    # (label, kernel) -> count
    label_counts: Dict[str, int]            # host label -> times opened
    lost: int
    device_ops: List[list]
    idle_gaps: List[list]

    def time(self, kernel_prefix: str, label: Optional[str] = None
             ) -> float:
        if label is None:
            return sum(v for k, v in self.kernels.items()
                       if k.startswith(kernel_prefix))
        return sum(v for (lb, k), v in self.by_label.items()
                   if lb == label and k.startswith(kernel_prefix))

    def count(self, kernel_prefix: str, label: Optional[str] = None) -> int:
        return sum(v for (lb, k), v in self.launches.items()
                   if k.startswith(kernel_prefix)
                   and (label is None or lb == label))

    def as_line(self) -> dict:
        return {"busy_s": self.busy_s, "window_s": self.window_s,
                "device_ops": self.device_ops, "idle_gaps": self.idle_gaps}


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class _Labels:
    """The benchmark's host labels of one thread, for the innermost label
    open at an instant."""

    def __init__(self, evs: List[Ev]):
        self.evs = sorted(evs, key=lambda e: (e.start, -e.end))
        self.starts = [e.start for e in self.evs]

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        best = None
        # walk back over labels that start before t; nested ones are
        # found first, and a few steps suffice as labels nest shallowly
        for j in range(i, max(i - 64, -1), -1):
            e = self.evs[j]
            if e.end >= t:
                best = e.name
                break
        return best


def reduce(device: List[Ev], host_calls: List[Ev], labels: List[Ev],
           window: Tuple[int, int], top: int = 10) -> Reduced:
    """``device``: the card's records (corr = the runtime's correlation
    id, which the launch call carries too);
    ``host_calls``: runtime launch calls; ``labels``: the benchmark's host
    labels; ``window``: (start, end) in the same clock."""
    w0, w1 = window
    by_thread: Dict[int, List[Ev]] = defaultdict(list)
    counts: Dict[str, int] = defaultdict(int)
    for e in labels:
        by_thread[e.thread].append(e)
        if w0 <= e.start < w1:
            counts[e.name] += 1
    finders = {t: _Labels(v) for t, v in by_thread.items()}
    launch_of = {c.corr: c for c in host_calls}
    seen = set()
    kernels: Dict[str, float] = defaultdict(float)
    by_label: Dict[Tuple[str, str], float] = defaultdict(float)
    launches: Dict[Tuple[str, str], int] = defaultdict(int)
    iv = []
    for d in device:
        s, e = max(d.start, w0), min(d.end, w1)
        if e <= s:
            continue
        iv.append((s, e))
        sec = (e - s) * 1e-9
        kernels[d.name] += sec
        call = launch_of.get(d.corr)
        label = "other"
        if call is not None:
            seen.add(d.corr)
            f = finders.get(call.thread)
            label = (f.at(call.start) if f else None) or "other"
        by_label[(label, d.name)] += sec
        launches[(label, d.name)] += 1
    lost = sum(1 for c in host_calls if w0 <= c.start < w1
               and c.corr not in seen and c.end < w1 - 10**9)
    busy = _union(iv)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    gaps.sort(reverse=True)

    def host_at(t: int) -> str:
        names = sorted({f.at(t) for f in finders.values()} - {None})
        return "+".join(names) if names else "no label"

    idle = [[host_at((a + b) // 2), n * 1e-9] for n, a, b in gaps[:top]]
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return Reduced(window_s=(w1 - w0) * 1e-9, busy_s=busy_s,
                   kernels=dict(kernels), by_label=dict(by_label),
                   launches=dict(launches), label_counts=dict(counts),
                   lost=lost, device_ops=[[k, v] for k, v in ops],
                   idle_gaps=idle)


def _all_threads() -> dict:
    """Profile every thread's host operations and labels, where this
    torch can."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


class Tracer:
    """``with tracer:`` profiles the card and the host while ``enabled``;
    ``window()`` marks the measured window inside it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts, **_all_threads())
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def window(self):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(WINDOW)

    def reduce(self, label_names) -> Reduced:
        """The profile reduced to the window (kineto's raw events)."""
        from torch.autograd import DeviceType
        device, calls, labels = [], [], []
        win = None
        names = set(label_names)
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            s = e.start_ns()
            ev = None
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():    # a label's device span
                    device.append(Ev(name, s, s + e.duration_ns(),
                                     e.device_index(), e.correlation_id()))
                continue
            if name in LAUNCHES:
                ev = Ev(name, s, s + e.duration_ns(), e.start_thread_id(),
                        e.correlation_id())
                calls.append(ev)
            elif name == WINDOW:
                win = (s, s + e.duration_ns())
            elif name in names:
                labels.append(Ev(name, s, s + e.duration_ns(),
                                 e.start_thread_id(), 0))
        if win is None:
            raise RuntimeError("the traced window's label is missing")
        return reduce(device, calls, labels, win)
