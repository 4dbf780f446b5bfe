#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of the Multiverse STM on one GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; it
imports nothing of JAX or of the JAX package.  Phases, in order (but the
checks of phase 3 run before those of phase 2: the CPU runs of the
full-width train checks start in a thread at the beginning and run
beside the build, the schedules and the model checks, which trace and
time nothing) — any failure exits non-zero and no result line is
printed:

  1. the card's name and power limit (``nvidia-smi``), then the build of
     the kernels from ``src/repro_torch/csrc`` (timed), and the
     tensor-core kernels' (attention's and the SSD scan's) registers and
     spills (``ptxas -v``, none may spill) and their ``HMMA``
     instructions (``cuobjdump -sass``);
  2. each kernel against its plain PyTorch version on the card at the
     listed shapes — the six integer kernels bit for bit, the bracketed
     gather and ``commit_fused``'s ring refresh, device lock words and
     fault split included, ``validate_words`` (a bulk revalidation in
     one launch) in every mode, both clock ranges and both of its routes,
     ``mirror_select`` (a versioned chunk's mirror resolve in one launch)
     on both of its argument routes, and ``scatter_write`` from host
     columns (parameter and staged routes, the fill form, a repeated
     index) and from columns on the card, ``gather_read_home`` (the
     gather and its copy home in one call) and the scalar word read
     ``read_word`` (int64 and int32 rows, a view) against the row (and
     ``snapshot_select`` refused
     on a side stream; its, ``commit_fused``'s, the bracketed gather's, a
     bulk revalidation's, a versioned chunk's and a host-column scatter's
     host time split into parts, and the last two, the write-back and the
     release timed in paired turns beside the paths they replaced, their
     device operations counted in a profiler trace),
     ``flash_attention`` (head dims 40 to 256)
     within 2e-2 at bfloat16 and 2e-4 at float32, ``fused_adamw``'s
     parameters and ring within 2e-2 at bfloat16 and 1e-5 at float32 and
     its moments within 1e-5, ``ssd_scan``'s output within 2e-3 at
     float32 and 5e-2 at bfloat16 and its final state within 2e-3 (rtol
     = atol, the JAX package's ``tests/test_kernels.py`` tolerances), and
     each of its four launches against its plain stage (the f32 scratch
     within 2e-3, y within the same tolerances) — then timed with CUDA
     events
     beside the plain version, the library call where one exists, and
     the bound, and traced with ``torch.profiler`` for the kernels' own
     device time; and the attention gradient (``FlashAttentionFn``: the
     kernel forward, the plain backward) against autograd through
     ``naive_attention`` on the card, and the SSD scan's gradient
     (``SSDScanFn``: the kernel forward, ``ssd_scan_bwd`` backward: the
     backward kernel for bf16, the plain scan's gradient for f32) against
     autograd through ``ssd_scan_plain`` on
     the card at every ``SSD_CASES`` shape and at mamba2-780m's training
     shape (its backward's peak memory recorded); and the SSD scan's
     backward kernel (``ssd_scan_bwd``, five launches in one C call)
     against the plain backward at every ``SSD_BWD_CASES`` shape within
     ``SSD_BWD_TOL`` of each gradient's largest element, its launches'
     scratch against the plain stages, two calls bit for bit, timed at
     train_U's shape beside the plain backward and its bound;
  3. end to end: the same seeded two-thread schedule through
     ``make_tm(b, array_heap=True)`` for b in multiverse, tl2, dctl,
     norec, tinystm and mvstore, on the card and on the CPU, must leave
     identical heaps (blocks and rings), lock words, clocks, mirrors and
     counters; and qwen2.5-3b at full width and a depth of 2 layers, the
     same seeded weights on the card and on the CPU, must give prefill
     and 4 decode steps' float32 logits within 2e-4 and the same greedy
     tokens, and bfloat16 logits no further from the float32 ones than
     twice the CPU's bfloat16 logits are; the same for mamba2-780m at
     full width and a depth of 2 (a prefill of 2 x 512 tokens through
     ``ssd_scan``); and the trainer over each of the two at the same
     width and depth, float32, 2 x 64 tokens, 2 steps in Mode Q, Mode U
     and Mode U fused on the card and on the CPU from the same weights:
     losses, parameters and moments within 1e-4, the fused run within
     2e-3 of the unfused one (the JAX package's ``tests/test_train_e2e
     .py`` tolerance), and each run's second step counted by
     ``launch.roofline.count()`` on both devices: the same flops and
     bytes, integer for integer, as the CPU run of the same mode (the
     CPU's plain routes, the card's kernels);
  4. the main path: ``make_tm(b, n, array_heap=True)`` on the card drives
     the longread (scan4096 on every backend, scan1M on multiverse) and
     rwmix (w1024, every backend) traffic in threads (1 s windows); TL2
     and DCTL
     commit 1024-word rotations in groups of 8 through ``CommitBatcher``
     over a 1,000,000-word heap; and the MVStore serves 1,000,000-word
     snapshots beside 2-word transfers, then resolves every clock of its
     ring window through ``MVStoreHandle.snapshot``.  Every completed
     scan or check must see its exact invariant sum (``violations ==
     0``), every trial must make progress (for the unversioned baselines
     under a long scan: in updates), every kernel's launch counter —
     set to 0 before each trial and read after it — must have risen, and
     a scanned chunk must take exactly one bracketed gather (and, read
     by a versioned multiverse reader, one ``mirror_select`` as well), and
     a bulk revalidation one ``validate`` launch and no gather, on each
     lock-version backend (launches per chunk and per revalidation,
     counted once the trial's workers stopped), and some trial window
     must have resolved versioned reads through ``mirror_select``;
     then the model server: ``repro_torch.launch.serve.Server`` serves
     qwen2.5-3b at full width and depth from MVStore snapshots (8 seeded
     requests of 512 prompt tokens and 32 new tokens through 4 slots;
     every prefill attention through ``flash_attention``), and a writer
     commits a new version (``lm_head`` negated) while 4 requests
     decode: in Mode U no request aborts and the tokens are those of a
     run without the commit (``snapshot_select`` serves the pinned
     version from the ring); in Mode Q every in-flight request aborts
     and restarts, and all complete; then the same server over
     mamba2-780m at full width and depth (8 requests of 512 prompt and
     32 new tokens; every Mamba layer of every prefill through
     ``ssd_scan``) and its Mode U commit check (``final_norm`` negated);
     then the trainer:
     ``repro_torch.launch.train.Trainer`` trains qwen2.5-3b at full width
     and depth (bfloat16, random weights from seed 0, 4 x 512 tokens a
     step) for 20 steps under ``TrainSupervisor.run`` in Mode U with the
     fused commit — every leaf of every step through ``fused_adamw`` —
     while a reader one step behind must get ``ok`` snapshots equal, leaf
     checksum for leaf checksum, to the previous step's live parameters;
     the losses must be finite and fall; then the same for mamba2-780m
     for 12 steps (48 layers, 780,222,720 parameters; every layer of
     every step through ``ssd_scan`` by ``SSDScanFn``, forward and
     recompute, and through ``ssd_scan_bwd`` backward); and
     a supervisor drill at the reduced config (a failure injected at step
     3, checkpoints every 2 steps) must finish with the losses of an
     uninterrupted run;
  5. the eval and the structures: ``repro_torch.eval.run_eval`` runs the
     longread, rwmix and structrq workloads at their full variants on the
     card (every backend of each workload's default set): every row must
     see its invariant and make progress, and each run must launch its
     path's kernels (the MVStore backend's aborts are counted by cause);
     then each structure of ``repro_torch.structs`` at scale on
     multiverse (``AT_SCALE``: a 49,152-key hashmap serving whole-map
     size queries beside an updater that moves keys, 12,288-key trees
     serving 10,000-key range queries beside an updater that moves value
     within fixed key pairs; each prefilled on a CPU engine in a process
     spawned at the start of the run, its state carried to the card in
     one copy each of the heap, the lock row and the clock; 1 s windows),
     and one quiescent query of each under a
     profiler trace: one ``gather_bracketed`` launch and at most two
     device-to-host copies per traversal round, no copy or wait inside
     ``expand``/``advance``, and the round's host time split;
  6. the sharded store: the JAX package's seeded shard histories through
     ``make_tm("shardstore", n_shards=n)`` for n = 1, 2, 4 on the card
     and on the CPU must leave identical heaps, rings, clocks, epochs and
     counters, and shardstore(1) must equal mvstore on the card; a
     1,000,000-word store (spans of 8,192, every block versioned, 8-slot
     rings) at 1, 2 and 4 shards serves a whole-heap checker beside 2
     updaters on disjoint spans (one transfer in 16 across shards):
     violations 0, the epoch equal to the cross-shard commits, and one
     ``commit_fused`` launch per shard clock tick; eight blind writers
     publish through ``ShardedCommitBatcher`` as one launch and one tick
     (card against CPU); and ``run_eval("shardscale")`` at its full
     variants holds its 1-shard parity with no violation;
  7. the write-ahead log and crash recovery: every case of the JAX
     package's crash matrix (solo commits on multiverse, tl2, dctl and
     tinystm at six fault points, group commit buffered and encounter,
     the MVStore publish, the five cross-shard epoch cases) on the card
     and on the CPU must leave equal crash images, reports and recovered
     heaps, lock words, clocks, mirror rows, rings and ring timestamps; a
     seeded journal written on the card and on the CPU must give
     byte-identical segment files, each replaying on the other device;
     three children on the card kill themselves (SIGKILL) mid-commit and
     a fresh engine recovers the committed prefix from the log alone;
     ``durable_group_tl2_1M`` (phase 4's group trial journaled, two
     1.5 s windows around a checkpoint of the whole heap) and
     ``durable_mvstore_1M`` (1.5 s) replay into fresh stores on the card
     equal to the trials' final state, with one ``scatter_write`` (base
     image included) or ``commit_fused`` launch a record, and a
     ``post_scatter`` kill on the replayed store completes its install;
     and ``run_eval`` of ``reliability`` (in memory and durable) and
     ``durability`` at their full variants: violations 0, no failed
     invariant, every kill recovered and kills in the kill rows, every
     restart drill clean;
  8. the snapshot-serving service: the JAX package's three hand-driven
     schedules (a commit between decode steps in Mode U, Mode Q and
     ``live``) on the card and on the CPU must give the same pinned
     clocks, aborts and outcomes; ``run_eval("serving")`` at its full
     variants (qps60 / 28 ms commits, qps120 / 12 ms, 2.5 s, policies
     multiverse, modeq and unversioned) and ``service_36x1M`` (36 blocks
     of 1,048,576 int32 words, an 8-slot ring, qps60) in Mode U and Q:
     no torn read, drained, every offered request completed, shed or
     failed, no Mode-U abort; at qps120 Mode Q aborts and the unversioned
     policy mixes versions; every Mode-U resolve one ``snapshot_select``
     a block;
  9. the decoder families (``families_phase``), each at full width:
     moonshot-v1-16b-a3b (MoE, 64 experts, 6 a token) and paligemma-3b
     (256 seeded patch embeddings ahead of the tokens; ``flash_attention``
     at head dim 256 over one kv head) at a depth of 2, the same seeded
     weights on the card and on the CPU, held as phase 3 holds qwen2.5-3b,
     and for moonshot the same experts chosen at every layer, token and
     step; moonshot-v1-16b-a3b served at full depth (48 layers, 28.05 B
     parameters, bf16, Mode Q, drawn on the card in slices of at most
     1 GiB) as phase 4 serves qwen2.5-3b (every request completes, every
     prefill runs ``flash_attention`` once a layer) and its Mode-Q commit
     check; jamba-v0.1-52b served at one interleave period (8 of 32
     layers: one attention layer through ``flash_attention``, seven Mamba
     layers through ``ssd_scan`` at 128 heads of 64, d_state 16), its idle
     share traced on the same server; llama4-scout-17b-a16e (4 of 48
     layers) and deepseek-7b, minitron-4b and mistral-large-123b (2
     layers each) one prefill of 4 x 512 tokens and 4 decode steps each:
     finite logits and one ``flash_attention`` launch per attention layer;
     then the encoder-decoder family (``seamless_phase``, 9b):
     seamless-m4t-medium at 2 encoder and 2 decoder layers over 2 x 256
     seeded frame embeddings, held as phase 3 holds qwen2.5-3b (each card
     prefill one ``flash_attention`` an encoder layer, two a decoder
     layer); served at full width and depth (977,860,608 parameters,
     bf16) from Mode-U snapshots through ``make_prefill_step`` /
     ``make_decode_step`` (4 x 4096 bf16 frame embeddings, 4 x 512
     tokens, 32 greedy steps: every step ``ok``, the live parameters'
     tokens, 36 ``flash_attention`` launches a prefill, one
     ``snapshot_select`` a block a step; its idle share traced); and
     trained by ``Trainer`` for 10 Mode-U fused steps beside the data
     pipeline's float32 frames (the encoder in float32), gated as phase
     4's trainers; then the
     family trainers (``family_training_phase``, 9c): paligemma-3b and
     moonshot-v1-16b-a3b card = CPU at their reduced configs in float32
     (losses, parameters and moments within 1e-4; the counted steps
     the CPU's to the flop and the byte), then each trained at full
     width (paligemma-3b whole, 3,035,703,296 parameters; moonshot at 6
     of 48 layers, 4,094,453,760) for 10 and 20 Mode-U fused steps of
     4 x 512 positions, gated as phase 4's trainers.  Every trainer's and every
     full-width server's last step is counted (one train step, one
     decode step of the 4 slots): ``model_flops``, the counted flops and
     bytes, ``mfu`` and ``roofline_terms`` go to
     ``build/roofline.jsonl``, and their table is printed;
 10. the card's idle share: four of the trials run again under a profiler
     trace of their GPU activity for ``TRACE_S`` (1 s; each server,
     qwen2.5-3b's, mamba2-780m's and jamba-v0.1-52b's, is traced as long
     after its serving trial's counted requests, and each trainer for
     one step while it is still up);
 11. the sharding layer (``sharding_phase``): (a) qwen2.5-3b at full
     width, depth 2, float32, Mode U fused, on a real one-rank ``nccl``
     group and a (1, 1) ``"cuda"`` mesh with the default rules —
     ``reshard_state`` copies a plain state onto the mesh, and 3 sharded
     steps (each followed by a one-behind ``mv_snapshot``) must equal 3
     plain ones within 1e-4 (losses, parameters, moments), with the same
     ``flash_attention``, ``fused_adamw`` and ``snapshot_select``
     launches and no collective (``CommDebugMode``); (b) the fake-rank
     dry run of ``train_trial``'s own qwen2.5-3b step (a process spawned
     at the start, ``DryRuns``) must count that trainer's counted step's
     flops and bytes integer for integer, and its per-rank peak must lie
     within 10 % of the trainer's ``max_memory_allocated``; (c)
     qwen2.5-3b ``train_4k`` and moonshot-v1-16b-a3b ``decode_32k`` on
     the fake 16x16 pod must trace ``ok`` (per-rank peak, collectives by
     kind and trace seconds printed);
 12. the drivers (``drivers_phase``, run after 9c and before 10), each
     called as a user calls it, through its ``main``, in this process:
     ``repro_torch.examples.quickstart`` on every backend of
     ``backend_names()`` (no torn read, all five audits committed on
     every backend within ``QUICKSTART_SECONDS``, each backend's kernels
     launched); ``bakeoff --quick``, every
     assertion of the reference holding as written (its five speed
     factors printed beside their bars); ``serve_snapshots --steps 30
     --requests 6`` (every request completes, its served clocks never
     decrease and lie within the trainer's, ``snapshot_select`` and
     ``flash_attention`` launched); ``train_lm --full`` over qwen2.5-3b
     at full width, Mode Q, ``TRAIN_LM_FULL_STEPS`` steps (finite losses,
     no checkpoint, 2 x 36 ``flash_attention`` launches a step); and
     ``train_lm --arch mamba2-780m --steps 50 --inject-failure-at 30``
     (one restart from the step-20 checkpoint, the replayed steps' losses
     equal to the first pass's bit for bit, ``ssd_scan`` launched).

The last two lines are the kernels summary and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import json
import os
import random
import shutil
import subprocess
import sys
import threading
import time
import warnings
from collections import defaultdict
from itertools import chain

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

SEED = 0
#: the card phase 7 compares against the CPU (a CPU rehearsal sets "cpu")
CARD = "cuda"
INITIAL = 100                  # per-word prefill (eval/workloads.py)
AMOUNT = 5

#: kernel -> (CUDA source, TPU kernel it replaces, main-path shape timed)
KERNELS = {
    "gather_read": ("src/repro_torch/csrc/gather_read.cu",
                    "src/repro/kernels/gather_read.py:58", 256),
    # a bulk read's pre/heap/post gathers in one launch (the second
    # kernel of gather_read.cu; three gather_read_flat calls on the TPU)
    "gather_bracketed": ("src/repro_torch/csrc/gather_read.cu",
                         "src/repro/kernels/gather_read.py:58", 256),
    "scatter_write": ("src/repro_torch/csrc/scatter_write.cu",
                      "src/repro/kernels/scatter_write.py:75", 1024),
    "validate": ("src/repro_torch/csrc/validate.cu",
                 "src/repro/kernels/validate.py:74", 1024),
    "version_select": ("src/repro_torch/csrc/version_select.cu",
                       "src/repro/kernels/version_select.py:62", 256),
    # a versioned bulk read's mirror resolve in one launch (the second
    # kernel of version_select.cu; the reference's PackedVLT.select, whose
    # selection is version_select_flat on the TPU)
    "mirror_select": ("src/repro_torch/csrc/version_select.cu",
                      "src/repro/kernels/version_select.py:62", 256),
    "commit_fused": ("src/repro_torch/csrc/commit_fused.cu",
                     "src/repro/kernels/commit_fused.py:238", "group"),
    "snapshot_select": ("src/repro_torch/csrc/snapshot_select.cu",
                        "src/repro/kernels/snapshot_select.py:49",
                        1_000_000),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:92",
                        "qwen_prefill_512"),
    "fused_adamw": ("src/repro_torch/csrc/fused_adamw.cu",
                    "src/repro/kernels/fused_adamw.py:70", "ffn_leaf"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:77", "mamba_prefill_512"),
    # the scan's gradient: no TPU kernel (the reference differentiates
    # its XLA lowering), timed at train_U's shape
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu", "none",
                     "mamba_train_4x2048"),
}
BACKENDS = ("multiverse", "tl2", "dctl", "norec", "tinystm", "mvstore")
#: the backends whose bulk reads take the lock-version bracket
LOCKVER_BACKENDS = ("multiverse", "tl2", "dctl", "tinystm")
#: each kernel's __global__ functions, as named in a profiler trace
DEVICE_KERNELS = {
    "gather_read": ("gather_read_kernel",),
    "gather_bracketed": ("gather_bracketed_kernel",),
    "scatter_write": ("scatter_write_kernel", "scatter_pairs_kernel"),
    "validate": ("validate_kernel", "validate_words_kernel"),
    "version_select": ("version_select_kernel", "mirror_select_kernel"),
    "mirror_select": ("mirror_select_kernel",),
    "commit_fused": ("decide_kernel", "publish_kernel",
                     "publish_rows_kernel"),
    "snapshot_select": ("snapshot_select_kernel",),
    "flash_attention": ("flash_attention_kernel",),
    "fused_adamw": ("fused_adamw_kernel",),
    "ssd_scan": ("ssd_scan_kernel",),
    "ssd_scan_bwd": ("ssd_bwd_",),
}
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_DIR = os.path.join(HERE, "build", "traces")
#: the idle-share traces' window: each server after its counted requests
#: and the four phase-10 trials
TRACE_S = 1.0


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# phase 1: the build
# ---------------------------------------------------------------------------


#: the tensor-core kernels the build must give HMMA and no spills:
#: (source, kernel template) -> its int template arguments
MMA_KERNELS = {
    ("flash_attention.cu", "flash_attention_kernel_mma"): (64, 128, 256),
    ("ssd_scan.cu", "ssd_scan_kernel_cb_mma"): (64, 128),
    ("ssd_scan.cu", "ssd_scan_kernel_state_mma"): (64, 128),
    ("ssd_scan.cu", "ssd_scan_kernel_out_mma"): (64, 128),
    ("ssd_scan_bwd.cu", "ssd_bwd_dstate_mma"): (64, 128),
    ("ssd_scan_bwd.cu", "ssd_bwd_dx_mma"): (64, 128),
    ("ssd_scan_bwd.cu", "ssd_bwd_dbc_mma"): (64, 128),
}


def mma_build_check():
    """What the compiler made of the tensor-core kernels: each
    instantiation in ``MMA_KERNELS`` must spill nothing (``ptxas -v`` in
    the build's log) and must run its products as ``HMMA`` (``cuobjdump
    -sass`` of the library).  Returns {kernel<arg>: {registers, spill
    bytes, HMMA count}}."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import _lib

    def which(mangled):
        """``kernel<arg>`` of a mangled instantiation in MMA_KERNELS."""
        for _, name in MMA_KERNELS:
            m = re.search(name + r"ILi(\d+)E", mangled)
            if m:
                return f"{name}<{m.group(1)}>"
        return None

    info = {}
    for src in sorted({src for src, _ in MMA_KERNELS}):
        entry = None
        for line in _lib.build_log(src).read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = which(m.group(1))
                continue
            if entry is None:
                continue
            row = info.setdefault(entry, {"spill_bytes": 0})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                row["spill_bytes"] += int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                row["registers"] = int(m.group(1))
    sass = subprocess.run(
        [os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump"),
         "-sass", str(_lib.library_path())], capture_output=True, text=True,
        timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-500:]}")
    fn = None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = which(m.group(1))
            if fn is not None:
                info.setdefault(fn, {}).setdefault("hmma", 0)
        elif fn is not None and "HMMA" in line:
            info[fn]["hmma"] += 1
    for (_, name), args in MMA_KERNELS.items():
        for a in args:
            row = info.get(f"{name}<{a}>", {})
            check(row.get("spill_bytes") == 0 and "registers" in row,
                  f"{name}<{a}>: ptxas reports {row}")
            check(row.get("hmma", 0) > 0,
                  f"{name}<{a}> has no HMMA instruction")
    return info


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters=200, warm=20):
    """Mean device time of one call of ``fn`` over ``iters`` warmed calls
    (CUDA events around the whole run)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def gpu_events(prof):
    """The GPU activities (kernels, copies, memsets) of a finished
    ``torch.profiler`` run, as chrome-trace events."""
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("cat") in GPU_CATS and "dur" in e]


def gpu_activity(prof, kernels=()):
    """``(events, busy_us, kernels_us)`` of a finished ``torch.profiler``
    run: how many GPU activities (kernels, copies, memsets) its trace
    holds, their summed duration, and the summed duration of the kernels
    whose names contain one of ``kernels``.  On one stream the activities
    do not overlap, so the sum is the time the card was busy."""
    gpu = gpu_events(prof)
    return len(gpu), sum(e["dur"] for e in gpu), kernel_us(gpu, kernels)


def kernel_us(gpu, kernels):
    """Summed duration of the kernels among the activities ``gpu`` whose
    names contain one of ``kernels``."""
    return sum(e["dur"] for e in gpu if e["cat"] == "kernel"
               and any(k in e["name"] for k in kernels))


def device_times(torch, fn, kernels, iters=50, warm=5):
    """Per-call device time of ``fn`` from a profiler trace of ``iters``
    warmed calls: ``kernel_device_ms`` (the named CUDA kernels alone) and
    ``device_busy_ms`` (every GPU activity the call enqueued, copies and
    memsets included).  A trace that holds no GPU activity at all (one
    of the bracketed gather's traces held none in one run) is taken again,
    up to three times (``trace_attempts``); both None if all were
    empty."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n, busy, named = gpu_activity(prof, kernels)
        if n:
            return {"kernel_device_ms": named / iters / 1e3,
                    "device_busy_ms": busy / iters / 1e3,
                    "trace_attempts": attempt}
    return {"kernel_device_ms": None, "device_busy_ms": None,
            "trace_attempts": attempt}


def kernel_row(torch, name, fn, iters=200, **rest):
    """A timing row for kernel ``name``'s wrapper call ``fn``: ``ms`` from
    CUDA events over ``iters`` calls (host launch path included) and the
    device times from a profiler trace, beside the ``rest`` of the row."""
    return dict(ms=time_ms(torch, fn, iters=iters, warm=max(1, iters // 10)),
                **device_times(torch, fn, DEVICE_KERNELS[name],
                               iters=min(50, iters)), **rest)


def equal(torch, a, b):
    return a.shape == b.shape and bool(torch.equal(a, b))


def kernel_checks(torch, dev, rng):
    """Bit-for-bit kernel vs plain checks at every listed shape; returns
    {kernel: {N: timing row}} for the timed shapes."""
    from repro_torch.kernels import gather_read as GR
    from repro_torch.kernels import validate as VK
    from repro_torch.kernels import version_select as VS
    from repro_torch.kernels._lib import read_word, to_device
    from repro_torch.launch.roofline import HBM_BW

    t_start = time.perf_counter()
    big = 1 << 62
    H = 1_000_000
    rows = {}

    def bound(nbytes):
        return nbytes / HBM_BW * 1e3

    # gather_read / scatter_write over a 1,000,000-word row
    row_np = rng.integers(-big, big, H, dtype=np.int64)
    row = to_device(row_np, dev)
    for n in (1, 255, 256, 4096, 1_000_000):
        idx = rng.integers(0, H, n, dtype=np.int64)
        got = GR.gather_read(row, idx)
        idx_t = to_device(idx, dev)
        check(equal(torch, got, GR.gather_plain(row, idx_t)),
              f"gather_read != plain at N={n}")
        check(np.array_equal(got.cpu().numpy(), row_np[idx]),
              f"gather_read != host row at N={n}")
        if n in (256, 1_000_000):
            rows.setdefault("gather_read", {})[n] = kernel_row(
                torch, "gather_read", lambda: GR.gather_read_dev(row, idx_t),
                plain_ms=time_ms(torch,
                                 lambda: GR.gather_plain(row, idx_t)),
                library_ms=time_ms(
                    torch, lambda: torch.index_select(row, 0, idx_t)),
                bound_ms=bound(24 * n))
    rows.update(scatter_checks(torch, dev, rng, row, row_np, bound))
    # the gather brought home in one call (NOrec's value validation) and
    # the scalar word read (every scalar STM read on the card)
    now_np = row.cpu().numpy()
    for n in (1, 2, 200, 4096):
        idx = rng.integers(0, H, n, dtype=np.int64)
        got = GR.gather_read_home(row, idx)
        check(np.array_equal(got, GR.gather_plain(
            row, to_device(idx, dev)).cpu().numpy()),
            f"gather_read_home != plain at N={n}")
    for r, r_np in ((row, now_np), (row[7:], now_np[7:])):
        for i in (0, 1, 4097, r_np.size - 1):
            check(read_word(r, i) == int(r[i]) == int(r_np[i]),
                  f"read_word != row at {i}")

    # gather_read over an int32 row (the MVStore block and ring rows)
    row32_np = rng.integers(-(1 << 31), 1 << 31, H, dtype=np.int64) \
        .astype(np.int32)
    row32 = torch.from_numpy(row32_np).to(dev)
    for n in (1, 255, 4096, 1_000_000):
        idx = rng.integers(0, H, n, dtype=np.int64)
        got = GR.gather_read(row32, idx)
        check(got.dtype == torch.int32 and equal(
            torch, got, GR.gather_plain(row32, to_device(idx, dev))),
            f"gather_read int32 != plain at N={n}")
        check(np.array_equal(got.cpu().numpy(), row32_np[idx]),
              f"gather_read int32 != host row at N={n}")
    for i in (0, 4097, H - 1):
        check(read_word(row32, i) == int(row32_np[i]),
              f"read_word int32 != row at {i}")

    rows.update(bracketed_checks(torch, dev, rng, row, row_np, bound))

    # validate: all three modes, versions near 2^40
    base = 1 << 40
    for n in (256, 1024, 1_000_000):
        ver = base + rng.integers(-50, 50, n, dtype=np.int64)
        seen = ver + rng.integers(-1, 2, n, dtype=np.int64) * \
            (rng.random(n) < 0.01)
        own = rng.integers(-2, 4, n).astype(np.int32)
        meta = (rng.random(n) < 0.01).astype(np.int32) \
            | ((rng.random(n) < 0.01).astype(np.int32) << 1)
        args = [to_device(ver, dev), torch.from_numpy(own).to(dev),
                torch.from_numpy(meta).to(dev)]
        seen_t = to_device(seen, dev)
        for mode in (0, 1, 2):
            for r_clock, tid in ((base + 60, 1), (base, 0), (base - 60, -1)):
                mask, all_ok = VK.validate_mask(*args, seen_t, r_clock, tid,
                                                mode)
                want = VK.validate_plain(*args, seen_t, r_clock, tid, mode)
                check(equal(torch, mask, want),
                      f"validate mask != plain N={n} mode={mode}")
                check(bool(all_ok) == bool(want.all()),
                      f"validate flag != plain N={n} mode={mode}")
        # an all-valid read set, so the flag's true path is exercised
        clean = [args[0], args[1], torch.zeros_like(args[2])]
        mask, all_ok = VK.validate_mask(*clean, seen_t, base + 60, 0, 0)
        check(bool(all_ok) and bool(mask.all()),
              f"validate all-valid set failed at N={n}")
        if n in (1024, 1_000_000):
            rows.setdefault("validate", {})[f"mask_{n}"] = kernel_row(
                torch, "validate", lambda: VK.validate_mask(
                    *args, seen_t, base, 1, 0),
                plain_ms=time_ms(torch, lambda: VK.validate_plain(
                    *args, seen_t, base, 1, 0).all()),
                library_ms=None,
                bound_ms=bound(28 * n + 4))
    rows["validate"].update(validate_words_checks(torch, dev, rng, bound))

    # version_select: depth 4, empty / all-valid / no-valid rows
    empty = 1 << 62
    for n in (1, 256, 65_536):
        ts = base + rng.integers(-8, 8, (n, 4), dtype=np.int64)
        ts[rng.random((n, 4)) < 0.2] = empty
        kind = rng.integers(0, 4, n)
        ts[kind == 1] = empty                       # empty rows
        ts[kind == 2] = base - 100                  # every slot valid
        ts[kind == 3] = base + 100                  # no slot valid
        data = rng.integers(-big, big, (n, 4), dtype=np.int64)
        ts_t, data_t = to_device(ts, dev), to_device(data, dev)
        for r_clock in (base, base - 7, base + 9):
            v, ok = VS.version_select(ts_t, data_t, r_clock)
            pv, pok = VS.version_select_plain(ts_t, data_t, r_clock)
            check(equal(torch, v, pv) and equal(torch, ok, pok),
                  f"version_select != plain at N={n}")
        if n in (256, 65_536):
            rows.setdefault("version_select", {})[n] = kernel_row(
                torch, "version_select",
                lambda: VS.version_select(ts_t, data_t, base),
                plain_ms=time_ms(torch, lambda: VS.version_select_plain(
                    ts_t, data_t, base)),
                library_ms=None,
                bound_ms=bound((2 * 8 * 4 + 12) * n))
    split = {"integer_kernels": time.perf_counter() - t_start}

    def timed(name, fn, *args):
        t1 = time.perf_counter()
        out = fn(torch, dev, *args)
        split[name] = time.perf_counter() - t1
        return out

    rows.update(timed("mirror_select", mirror_select_checks, rng, bound))
    rows.update(timed("host_paths", host_path_checks, rng, row))
    rows.update(timed("commit_fused", commit_fused_checks, rng, bound))
    rows.update(timed("snapshot_select", snapshot_select_checks, rng,
                      bound))
    rows.update(timed("flash_attention", flash_checks))
    rows.update(timed("fused_adamw", adamw_checks))
    rows.update(timed("ssd_scan", ssd_checks))
    timed("ssd_grad", ssd_grad_checks)
    rows.update(timed("ssd_scan_bwd", ssd_bwd_checks))
    timed("attention_grad", attention_grad_checks)
    emit({"kernel_checks_split_seconds": split})
    return rows


def _lock_set(rng, n, base, n_words, fail=0.01):
    """A packed lock row of ``n_words`` words and a read set of ``n``
    (lock index, seen version) pairs over it: versions near ``base``,
    owners -2..5, a ``fail`` share of entries locked, flagged or seen at
    another version."""
    ver = base + rng.integers(-50, 50, n_words, dtype=np.int64)
    own = rng.integers(-2, 6, n_words)
    meta = (rng.random(n_words) < fail).astype(np.int64) \
        | ((rng.random(n_words) < fail).astype(np.int64) << 1)
    idx = rng.integers(0, n_words, n, dtype=np.int64)
    seen = ver[idx] + rng.integers(-1, 2, n) * (rng.random(n) < fail)
    return _words(ver, own, meta), np.stack((idx, seen), axis=1)


def validate_words_checks(torch, dev, rng, bound):
    """validate_words against its plain version (``validate_plain`` over
    the plain split of the gathered words), bit for bit, verdict and mask,
    at N = 256 and 1024 (pairs in the launch's parameters), 4096 and
    1,000,000 (one staged copy; one CTA, then a grid), in all three modes,
    with versions and clocks inside int32 and beyond it, and on all-valid
    sets; then a bulk revalidation at N = 1024 split into its parts and
    timed in turns beside the path it replaces (a ``gather_read`` launch
    and the ``validate`` kernel over the split fields).  Returns the timing
    rows {N: row}."""
    from repro_torch.kernels import validate as VK
    from repro_torch.kernels._lib import to_device

    cases = 0
    for n in (256, 1024, 4096, 1_000_000):
        n_words = 1 << 16 if n <= 4096 else 1 << 20
        for base in (1000, 1 << 40):
            words_np, entries = _lock_set(rng, n, base, n_words)
            words = to_device(words_np, dev)
            # the same indices, every entry seen at its word's version
            exact = entries.copy()
            exact[:, 1] = words_np[exact[:, 0]] >> 18
            sets = ((entries, to_device(entries, dev)),
                    (exact, to_device(exact, dev)))
            for mode in (0, 1, 2):
                for r_clock, tid in ((base + 60, 1), (base, 0),
                                     (base - 60, -1)):
                    for e, e_t in sets:
                        ok, mask = VK.validate_words(words, e, r_clock, tid,
                                                     mode, want_mask=True)
                        want = VK.validate_words_plain(words, e_t, r_clock,
                                                       tid, mode)
                        check(equal(torch, mask, want)
                              and bool(ok) == bool(want.all()),
                              f"validate_words != plain N={n} "
                              f"base={base} mode={mode} r_clock={r_clock}")
                        ok2, none = VK.validate_words(words, e, r_clock,
                                                      tid, mode)
                        check(none is None and bool(ok2) == bool(ok),
                              f"validate_words verdict without the mask "
                              f"differs N={n} mode={mode}")
                        cases += 1
            # an all-valid set (no lock held, seen = version): true
            free = _words(words_np >> 18, np.full(n_words, -1),
                          np.zeros(n_words))
            ok, _ = VK.validate_words(to_device(free, dev), exact,
                                      base + 60, 0, 0)
            check(bool(ok), f"validate_words all-valid set failed N={n}")
    emit({"kernel_check": "validate_words", "cases": cases,
          "bit_identical": True})

    rows = {}
    for n in (1024, 1_000_000):
        words_np, entries = _lock_set(rng, n, 1 << 40, 1 << 16 if n <= 4096
                                      else 1 << 20)
        words = to_device(words_np, dev)
        ent_t = to_device(entries, dev)
        rows[n] = kernel_row(
            torch, "validate", lambda: VK.validate_words(
                words, entries, 1 << 40, 1, 0),
            plain_ms=time_ms(torch, lambda: VK.validate_words_plain(
                words, ent_t, 1 << 40, 1, 0).all()),
            library_ms=None, shape=f"N={n} read-set pairs, "
            f"{words.numel()}-word lock row, verdict only",
            # pairs and words read, the verdict written
            bound_ms=bound(24 * n + 1))
    rows.update(revalidation_split(torch, dev, rng))
    return rows


def revalidation_split(torch, dev, rng, n=1024, calls=1000):
    """One commit's bulk revalidation at N = 1024 on a 2^16-word lock
    table on the card (all entries valid: the verdict a commit mostly
    gets), from the read-set list to the Python bool: the path this
    replaced (two index columns, ``ArrayLockTable.gather`` — the index
    copy, one ``gather_read``, the field split and casts — then
    ``validate_readset``: the seen copy, two allocations, the memset and
    kernel, the flag op and the read-back) and the ``validate_words``
    path, each split into its parts (ns a call), then both timed in 15
    paired turns of 100 calls, beside the wrapper alone."""
    from repro_torch.core.engine import arrayheap as AH
    from repro_torch.core.engine import validation as V
    from repro_torch.kernels import _lib
    from repro_torch.kernels import gather_read as GR
    from repro_torch.kernels import validate as VK

    locks = AH.ArrayLockTable(16, device=dev)
    words_np, entries = _lock_set(rng, n, 1 << 40, locks.size, fail=0)
    locks.row.copy_(_lib.to_device(words_np, dev))
    entries[:, 1] = words_np[entries[:, 0]] >> 18
    read_set = [tuple(e) for e in entries.tolist()]
    r_clock, tid, mode = (1 << 40) + 60, 0, V.V_LE
    row = locks.row

    def previous_path():
        idxs = np.fromiter((e[0] for e in read_set), np.int64, n)
        seen = np.fromiter((e[1] for e in read_set), np.int64, n)
        ver, own, meta = locks.gather(idxs)
        return VK.validate_readset(ver, own, meta, seen, r_clock, tid, mode)

    def new_path():
        return V.revalidate_bulk(locks, read_set, r_clock, tid, mode)

    check(previous_path() is True and new_path() is True,
          "revalidation of an all-valid read set failed")
    idxs, seen = entries[:, 0].copy(), entries[:, 1].copy()
    idx_t = _lib.to_device(idxs, dev)
    w = GR.gather_read_dev(row, idx_t)
    ver, own, meta = locks.gather(idxs)
    seen_t = _lib.to_device(seen, dev)
    mask = torch.empty(n, dtype=torch.int32, device=dev)
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    flag_t = flag[0] != 0
    ok = _lib.fresh_ok(dev)
    parts = {
        "previous.columns": lambda: (
            np.fromiter((e[0] for e in read_set), np.int64, n),
            np.fromiter((e[1] for e in read_set), np.int64, n)),
        "previous.index_copy": lambda: _lib.to_device(idxs, dev),
        "previous.gather_read": lambda: GR.gather_read_dev(row, idx_t),
        "previous.split_and_casts": lambda: [
            t.to(torch.int32) for t in AH._split(w)[1:]],
        "previous.seen_copy": lambda: _lib.to_device(seen, dev),
        "previous.allocations": lambda: (
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(1, dtype=torch.int32, device=dev)),
        "previous.memset_and_launch": lambda: _lib.launch(
            "validate_readset_i64", dev, ver.data_ptr(), own.data_ptr(),
            meta.data_ptr(), seen_t.data_ptr(), n, r_clock, tid, mode,
            mask.data_ptr(), flag.data_ptr()),
        "previous.flag_op": lambda: flag[0] != 0,
        "previous.read_back": lambda: bool(flag_t),
        "previous.whole": previous_path,
        "new.columns": lambda: np.fromiter(
            chain.from_iterable(read_set), np.int64, 2 * n).reshape(-1, 2),
        "new.checks": lambda: (
            _lib.check_row(row), _lib.check_addr_bounds(
                np.ascontiguousarray(entries, np.int64)[:, 0], row.numel())),
        "new.ok_from_block": lambda: _lib.fresh_ok(dev),
        "new.c_call": lambda: _lib.launch(
            "validate_words_i64", dev, row.data_ptr(), row.numel(),
            entries.ctypes.data, None, None, None, n, r_clock, tid, mode,
            None, ok.data_ptr()),
        "new.wrapper": lambda: VK.validate_words(row, entries, r_clock, tid,
                                                 mode),
        "new.read_back": lambda: bool(ok),
        "new.whole": new_path,
    }
    emit({"host_split": "bulk_revalidation",
          "shape": f"N={n}, 2^16 lock words, mode V_LE, all valid",
          "ns_per_call": run_split(torch, parts, calls)})
    runs = in_turns(torch, {"new": new_path, "previous": previous_path,
                            "wrapper": lambda: VK.validate_words(
                                row, entries, r_clock, tid, mode)})
    ratios = [a / b for a, b in zip(runs["new"], runs["previous"])]
    return {"revalidation_1024": dict(
        ms=float(np.median(runs["new"])), ms_runs=runs["new"],
        previous_ms=float(np.median(runs["previous"])),
        previous_ms_runs=runs["previous"],
        paired_ratio_to_previous=float(np.median(ratios)),
        wrapper_ms=float(np.median(runs["wrapper"])),
        wrapper_ms_runs=runs["wrapper"],
        shape=f"N={n} read set (list of pairs) to a Python bool, "
              "2^16-word lock row on the card")}


def in_turns(torch, fns, turns=15, iters=100):
    """Host-bound calls timed in turns: ``turns`` runs of ``iters`` calls
    of each of ``fns`` (name -> fn), the order reversed every other turn
    (ABBA), since the host's speed drifts between levels within a run.
    Returns {name: [ms per call, one per turn]}."""
    runs = {k: [] for k in fns}
    order = list(fns)
    for i in range(turns):
        for k in (order if i % 2 == 0 else order[::-1]):
            runs[k].append(time_ms(torch, fns[k], iters=iters, warm=10))
    return runs


def bracketed_checks(torch, dev, rng, heap, heap_np, bound):
    """gather_bracketed against its plain version (the three gathers in
    order) and against the host rows, bit for bit, over a 2^16-word lock
    row and the 1,000,000-word heap, with the indices in the launch's
    parameters (N <= 256) and on the card (longer); then timed at the
    scan chunk (N=256) in turns beside the three-call path it replaces
    (the earlier ``gather_lockver``: one index copy, three ``gather_read``
    calls) and three ``index_select`` calls."""
    from repro_torch.kernels import gather_read as GR
    from repro_torch.kernels._lib import to_device

    words_np = rng.integers(-(1 << 62), 1 << 62, 1 << 16, dtype=np.int64)
    words = to_device(words_np, dev)
    H = heap.numel()
    for n in (1, 255, 256, 4096, 100_000):
        idxs = rng.integers(0, words.numel(), n, dtype=np.int64)
        addrs = rng.integers(0, H, n, dtype=np.int64)
        out = GR.gather_bracketed(words, heap, idxs, addrs)
        idx_dev = out[3]
        want = GR.gather_lockver_plain(words, heap, to_device(idxs, dev),
                                       to_device(addrs, dev))
        check(equal(torch, out, want), f"gather_bracketed != plain at N={n}")
        host = out.cpu().numpy()
        check(np.array_equal(host[0], words_np[idxs])
              and np.array_equal(host[1], words_np[idxs])
              and np.array_equal(host[2], heap_np[addrs])
              and np.array_equal(idx_dev.cpu().numpy(), idxs),
              f"gather_bracketed != host rows at N={n}")
    emit({"kernel_check": "gather_bracketed", "cases": 5,
          "bit_identical": True})
    n = 256
    idxs = rng.integers(0, words.numel(), n, dtype=np.int64)
    addrs = rng.integers(0, H, n, dtype=np.int64)
    i_t, a_t = to_device(idxs, dev), to_device(addrs, dev)

    def three_calls():
        both = to_device(np.concatenate((idxs, addrs)), dev)
        w = torch.empty((2, n), dtype=torch.int64, device=dev)
        GR.gather_read(words, idxs, both[:n], out=w[0])
        vals = GR.gather_read(heap, addrs, both[n:])
        GR.gather_read(words, idxs, both[:n], out=w[1])
        return w, vals

    def index_selects():
        return (torch.index_select(words, 0, i_t),
                torch.index_select(heap, 0, a_t),
                torch.index_select(words, 0, i_t))

    def bracketed():
        return GR.gather_bracketed(words, heap, idxs, addrs)
    emit({"host_split": "gather_bracketed",
          "shape": f"N={n}, 2^16 lock words, {H}-word heap",
          "ns_per_call": gather_bracketed_host_split(
              torch, dev, words, heap, idxs, addrs)})
    runs = in_turns(torch, {"bracketed": bracketed,
                            "three_calls": three_calls,
                            "index_selects": index_selects})
    ratios = [a / b for a, b in zip(runs["bracketed"], runs["three_calls"])]
    return {"gather_bracketed": {n: dict(
        ms=float(np.median(runs["bracketed"])), ms_runs=runs["bracketed"],
        three_call_ms=float(np.median(runs["three_calls"])),
        three_call_ms_runs=runs["three_calls"],
        paired_ratio_to_three_calls=float(np.median(ratios)),
        **device_times(torch, bracketed, DEVICE_KERNELS["gather_bracketed"]),
        shape=f"N={n}, 2^16 lock words, {H}-word heap, int64",
        plain_ms=time_ms(torch, lambda: GR.gather_lockver_plain(
            words, heap, i_t, a_t)),
        library_ms=float(np.median(runs["index_selects"])),
        library_ms_runs=runs["index_selects"],
        library="three torch.index_select calls (indices on the card)",
        # two indices read, three words read and four written (the lock
        # indices come out as row 3)
        bound_ms=bound(56 * n))}}


def scatter_checks(torch, dev, rng, row, row_np, bound):
    """scatter_write bit for bit against its plain version on the card and
    a numpy scatter: from host columns (numpy, and a list up to 65,536)
    at N = 1, 1023 and 1024 (pairs in the launch's parameters) and 1025,
    65,536 and 1,000,000 (one staged copy), from columns on the card
    (``scatter_write_dev``), the fill form (up to 2048 indices in the
    parameters, then staged) and a repeated index with an equal value
    on both routes; then timed.  Returns {"scatter_write": rows}."""
    from repro_torch.kernels import scatter_write as SW
    from repro_torch.kernels._lib import to_device

    big = 1 << 62
    H = row.numel()
    cases = 0

    def agree(a, b, want, what):
        nonlocal cases
        check(equal(torch, a, b), f"scatter_write != plain: {what}")
        check(np.array_equal(a.cpu().numpy(), want),
              f"scatter_write != numpy scatter: {what}")
        cases += 1

    for n in (1, 1023, 1024, 1025, 65_536, 1_000_000):
        idx = rng.permutation(H)[:n].astype(np.int64)
        vals = rng.integers(-big, big, n, dtype=np.int64)
        idx_t, val_t = to_device(idx, dev), to_device(vals, dev)
        want = row_np.copy()
        want[idx] = vals
        b = row.clone()
        SW.scatter_plain(b, idx_t, val_t)
        for how, values in (("numpy", vals), ("card", val_t),
                            ("list", vals.tolist() if n <= 65_536
                             else None)):
            if values is not None:
                a = row.clone()
                SW.scatter_write(a, idx, values)
                agree(a, b, want, f"{how} columns at N={n}")
    for n in (1, 2048, 2049, 65_536):
        idx = rng.integers(0, H, n, dtype=np.int64)   # repeats allowed
        word = int(rng.integers(-big, big))
        a, b = row.clone(), row.clone()
        SW.scatter_fill(a, idx, word)
        SW.scatter_fill_plain(b, to_device(idx, dev), word)
        want = row_np.copy()
        want[idx] = word
        agree(a, b, want, f"fill at N={n}")
    for n in (1024, 4096):
        u = rng.permutation(H)[:n - 1].astype(np.int64)
        vals = rng.integers(-big, big, n - 1, dtype=np.int64)
        idx, vals = np.append(u, u[0]), np.append(vals, vals[0])
        a, b = row.clone(), row.clone()
        SW.scatter_write(a, idx, vals)
        SW.scatter_plain(b, to_device(idx, dev), to_device(vals, dev))
        want = row_np.copy()
        want[idx] = vals
        agree(a, b, want, f"a repeated index at N={n}")
    emit({"kernel_check": "scatter_write", "cases": cases,
          "bit_identical": True})

    out = {}
    for n in (1024, 1_000_000):
        idx = rng.permutation(H)[:n].astype(np.int64)
        vals = rng.integers(-big, big, n, dtype=np.int64)
        idx_t, val_t = to_device(idx, dev), to_device(vals, dev)
        a, b, c = row.clone(), row.clone(), row.clone()
        plain_ms = time_ms(torch, lambda: SW.scatter_plain(b, idx_t, val_t))
        library_ms = time_ms(torch, lambda: c.index_copy_(0, idx_t, val_t))
        route = "parameters" if n <= SW.PARAM_PAIRS else "one staged copy"
        out[n] = kernel_row(
            torch, "scatter_write", lambda: SW.scatter_write(a, idx, vals),
            iters=200 if n <= 4096 else 50, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound(24 * n),
            shape=f"N={n} host columns (numpy) into a {H}-word int64 "
                  f"row, {route}")
        out[f"dev_{n}"] = kernel_row(
            torch, "scatter_write",
            lambda: SW.scatter_write_dev(a, idx_t, val_t),
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound(24 * n),
            shape=f"N={n} columns on the card (scatter_write_dev)")
    n = 1024
    idx = rng.integers(0, H, n, dtype=np.int64)
    a, c = row.clone(), row.clone()
    idx_t = to_device(idx, dev)
    out[f"fill_{n}"] = kernel_row(
        torch, "scatter_write", lambda: SW.scatter_fill(a, idx, 12345),
        plain_ms=time_ms(torch, lambda: SW.scatter_fill_plain(
            c, idx_t, 12345)),
        library_ms=time_ms(torch, lambda: c.index_fill_(0, idx_t, 12345)),
        bound_ms=bound(16 * n), shape=f"N={n} host indices, fill form")
    return {"scatter_write": out}


def _mirror_state(rng, size, base, ways=2, depth=4):
    """A seeded mirror (``PackedVLT.arrays()`` shapes): seq mostly even, a
    tenth odd (torn rows); ways tracking addresses 0..999, or NO_ADDR /
    UNPACKABLE; timestamps around ``base``, newest first, a fifth of the
    slots empty (EMPTY_TS); int64 data over the whole range."""
    from repro_torch.core.vlt import EMPTY_TS, PackedVLT

    seq = rng.integers(0, 1000, size) * 2 + (rng.random(size) < 0.1)
    addr = rng.integers(0, 1000, (size, ways))
    addr[rng.random((size, ways)) < 0.15] = PackedVLT.NO_ADDR
    addr[rng.random((size, ways)) < 0.05] = PackedVLT.UNPACKABLE
    ts = base + rng.integers(-12, 12, (size, ways, depth))
    ts = -np.sort(-ts, axis=2)
    ts[rng.random((size, ways, depth)) < 0.2] = EMPTY_TS
    data = rng.integers(-(1 << 62), 1 << 62, (size, ways, depth))
    return seq, addr, ts, data


def _mirror_queries(rng, addr, n):
    """``n`` (lock index, address) pairs: a third ask for way 0's
    address, a third for way 1's, the rest for a random address."""
    idxs = rng.integers(0, addr.shape[0], n).astype(np.int64)
    pick = rng.integers(0, 3, n)
    addrs = rng.integers(0, 1000, n).astype(np.int64)
    for w in range(addr.shape[1]):
        sel = pick == w
        addrs[sel] = np.maximum(addr[idxs[sel], w], 0)
    return idxs, addrs


def _mirror_cases(state, idxs, addrs, r_clock):
    """How many elements of each kind a query batch holds (host)."""
    from repro_torch.core.vlt import EMPTY_TS

    seq, addr, ts, _ = state
    rows = addr[idxs]
    match = (rows == addrs[:, None]) & (rows >= 0)
    way = np.where(match.any(axis=1), np.argmax(match, axis=1), 0)
    tw = ts[idxs, way]
    return {"odd_seq": int((seq[idxs] & 1).sum()),
            "unmatched": int((~match.any(axis=1)).sum()),
            "second_way": int((match.any(axis=1) & (way == 1)).sum()),
            "no_version_below": int((~(tw < r_clock).any(axis=1)).sum()),
            "empty_slots": int((tw == EMPTY_TS).sum())}


def mirror_select_checks(torch, dev, rng, bound):
    """mirror_select bit for bit (values and codes, every lane) against
    its plain version on a seeded 2^16-row mirror on the card, clocks
    near 2^40: N = 1, 255, 256, 257 and 4096, on the parameter route
    (N <= 256, else the wrapper's own staged copy) and on the device
    route (the index sets handed in on the card, as the bracketed gather
    stages them), each at three clocks; then timed at N=256 into a
    caller's block.  Returns {"mirror_select": {256: row}}."""
    from repro_torch.core.vlt import PackedVLT
    from repro_torch.kernels import version_select as VS
    from repro_torch.kernels._lib import to_device

    base = 1 << 40
    size = 1 << 16
    state = _mirror_state(rng, size, base)
    mirror = PackedVLT(size, device=dev)
    mirror.load(*state)
    seq, addr, _, _ = mirror.arrays()
    td = mirror._tsdata
    cases, seen, kinds = 0, set(), {}
    for n in (1, 255, 256, 257, 4096):
        idxs, addrs = _mirror_queries(rng, state[1], n)
        i_t, a_t = to_device(idxs, dev), to_device(addrs, dev)
        both = to_device(np.concatenate((idxs, addrs)), dev)
        for r_clock in (base - 13, base, base + 13):
            want = VS.mirror_select_plain(seq, addr, td, i_t, a_t, r_clock)
            for dev_idx in (None, both):
                got = VS.mirror_select(seq, addr, td, idxs, addrs, r_clock,
                                       dev_idx=dev_idx)
                check(equal(torch, got, want),
                      f"mirror_select != plain at N={n} clock={r_clock} "
                      f"route={'device' if dev_idx is not None else 'params'}")
                cases += 1
            seen.update(np.unique(want[1].cpu().numpy()).tolist())
            if n == 4096:
                kinds[r_clock] = _mirror_cases(state, idxs, addrs, r_clock)
    check({0, 1, 2} <= seen, f"mirror_select codes seen: {seen}")
    check(all(v > 0 for k in kinds.values() for v in k.values()),
          f"mirror_select cases missing: {kinds}")
    emit({"kernel_check": "mirror_select", "cases": cases,
          "bit_identical": True, "codes_seen": sorted(seen),
          "kinds_at_4096": kinds[base]})
    n = 256
    idxs, addrs = _mirror_queries(rng, state[1], n)
    i_t, a_t = to_device(idxs, dev), to_device(addrs, dev)
    blk = torch.empty((6, n), dtype=torch.int64, device=dev)
    return {"mirror_select": {n: kernel_row(
        torch, "mirror_select",
        lambda: VS.mirror_select(seq, addr, td, idxs, addrs, base,
                                 out=blk[4:]),
        plain_ms=time_ms(torch, lambda: VS.mirror_select_plain(
            seq, addr, td, i_t, a_t, base)),
        library_ms=None,
        # index and address, seq, two way addresses, one way's four ts
        # and four data slots read; value and code written
        bound_ms=bound((4 + 8 + 8 + 16 + 32 + 32 + 16) * n),
        shape=f"N={n} into a caller's [2, N] block, 2^16-row mirror, "
              "2 ways x depth 4, indices in the parameters")}}


def _previous_mirror_gather(mirror, idx, r_clock):
    """The mirror resolve ``mirror_select`` replaced (``PackedVLT.gather``):
    seq, the way addresses, every way's slots and seq again by advanced
    indexing, then one ``version_select`` launch over N x ways rows."""
    from repro_torch.kernels import version_select as VS

    n, ways, depth = idx.numel(), mirror.ways, mirror.depth
    s1 = mirror._seq[idx]
    rows_addr = mirror._addr[idx]
    td = mirror._tsdata[:, idx]
    s2 = mirror._seq[idx]
    vals, found = VS.version_select(td[0].reshape(n * ways, depth),
                                    td[1].reshape(n * ways, depth), r_clock)
    return s1, s2, rows_addr, vals.view(n, ways), found.view(n, ways)


def _previous_resolve(s1, s2, rows_addr, vals, found, addrs, ways=2):
    """... and its host side (``PackedVLT.resolve``): the way match over
    [N, ways] and the way hits."""
    stable = (s1 == s2) & ((s1 & 1) == 0)
    match = rows_addr == np.asarray(addrs, np.int64)[:, None]
    way = np.argmax(match, axis=1)
    rows = np.arange(way.size)
    ok = stable & match.any(axis=1) & (found[rows, way] != 0)
    for w in range(1, ways):
        int((ok & (way == w)).sum())
    return vals[rows, way], ok


def _previous_scatter(row, addrs, values):
    """The host-column scatter ``scatter_pairs`` replaced: the values coerced
    and staged (``stage_copy``), the addresses staged, then
    ``scatter_write_dev`` — three device operations, two allocations."""
    import torch

    from repro_torch.kernels import _lib
    from repro_torch.kernels import scatter_write as SW

    _lib.check_row(row)
    a = _lib.host_index(addrs)
    _lib.check_addr_bounds(a, row.numel())
    if isinstance(values, torch.Tensor):
        vals = values.reshape(-1).to(device=row.device, dtype=torch.int64)
    else:
        arr = np.asarray(values)
        if arr.dtype.kind not in "iu":
            arr = np.fromiter((int(v) for v in values), np.int64, a.size)
        vals = _lib.to_device(arr.reshape(-1), row.device)
    SW.scatter_write_dev(row, _lib.to_device(a, row.device), vals)


def op_counts(torch, fn, iters=20):
    """Device operations per call of ``fn`` from a ``torch.profiler``
    trace of ``iters`` warmed calls: each kernel by its ``__global__``
    name, host->device and device->host copies, memsets.  ``fn`` launches
    at least one kernel a call, so a trace holding fewer than ``iters``
    kernels lost events (the card's profiler once kept 2 calls of 20)
    and is taken again."""
    from torch.profiler import ProfilerActivity, profile

    names = sorted({k for ks in DEVICE_KERNELS.values() for k in ks},
                   key=len, reverse=True)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        gpu = gpu_events(prof)
        if sum(e["cat"] == "kernel" for e in gpu) >= iters:
            break
    counts = defaultdict(int)
    for e in gpu:
        name = e["name"]
        if e["cat"] == "kernel":
            key = next((k for k in names if k in name), name[:80])
        elif e["cat"] == "gpu_memcpy":
            key = next((f"memcpy_{d}" for d in ("HtoD", "DtoH", "DtoD")
                        if d in name), "memcpy")
        else:
            key = "memset"
        counts[key] += 1
    return {k: v / iters for k, v in sorted(counts.items())}


def host_path_checks(torch, dev, rng, heap):
    """The main path's calls through the two redesigned kernels, against
    the paths they replaced (timed in 15 paired ABBA turns, host time
    split into parts) and counted in a profiler trace:

      * a versioned chunk at N=256 (2^16-row mirror, 2^16 lock words, the
        1,000,000-word heap): the mirror resolve from the chunk's lock
        indices and addresses to host (values, ok) — ``PackedVLT.select``
        and one copy against ``gather`` + ``to_host`` + ``resolve`` — and
        the whole chunk with its bracketed gather;
      * the write-back at N=1024: ``ArrayHeap.scatter`` from a list;
      * the release at N=1024: ``unlock_bulk`` at a version.

    The operation counts: a versioned chunk through
    ``bulkread.gather_versioned`` on a multiverse engine is two kernels
    and one device->host copy; a scatter of <= 1024 pairs from host
    columns one kernel and no copy, a larger one one copy and one
    kernel."""
    from repro_torch.configs.paper_stm import MultiverseParams
    from repro_torch.core.engine import arrayheap as AH
    from repro_torch.core.engine import bulkread as B
    from repro_torch.core.vlt import PackedVLT
    from repro_torch.kernels import _lib
    from repro_torch.kernels import gather_read as GR
    from repro_torch.kernels import scatter_write as SW
    from repro_torch.kernels import version_select as VS

    out = {}
    base, n = 1 << 40, 256
    state = _mirror_state(rng, 1 << 16, base)
    mirror = PackedVLT(1 << 16, device=dev)
    mirror.load(*state)
    seq, addr, _, _ = mirror.arrays()
    td = mirror._tsdata
    words = _lib.to_device(rng.integers(0, 1 << 62, 1 << 16), dev)
    idxs, addrs = _mirror_queries(rng, state[1], n)
    i_t = _lib.to_device(idxs, dev)
    m_out = torch.empty((2, n), dtype=torch.int64, device=dev)

    def new_mirror():
        mirror.select(idxs, addrs, base, out=m_out)
        host = m_out.cpu().numpy()
        return host[0], host[1] != 0

    def previous_mirror():
        rows = _lib.to_host(list(_previous_mirror_gather(mirror, i_t,
                                                         base)))
        return _previous_resolve(*rows, addrs)

    def new_chunk():
        blk, staged = GR.gather_bracketed(words, heap, idxs, addrs,
                                          rows=6, with_index=True)
        mirror.select(idxs, addrs, base, dev_idx=staged, out=blk[4:])
        host = blk.cpu().numpy()
        return host[:2], host[4], host[5] != 0

    def previous_chunk():
        blk = GR.gather_bracketed(words, heap, idxs, addrs)
        rows = _previous_mirror_gather(mirror, blk[3], base)
        w, *rows = _lib.to_host([blk[:2], *rows])
        return (w, *_previous_resolve(*rows, addrs))

    for new, old in ((new_mirror(), previous_mirror()),
                     (new_chunk()[1:], previous_chunk()[1:])):
        check(np.array_equal(new[1], old[1])
              and np.array_equal(new[0][new[1]], old[0][old[1]]),
              "the mirror resolve differs from the path it replaced")
    check(0 < int(new_mirror()[1].sum()) < n,
          "the timed chunk resolves none or all of its elements")
    def param_fill():
        p = np.empty(VS.PARAM_IDX, np.int32)
        p[:n] = idxs
        return p

    pidx = param_fill()
    parts = {
        "previous.seq_gather": lambda: mirror._seq[i_t],
        "previous.addr_gather": lambda: mirror._addr[i_t],
        "previous.slot_gather": lambda: mirror._tsdata[:, i_t],
        "previous.version_select": lambda: VS.version_select(
            td[0, :n].reshape(-1, 4), td[1, :n].reshape(-1, 4), base),
        "previous.gather": lambda: _previous_mirror_gather(mirror, i_t,
                                                           base),
        "previous.to_host": lambda: _lib.to_host(
            list(_previous_mirror_gather(mirror, i_t, base))),
        "previous.whole": previous_mirror,
        "new.host_index_two": lambda: (_lib.host_index(idxs),
                                       _lib.host_index(addrs)),
        "new.bounds": lambda: _lib.check_addr_bounds(idxs, 1 << 16),
        "new.param_fill": param_fill,
        "new.c_call": lambda: _lib.launch(
            "mirror_select_i64", dev, seq.data_ptr(), addr.data_ptr(),
            td.data_ptr(), 1 << 16, 2, 4, 1, None, pidx.ctypes.data,
            addrs.ctypes.data, n, base, m_out.data_ptr()),
        "new.wrapper": lambda: mirror.select(idxs, addrs, base, out=m_out),
        "new.copy_back": lambda: m_out.cpu(),
        "new.whole": new_mirror,
        "chunk.previous": previous_chunk,
        "chunk.new": new_chunk,
    }
    emit({"host_split": "versioned_chunk",
          "shape": f"N={n}, 2^16-row mirror (2 ways x 4), 2^16 lock words",
          "ns_per_call": run_split(torch, parts, 1000)})
    runs = in_turns(torch, {"new": new_mirror, "previous": previous_mirror,
                            "chunk_new": new_chunk,
                            "chunk_previous": previous_chunk})
    out["versioned_chunk_256"] = _paired(
        runs, "new", "previous", shape=f"N={n}: lock indices and addresses "
        "to host (values, ok), 2^16-row mirror",
        chunk=_paired(runs, "chunk_new", "chunk_previous",
                      shape="the chunk with its bracketed gather"))

    # the write-back and the release at N=1024
    m = 1024
    ah = AH.ArrayHeap(1 << 20, device=dev)
    ah.alloc(1 << 20, 0)
    w_addrs = rng.permutation(1 << 20)[:m].astype(np.int64)
    w_vals = rng.integers(-(1 << 62), 1 << 62, m).tolist()
    locks = AH.ArrayLockTable(16, device=dev)
    l_idxs = rng.integers(0, 1 << 16, m).astype(np.int64)
    version = (1 << 40) + 7
    word = (version << 18) | AH.pack_lock(AH.LockState(False, 0, -1, False))

    def previous_writeback():
        a = _lib.host_index(w_addrs)
        with ah._lock:
            _previous_scatter(ah._buf[:ah._len], a, w_vals)

    def previous_release():
        arr = np.asarray(l_idxs, np.int64)
        stripes = locks._stripes.for_indices(arr)
        for st in stripes:
            st.acquire()
        try:
            _previous_scatter(locks.row, arr, np.full(arr.size, word,
                                                      np.int64))
        finally:
            for st in stripes:
                st.release()

    for target, new_fn, old_fn in (
            (ah.live(), lambda: ah.scatter(w_addrs, w_vals),
             previous_writeback),
            (locks.row, lambda: locks.unlock_bulk(l_idxs, version),
             previous_release)):
        target.copy_(_lib.to_device(rng.integers(0, 1 << 62,
                                                 target.numel()), dev))
        start = target.clone()
        new_fn()
        got = target.clone()
        target.copy_(start)
        old_fn()
        check(equal(torch, got, target) and not equal(torch, got, start),
              "a scatter differs from the path it replaced")
    buf = np.empty(2 * m, np.int64)
    parts = {
        "previous.as_values_and_stage": lambda: _lib.to_device(
            np.asarray(w_vals), dev),
        "previous.index_stage": lambda: _lib.to_device(w_addrs, dev),
        "previous.whole": previous_writeback,
        "new.checks": lambda: (_lib.check_row(ah.live()),
                               _lib.check_addr_bounds(w_addrs, ah._len)),
        "new.pack": lambda: SW.pack_pairs(buf, w_addrs, w_vals),
        "new.c_call": lambda: _lib.launch(
            "scatter_pairs_i64", dev, ah.live().data_ptr(), ah._len,
            buf.ctypes.data, None, None, None, m, 0, 0),
        "new.whole": lambda: ah.scatter(w_addrs, w_vals),
        "release.previous": previous_release,
        "release.new": lambda: locks.unlock_bulk(l_idxs, version),
    }
    emit({"host_split": "scatter_host_columns",
          "shape": f"N={m} (list values) into 2^20 heap words; release "
                   f"at a version over 2^16 lock words",
          "ns_per_call": run_split(torch, parts, 1000)})
    runs = in_turns(torch, {
        "writeback_new": lambda: ah.scatter(w_addrs, w_vals),
        "writeback_previous": previous_writeback,
        "release_new": lambda: locks.unlock_bulk(l_idxs, version),
        "release_previous": previous_release})
    out["writeback_1024"] = _paired(
        runs, "writeback_new", "writeback_previous",
        shape=f"ArrayHeap.scatter, N={m} list values, 2^20 words")
    out["release_1024"] = _paired(
        runs, "release_new", "release_previous",
        shape=f"ArrayLockTable.unlock_bulk at a version, N={m}, 2^16 words")

    # operation counts from a profiler trace
    tm = _make("multiverse", 2, MultiverseParams(lock_table_bits=16))
    eng = tm.raw
    b0 = tm.alloc(4096, INITIAL)
    chunk = np.arange(b0, b0 + n, dtype=np.int64)
    row = heap.clone()
    h_idx = rng.permutation(heap.numel())[:4096].astype(np.int64)
    h_vals = rng.integers(0, 1 << 40, 4096)
    counts = {
        "versioned_chunk_256": op_counts(torch, lambda: B.gather_versioned(
            eng, chunk, eng.policy.vlt.mirror, eng.clock.load())),
        "scatter_host_1024": op_counts(torch, lambda: SW.scatter_write(
            row, h_idx[:1024], h_vals[:1024])),
        "scatter_host_4096": op_counts(torch, lambda: SW.scatter_write(
            row, h_idx, h_vals)),
        "writeback_1024": op_counts(torch, lambda: ah.scatter(
            w_addrs, w_vals)),
        "release_1024": op_counts(torch, lambda: locks.unlock_bulk(
            l_idxs, version)),
    }
    tm.stop()
    emit({"op_counts": counts})
    one = {"scatter_pairs_kernel": 1.0}
    check(counts["versioned_chunk_256"] == {
        "gather_bracketed_kernel": 1.0, "memcpy_DtoH": 1.0,
        "mirror_select_kernel": 1.0},
        f"a versioned chunk is not two kernels and one copy: "
        f"{counts['versioned_chunk_256']}")
    for k in ("scatter_host_1024", "writeback_1024", "release_1024"):
        check(counts[k] == one, f"{k} is not one kernel: {counts[k]}")
    check(counts["scatter_host_4096"] == {"memcpy_HtoD": 1.0, **one},
          f"a staged scatter is not one copy and one kernel: "
          f"{counts['scatter_host_4096']}")
    return {"host_paths": out}


def _paired(runs, new, old, **rest):
    """A timing row from ``in_turns`` runs: both paths' medians and the
    median of the per-turn ratios new / old."""
    ratios = [a / b for a, b in zip(runs[new], runs[old])]
    return dict(ms=float(np.median(runs[new])), ms_runs=runs[new],
                previous_ms=float(np.median(runs[old])),
                previous_ms_runs=runs[old],
                paired_ratio_to_previous=float(np.median(ratios)), **rest)


def _words(ver, own, meta):
    """Packed lock words (ArrayLockTable's layout) from version, owner
    tid and meta (bit0 locked, bit1 flag)."""
    from repro_torch.kernels import commit_fused as CF
    own = np.asarray(own, np.int64)
    meta = np.asarray(meta, np.int64)
    return ((np.asarray(ver, np.int64) << CF.VER_SHIFT)
            | (((own + CF.TID_BIAS) & CF.TID_MASK) << 2)
            | ((meta & 1) << 1) | ((meta >> 1) & 1))


def _group_batch(rng, n_txn, h, rows_per, n_l, n_r, base, fail):
    """A packed group: member t writes ``rows_per[t]`` distinct rows of a
    heap of ``h`` words; ``n_l``/``n_r`` lock and read entries with
    versions near ``base``; with ``fail`` some entries are locked by
    foreign tids, flagged, or too new, so some members fail."""
    perm = rng.permutation(h)[:int(sum(rows_per))]
    cut = np.cumsum([0] + list(rows_per))
    w_parts = [perm[cut[t]:cut[t + 1]].astype(np.int64)
               for t in range(n_txn)]
    from repro_torch.kernels.commit_fused import pack_segments
    w_flat, w_seg, _ = pack_segments(w_parts)
    big = 1 << 62
    w_val = rng.integers(-big, big, w_flat.size, dtype=np.int64)

    def entries(k):
        ver = base + rng.integers(-40, 1, k, dtype=np.int64)
        own = rng.integers(-1, n_txn, k)
        meta = np.zeros(k, np.int64)
        if fail:
            meta = rng.integers(0, 4, k) * (rng.random(k) < 0.002)
            ver = ver + rng.integers(0, 80, k) * (rng.random(k) < 0.002)
        return _words(ver, own, meta)
    return dict(
        w_addr=w_flat, w_val=w_val, w_seg=w_seg,
        l_words=entries(n_l),
        l_seg=rng.integers(0, n_txn, n_l).astype(np.int64),
        r_words=entries(n_r),
        r_seen=base + rng.integers(-40, 1, n_r, dtype=np.int64),
        r_seg=rng.integers(0, n_txn, n_r).astype(np.int64),
        tids=np.arange(n_txn, dtype=np.int64),
        r_clocks=np.full(n_txn, base, np.int64))


def commit_fused_checks(torch, dev, rng, bound):
    """commit_fused against its plain version on the card: modes LT, LE
    and EQ, failing members, empty read or lock batches, int64 payloads
    beyond int32, ragged N, in place and out of place; the MVStore's
    fused publish with its ring refresh against the CPU route; then the
    timings at the group trial's shape and at the MVStore publish."""
    from repro_torch.core import mvstore as MV
    from repro_torch.configs.base import MVStoreConfig
    from repro_torch.kernels import commit_fused as CF
    from repro_torch.kernels._lib import to_device

    H = 1_000_000
    base = 1 << 40
    heap_np = rng.integers(-(1 << 62), 1 << 62, H, dtype=np.int64)

    def both(heap_t, b, cv, n_txn, mode, oop):
        k_heap = heap_t.clone()
        got = CF.commit_fused(k_heap, b["w_addr"], b["w_val"], b["w_seg"],
                              b["l_words"], b["l_seg"], b["r_words"],
                              b["r_seen"], b["r_seg"], b["tids"],
                              b["r_clocks"], cv, n_txn, mode=mode,
                              out_of_place=oop)
        dv = {k: to_device(np.asarray(v, np.int64), dev)
              for k, v in b.items()}
        want = CF.commit_fused_plain(
            heap_t.clone(), dv["w_addr"], dv["w_val"].to(heap_t.dtype),
            dv["w_seg"], dv["l_words"], dv["l_seg"], dv["r_words"],
            dv["r_seen"], dv["r_seg"], dv["tids"], dv["r_clocks"], cv,
            n_txn, mode, oop)
        return got, want, k_heap

    heap_t = to_device(heap_np, dev)
    cases = 0
    for mode in (CF.MODE_LT, CF.MODE_LE, CF.MODE_EQ):
        for n_l, n_r in ((2000, 2000), (0, 1500), (1500, 0), (0, 0)):
            n_txn = 8
            rows = rng.integers(0, 300, n_txn)        # ragged, some empty
            b = _group_batch(rng, n_txn, H, rows, n_l, n_r, base,
                             fail=True)
            for oop in (False, True):
                got, want, k_heap = both(heap_t, b, base + 7, n_txn, mode,
                                         oop)
                for g, w, what in zip(got, want, ("heap", "ok", "l_out")):
                    check(equal(torch, g, w),
                          f"commit_fused {what} != plain (mode {mode}, "
                          f"L={n_l}, M={n_r}, out_of_place={oop})")
                check((got[0] is k_heap) != oop,
                      "commit_fused in/out of place mixed up")
                if oop:
                    check(equal(torch, k_heap, heap_t),
                          "out-of-place commit_fused wrote its input")
                cases += 1
    # a group whose member 3 finds a write lock held by a foreign tid:
    # exactly that member fails, and its rows stay as they were
    b = _group_batch(rng, 8, H, [64] * 8, 400, 400, base, fail=False)
    j = int(np.nonzero(b["l_seg"] == 3)[0][0])
    b["l_words"][j] = _words([base], [9], [1])[0]
    got, want, _ = both(heap_t, b, base + 7, 8, CF.MODE_LE, False)
    check(got[1].cpu().numpy().tolist() == [True] * 3 + [False] + [True] * 4
          and equal(torch, got[0], want[0]),
          "commit_fused: the member with a foreign lock did not fail alone")
    rows3 = b["w_addr"][b["w_seg"] == 3]
    check(np.array_equal(got[0][to_device(rows3, dev)].cpu().numpy(),
                         heap_np[rows3]), "a failed member's rows changed")

    # the MVStore publish (int32 block, out of place) with the ring
    # refresh, against the same publish on the CPU
    cfg = MVStoreConfig(ring_slots=8)
    blk = rng.integers(-1000, 1000, H).astype(np.int32)
    sts = {d: MV.mv_init({"heap": torch.from_numpy(blk.copy()).to(d)}, cfg,
                         versioned="all") for d in (dev, "cpu")}
    for step in range(10):
        a = rng.choice(H, 2, replace=False)
        v = rng.integers(-1000, 1000, 2)
        for d in sts:
            sts[d] = MV.mv_commit_fused(sts[d], "heap", a, v,
                                        local_mode="U", cfg=cfg)
    g, c = sts[dev], sts["cpu"]
    for what, x, y in (("block", g.live["heap"], c.live["heap"]),
                       ("ring", g.ring["['heap']"], c.ring["['heap']"]),
                       ("ring_ts", g.ring_ts["['heap']"],
                        c.ring_ts["['heap']"])):
        check(equal(torch, x.cpu(), y), f"mv_commit_fused {what}: card != "
                                        "CPU")
    check(g.clock == c.clock == 10, "mv_commit_fused clock")

    cases += ring_and_device_word_checks(torch, dev, rng, heap_np, base)

    # the group trial's shape: 8 members x 1024 rows, 8192 lock and 8192
    # read entries, in place over the 1M-word int64 heap; one batch in
    # which every member survives (the one timed below) and one in which
    # member 2 meets a foreign write lock and member 5 a read too new
    n_txn, n_l, n_r = 8, 8192, 8192
    b = _group_batch(rng, n_txn, H, [1024] * n_txn, n_l, n_r, base,
                     fail=False)
    b_fail = _group_batch(rng, n_txn, H, [1024] * n_txn, n_l, n_r, base,
                          fail=False)
    b_fail["l_words"][np.nonzero(b_fail["l_seg"] == 2)[0][0]] = _words(
        [base], [9], [1])[0]
    b_fail["r_words"][np.nonzero(b_fail["r_seg"] == 5)[0][0]] = _words(
        [base + 50], [-1], [0])[0]
    survivors = []
    for bb in (b, b_fail):
        got, want, _ = both(heap_t, bb, base + 7, n_txn, CF.MODE_LE, False)
        for g, w, what in zip(got, want, ("heap", "ok", "l_out")):
            check(equal(torch, g, w), f"commit_fused {what} != plain at "
                                      "the group trial's shape")
        survivors.append(got[1].cpu().numpy().tolist())
        cases += 1
    check(survivors == [[True] * 8, [True] * 2 + [False] + [True] * 2
                        + [False] + [True] * 2],
          f"commit_fused group-shape verdicts: {survivors}")
    emit({"kernel_check": "commit_fused", "cases": cases,
          "group_shape_verdicts": survivors, "mvstore_publishes": 10,
          "bit_identical": True})

    rows = {}
    n = b["w_addr"].size
    dv = {k: to_device(np.asarray(v, np.int64), dev) for k, v in b.items()}
    g_heap, h_heap, p_heap, l_heap = (heap_t.clone() for _ in range(4))
    group = (b["w_addr"], b["w_val"], b["w_seg"], dv["l_words"], b["l_seg"],
             dv["r_words"], b["r_seen"], b["r_seg"], b["tids"],
             b["r_clocks"], base + 7, n_txn)
    group_host = group[:3] + (b["l_words"], b["l_seg"], b["r_words"]) + \
        group[6:]

    def plain():
        CF.commit_fused_plain(p_heap, dv["w_addr"], dv["w_val"],
                              dv["w_seg"], dv["l_words"], dv["l_seg"],
                              dv["r_words"], dv["r_seen"], dv["r_seg"],
                              dv["tids"], dv["r_clocks"], base + 7, n_txn,
                              CF.MODE_LE)
    # LE mode reads each read entry's word and segment (no seen), each
    # lock entry's word and segment and writes its release word, each
    # write row's address, value and segment and writes one heap word,
    # and the members' tid and clock (ok written)
    group_bound = bound(16 * n_r + 24 * n_l + 32 * n + 17 * n_txn)
    plain_ms = time_ms(torch, plain)
    library_ms = time_ms(torch, lambda: l_heap.index_copy_(
        0, dv["w_addr"], dv["w_val"]))
    # as the group publish calls it: the lock words it gathered on the
    # card go in as device tensors
    rows["group"] = kernel_row(
        torch, "commit_fused", lambda: CF.commit_fused(
            g_heap, *group, mode=CF.MODE_LE),
        shape=f"T={n_txn} N={n} L={n_l} M={n_r} H={H} int64 in place, "
              "lock words on the card",
        plain_ms=plain_ms, library_ms=library_ms,
        library="index_copy_ (the scatter part alone)",
        bound_ms=group_bound)
    rows["group_host_words"] = kernel_row(
        torch, "commit_fused", lambda: CF.commit_fused(
            h_heap, *group_host, mode=CF.MODE_LE),
        shape=f"T={n_txn} N={n} L={n_l} M={n_r} H={H} int64 in place, "
              "lock words from the host",
        plain_ms=plain_ms, library_ms=library_ms,
        library="index_copy_ (the scatter part alone)",
        bound_ms=group_bound)
    # the timed publishes rewrite the same values: the heaps agree
    check(equal(torch, g_heap, p_heap) and equal(torch, h_heap, p_heap),
          "commit_fused heap != plain after the timed group publishes")

    # MVStore publish shape: one member, two rows, 1M-word int32 block,
    # out of place, the 8-slot ring's slot refreshed in the same call;
    # timed in turns beside the same work through library calls
    R, slot = 8, 3
    blk_t = torch.from_numpy(blk).to(dev)
    ring8 = torch.from_numpy(rng.integers(-1000, 1000, (R, H)).astype(
        np.int32)).to(dev)
    ts8 = torch.full((R,), -1, dtype=torch.int32, device=dev)
    y_ring, y_ts = ring8.clone(), ts8.clone()
    a2 = np.array([17, 999_983], np.int64)
    v2 = np.array([5, -5], np.int64)
    z, one = np.zeros((0,), np.int64), np.zeros(1, np.int64)
    a2_t, v2_t = to_device(a2, dev), to_device(v2, dev).to(torch.int32)
    z_t, one_t = to_device(z, dev), to_device(one, dev)
    s2_t = to_device(np.zeros(2, np.int64), dev)
    mv_args = (blk_t, a2, v2, [0, 0], z, z, z, z, z, one, one, 3, 1)
    mv_kw = dict(out_of_place=True, ring=ring8, ring_ts=ts8, ring_slot=slot)

    def same_work():
        new = torch.index_copy(blk_t, 0, a2_t, v2_t)
        y_ring[slot].copy_(new)
        y_ts[slot] = 3
        return new
    got = CF.commit_fused(*mv_args, **mv_kw)
    want = same_work()
    check(equal(torch, got[0], want) and equal(torch, ring8, y_ring)
          and equal(torch, ts8, y_ts), "commit_fused's ring-refreshing "
                                       "publish != the library calls")
    runs = in_turns(torch, {"wrapper": lambda: CF.commit_fused(
        *mv_args, **mv_kw), "same_work": same_work})
    ratios = [x / y for x, y in zip(runs["wrapper"], runs["same_work"])]
    rows["mvstore"] = dict(
        ms=float(np.median(runs["wrapper"])), ms_runs=runs["wrapper"],
        paired_ratio_median=float(np.median(ratios)),
        turns_at_or_under_library=sum(r <= 1 for r in ratios),
        **device_times(torch, lambda: CF.commit_fused(*mv_args, **mv_kw),
                       DEVICE_KERNELS["commit_fused"]),
        shape=f"T=1 N=2 H={H} int32 out of place, R={R} ring refreshed",
        plain_ms=time_ms(torch, lambda: CF.commit_fused_plain(
            blk_t, a2_t, v2_t, s2_t, z_t, z_t, z_t, z_t, z_t, one_t, one_t,
            3, 1, CF.MODE_LE, True, ring8, ts8, slot)),
        library_ms=float(np.median(runs["same_work"])),
        library_ms_runs=runs["same_work"],
        library="torch.index_copy (out of place), ring[slot].copy_, "
                "ring_ts[slot] = clock",
        # the block read once, the new block and the ring row written
        # once each, plus the two rows (address, value, segment), the
        # member's tid/clock, its ok byte and the ring timestamp
        bound_ms=bound(3 * 4 * H + 2 * (8 + 4 + 8) + 16 + 1 + 4))
    emit({"host_split": "commit_fused",
          "shape": rows["mvstore"]["shape"],
          "ns_per_call": commit_fused_host_split(
              torch, dev, mv_args, mv_kw, out_of_place=True)})
    emit({"host_split": "commit_fused", "shape": rows["group"]["shape"],
          "ns_per_call": commit_fused_host_split(
              torch, dev, (heap_t.clone(),) + group_host,
              dict(mode=CF.MODE_LE), out_of_place=False,
              dev_words=(dv["l_words"], dv["r_words"]), calls=300)})
    return {"commit_fused": rows}


def ring_and_device_word_checks(torch, dev, rng, heap_np, base):
    """commit_fused with the ring refresh (int64 and int32 heaps, in and
    out of place, int32 and int64 timestamps) and with the lock words as
    device tensors, against the plain version on the card; and the fault
    split (three C calls around ``mid_scatter``) against the plain
    version's split.  Returns the number of cases."""
    from repro_torch.kernels import commit_fused as CF
    from repro_torch.kernels._lib import to_device
    from repro_torch.reliability import faultpoints as FP

    # the commit version a ring timestamp holds fits in int32
    H, R, cases, cv = 100_003, 4, 0, 12_345
    for dtype in (torch.int64, torch.int32):
        heap0 = torch.from_numpy(heap_np[:H].copy()).to(dtype).to(dev)
        for mode in (CF.MODE_LT, CF.MODE_LE, CF.MODE_EQ):
            b = _group_batch(rng, 6, H, rng.integers(0, 200, 6), 500, 500,
                             base, fail=True)
            dv = {k: to_device(np.asarray(v, np.int64), dev)
                  for k, v in b.items()}
            for oop, ts_dtype, dev_words in ((False, torch.int32, True),
                                             (True, torch.int64, False),
                                             (True, torch.int32, True)):
                ring0 = heap0.repeat(R, 1) - 1
                ts0 = torch.tensor([1, -1, 3, 2], dtype=ts_dtype,
                                   device=dev)
                slot = int(rng.integers(0, R))
                k_heap, k_ring, k_ts = heap0.clone(), ring0.clone(), \
                    ts0.clone()
                lw = dv["l_words"] if dev_words else b["l_words"]
                rw = dv["r_words"] if dev_words else b["r_words"]
                got = CF.commit_fused(
                    k_heap, b["w_addr"], b["w_val"], b["w_seg"], lw,
                    b["l_seg"], rw, b["r_seen"], b["r_seg"], b["tids"],
                    b["r_clocks"], cv, 6, mode=mode, out_of_place=oop,
                    ring=k_ring, ring_ts=k_ts, ring_slot=slot)
                p_ring, p_ts = ring0.clone(), ts0.clone()
                want = CF.commit_fused_plain(
                    heap0.clone(), dv["w_addr"], dv["w_val"].to(dtype),
                    dv["w_seg"], dv["l_words"], dv["l_seg"], dv["r_words"],
                    dv["r_seen"], dv["r_seg"], dv["tids"], dv["r_clocks"],
                    cv, 6, mode, oop, p_ring, p_ts, slot)
                for g, w, what in zip(got, want, ("heap", "ok", "l_out",
                                                  "ring", "ring_ts")):
                    check(equal(torch, g, w),
                          f"commit_fused with the ring refresh: {what} != "
                          f"plain ({dtype}, mode {mode}, out_of_place="
                          f"{oop}, device words {dev_words})")
                check(equal(torch, k_ring[slot], got[0])
                      and int(k_ts[slot]) == cv,
                      "the refreshed ring slot is not the new heap at cv")
                if oop:
                    check(equal(torch, k_heap, heap0),
                          "out-of-place commit_fused wrote its input")
                cases += 1
    # the fault split: the heap image at mid_scatter and the result
    b = _group_batch(rng, 4, H, [40, 0, 33, 51], 300, 300, base, fail=True)
    dv = {k: to_device(np.asarray(v, np.int64), dev) for k, v in b.items()}
    heap0 = torch.from_numpy(heap_np[:H].copy()).to(dev)
    images = {}
    active, fire = FP.ACTIVE, FP.fire
    try:
        for route in ("card", "plain"):
            heap = heap0.clone()
            ring, ts = heap0.repeat(2, 1), torch.zeros(2, dtype=torch.int32,
                                                       device=dev)
            FP.ACTIVE = object()
            FP.fire = lambda point, tid=-1, route=route, heap=heap, \
                ring=ring: images.setdefault(route, (
                    point, heap.clone(), ring[1].clone()))
            if route == "card":
                got = CF.commit_fused(
                    heap, b["w_addr"], b["w_val"], b["w_seg"], dv["l_words"],
                    b["l_seg"], dv["r_words"], b["r_seen"], b["r_seg"],
                    b["tids"], b["r_clocks"], cv, 4,
                    mode=CF.MODE_LE, ring=ring, ring_ts=ts, ring_slot=1)
            else:
                want = CF.commit_fused_plain(
                    heap, dv["w_addr"], dv["w_val"], dv["w_seg"],
                    dv["l_words"], dv["l_seg"], dv["r_words"], dv["r_seen"],
                    dv["r_seg"], dv["tids"], dv["r_clocks"], cv, 4,
                    CF.MODE_LE, False, ring, ts, 1)
    finally:
        FP.ACTIVE, FP.fire = active, fire
    for g, w in zip(got, want):
        check(equal(torch, g, w), "commit_fused's fault split != plain")
    (pc, hc, rc), (pp, hp, rp) = images["card"], images["plain"]
    check(pc == pp == "mid_scatter" and equal(torch, hc, hp)
          and equal(torch, rc, rp),
          "commit_fused's heap at mid_scatter != the plain version's")
    return cases + 1


def commit_fused_host_split(torch, dev, args, kw, out_of_place, calls=1000,
                            dev_words=None):
    """Host time of one ``commit_fused`` call, by part: the mean of
    ``calls`` runs of each part, ``time.perf_counter_ns`` around the loop
    (the card drains after each part, outside the clock).  The earlier
    wrapper is kept here as ``previous_path`` — its host steps in order,
    ending in the present entry point with no staged copy (its own call
    also set ``ok`` with a memset, which is not in it) — and split into
    its steps, beside the present wrapper and its steps; ``dev_words``
    (the lock words on the card) times the wrapper as the group publish
    now calls it."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import commit_fused as CF
    from repro_torch.kernels import gather_read as GR

    heap, w_addr, w_val, w_seg, l_words, l_seg, r_words, r_seen, r_seg, \
        tids, r_clocks, cv, n_txn = args
    mode = kw.get("mode", CF.MODE_LE)
    heap = heap.clone()
    ring_kw = {k: kw[k] for k in ("ring", "ring_ts", "ring_slot") if k in kw}
    entry = CF._ENTRY[heap.dtype]
    nine = (w_addr, w_seg, l_words, l_seg, r_words, r_seen, r_seg, tids,
            r_clocks)

    def prev_cast():
        cols = [np.asarray(x, np.int64).reshape(-1) for x in nine]
        vals = np.asarray(w_val).astype(np.int64, copy=False).reshape(-1)
        return cols, vals
    cols, vals = prev_cast()
    wa, ws, lw, ls, rw, rn, rs, td, rc = cols
    cat = np.concatenate(cols + [vals])
    cut = np.cumsum([0] + [c.size for c in cols] + [vals.size])

    def prev_pinned_copy():
        return torch.from_numpy(cat).pin_memory().to(dev, non_blocking=True)
    dev_cat = prev_pinned_copy()

    def prev_checks():
        for seg in (ws, ls, rs):
            if seg.size and (int(seg.min()) < 0 or int(seg.max()) >= n_txn):
                raise ValueError
        lo, hi = (int(wa.min()), int(wa.max())) if wa.size else (0, 0)
        if lo < 0 or hi >= heap.numel():
            raise IndexError

    def prev_slices(d):
        return [d[cut[k]:cut[k + 1]] for k in range(len(cut) - 1)]

    def prev_allocs():
        return (torch.empty_like(heap) if out_of_place else heap,
                torch.empty(n_txn, dtype=torch.int32, device=dev),
                torch.empty(ls.size, dtype=torch.int64, device=dev))
    ok32 = torch.ones(n_txn, dtype=torch.int32, device=dev)

    def previous_path():
        cols, vals = prev_cast()
        prev_checks()
        d = torch.from_numpy(np.concatenate(cols + [vals])).pin_memory() \
            .to(dev, non_blocking=True)
        wa_t, ws_t, lw_t, ls_t, rw_t, rn_t, rs_t, td_t, rc_t, v_t = \
            prev_slices(d)
        v_t = v_t.to(heap.dtype)
        out, ok, l_out = prev_allocs()
        # the earlier entry took these as 27 ctypes arguments; this one reads
        # them from a header, its columns at word offsets from ok's bytes
        o = ok.data_ptr()
        hdr = np.array((
            heap.data_ptr(), out.data_ptr(), heap.numel(), 0, 0, 0, 0, o, 0,
            0, lw_t.data_ptr(), rw_t.data_ptr(), l_out.data_ptr(), wa.size,
            ls.size, rs.size, int(mode), int(cv),
            *((t.data_ptr() - o) // 8 for t in (wa_t, ws_t, ls_t, rs_t,
                                                 rn_t, td_t, rc_t, v_t)),
            CF._DECIDE | CF._PUBLISH, 0, wa.size, ls.size), np.int64)
        _lib.launch(entry, dev, hdr.ctypes.data)
        CF.launches.add()
        return out, ok != 0, l_out

    lw_arg, rw_arg = dev_words if dev_words is not None else (l_words,
                                                              r_words)

    def host_columns():
        return ([CF._host_col(x, "x") for x in (w_addr, w_seg, l_seg,
                                                 r_seg, r_seen, tids,
                                                 r_clocks)],
                CF._values(w_val),
                CF._words_col(lw_arg, ls.size, heap, "l_words"),
                CF._words_col(rw_arg, rs.size, heap, "r_words"))
    lw_c, rw_c = host_columns()[2:]
    lay = CF._Layout(wa.size, ls.size, rs.size, n_txn, mode,
                     not isinstance(lw_c, torch.Tensor),
                     not isinstance(rw_c, torch.Tensor),
                     heap.element_size())
    pool = _lib.staging(dev)
    blk = torch.empty(8 * (lay.staged + ls.size), dtype=torch.bool,
                      device=dev)
    no_work = np.zeros(CF._CALL_WORDS, np.int64)

    def acquire_release():
        pool.release(pool.acquire())

    two = np.array([3, 4], np.int64)
    one_idx = _lib.to_device(two[:1], dev)

    def without_c_call():
        real = _lib.launch
        _lib.launch = lambda *a: None
        try:
            CF.commit_fused(heap, w_addr, w_val, w_seg, lw_arg, l_seg, rw_arg,
                            r_seen, r_seg, tids, r_clocks, cv, n_txn,
                            mode=mode, out_of_place=out_of_place, **ring_kw)
        finally:
            _lib.launch = real

    def stage():
        st = pool.acquire()
        try:
            _, u8, i64 = st.take(8 * lay.staged)
            CF._stage(u8, i64, lay, wa, ws, ls, rs, rn, td, rc, lw_c, rw_c,
                      vals, heap)
        finally:
            pool.release(st)

    def header():
        head = pool.blocks[0].head
        head[:CF._CALL_WORDS] = (
            heap.data_ptr(), heap.data_ptr(), heap.numel(), 0, 0, 0, 0,
            blk.data_ptr(), 0, 0, 0, 0, 0, wa.size, ls.size, rs.size,
            int(mode), int(cv), *lay.offsets, 0, 0, wa.size, ls.size)

    parts = {
        "prev_cast_columns": prev_cast,
        "prev_checks_min_max": prev_checks,
        "prev_concatenate": lambda: np.concatenate(cols + [vals]),
        "prev_pin_memory": lambda: torch.from_numpy(cat).pin_memory(),
        "prev_pinned_copy": prev_pinned_copy,
        "prev_ten_slices": lambda: prev_slices(dev_cat),
        "prev_value_cast": lambda: dev_cat[cut[-2]:].to(heap.dtype),
        "prev_three_allocs": prev_allocs,
        "prev_ok_compare": lambda: ok32 != 0,
        "previous_path": previous_path,
        "host_columns": host_columns,
        "layout": lambda: CF._Layout(wa.size, ls.size, rs.size, n_txn, mode,
                                     True, True, heap.element_size()),
        "device_block": lambda: torch.empty(8 * (lay.staged + ls.size),
                                            dtype=torch.bool, device=dev),
        "out_block": (lambda: heap.new_empty(heap.shape)) if out_of_place
        else (lambda: None),
        "pool_acquire_release": acquire_release,
        "stage_and_check": stage,
        "call_header": header,
        "ok_view": lambda: blk[:n_txn],
        "ctypes_call_no_work": lambda: _lib.launch(entry, dev,
                                                   no_work.ctypes.data),
        "launch_counter": CF.launches.add,
        # what the C call's CUDA work costs the host: one staged copy
        # (to_device: allocation, stage, copy, event) and one launch
        "to_device_2_words": lambda: _lib.to_device(two, dev),
        "gather_read_dev_1": lambda: GR.gather_read_dev(heap, one_idx),
        "wrapper_without_c_call": without_c_call,
        "wrapper": lambda: CF.commit_fused(
            heap, w_addr, w_val, w_seg, lw_arg, l_seg, rw_arg, r_seen,
            r_seg, tids, r_clocks, cv, n_txn, mode=mode,
            out_of_place=out_of_place, **ring_kw),
    }
    if not ls.size and not rs.size and wa.size <= CF._SMALL_ROWS:
        # the rows route (no read or lock entries): its own steps instead
        # of the staged route's
        for k in ("layout", "device_block", "pool_acquire_release",
                  "stage_and_check", "call_header", "ok_view"):
            del parts[k]
        out = heap.new_empty(heap.shape)
        ok = torch.empty(n_txn, dtype=torch.bool, device=dev)
        call = np.zeros(10 + 2 * CF._SMALL_ROWS, np.int64)
        call[:10] = (heap.data_ptr(), out.data_ptr(), heap.numel(), 0, 0, 0,
                     ok.data_ptr(), n_txn, wa.size, int(cv))
        call[10:10 + wa.size] = wa

        def rows_checks():
            if int(ws.view(np.uint64).max()) >= n_txn or \
                    int(wa.view(np.uint64).max()) >= heap.numel():
                raise ValueError

        head = tuple(call[:10].tolist())

        def rows_call_fill():
            raw, _, words = CF._tls.rows
            CF._ROWS_HEAD.pack_into(raw, 0, *head)
            words[10:10 + wa.size] = wa
            np.copyto(words[10 + CF._SMALL_ROWS:
                            10 + CF._SMALL_ROWS + wa.size], vals,
                      casting="unsafe")
        parts = dict(
            list(parts.items())[:-4], rows_checks=rows_checks,
            ok_alloc=lambda: torch.empty(n_txn, dtype=torch.bool,
                                         device=dev),
            rows_call_fill=rows_call_fill,
            rows_c_call=lambda: _lib.launch(CF._ROWS_ENTRY[heap.dtype], dev,
                                            call.ctypes.data),
            **dict(list(parts.items())[-4:]))
    return run_split(torch, parts, calls)


def run_split(torch, parts, calls):
    """``{part: mean ns per call}``: ``calls`` runs of each part, after a
    tenth as many to warm, ``time.perf_counter_ns`` around the loop and
    the card drained after each part, outside the clock."""
    split = {}
    for name, part in parts.items():
        for _ in range(max(1, calls // 10)):
            part()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            part()
        split[name] = (time.perf_counter_ns() - t0) / calls
        torch.cuda.synchronize()
    return split


def gather_bracketed_host_split(torch, dev, words, heap, idxs, addrs,
                                calls=1000):
    """Host time of one ``gather_bracketed`` call at a scan chunk, by
    part, beside the three-call path it replaces (the earlier
    ``gather_lockver``)."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import gather_read as GR

    n = addrs.size
    i, a = _lib.host_index(idxs), _lib.host_index(addrs)
    out = torch.empty((4, n), dtype=torch.int64, device=dev)
    pidx = np.zeros(2 * GR.PARAM_IDX, np.int32)
    pidx[:n], pidx[GR.PARAM_IDX:GR.PARAM_IDX + n] = i, a

    def fill():
        p = np.empty(2 * GR.PARAM_IDX, np.int32)
        p[:n] = i
        p[GR.PARAM_IDX:GR.PARAM_IDX + n] = a

    def three_calls():
        both = _lib.to_device(np.concatenate((i, a)), dev)
        w = torch.empty((2, n), dtype=torch.int64, device=dev)
        GR.gather_read(words, i, both[:n], out=w[0])
        vals = GR.gather_read(heap, a, both[n:])
        GR.gather_read(words, i, both[:n], out=w[1])
        return w, vals

    parts = {
        "check_rows": lambda: (_lib.check_row(words), _lib.check_row(heap)),
        "host_index_two": lambda: (_lib.host_index(idxs),
                                   _lib.host_index(addrs)),
        "bounds_two": lambda: (_lib.check_addr_bounds(i, words.numel()),
                               _lib.check_addr_bounds(a, heap.numel())),
        "param_fill": fill,
        "out_alloc": lambda: torch.empty((4, n), dtype=torch.int64,
                                         device=dev),
        "c_call": lambda: _lib.launch(
            "gather_bracketed_i64", dev, words.data_ptr(), words.numel(),
            heap.data_ptr(), heap.numel(), 0, pidx.ctypes.data, n,
            out.data_ptr()),
        "idx_row_view": lambda: out[3],
        "wrapper": lambda: GR.gather_bracketed(words, heap, idxs, addrs),
        "to_device_both": lambda: _lib.to_device(np.concatenate((i, a)),
                                                 dev),
        "three_call_path": three_calls,
    }
    return run_split(torch, parts, calls)


def snapshot_select_checks(torch, dev, rng, bound):
    """snapshot_select against its plain version on the card: ties (the
    first maximum wins), no valid slot (slot 0, ok False), NO_TS slots,
    a ragged row; then timed at R=8, n=1,000,000 int32."""
    from repro_torch.kernels import snapshot_select as SS

    R, n = 8, 1_000_000
    ring = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, (R, n), dtype=np.int64).astype(np.int32)).to(dev)
    cases = {"ties": [3, 7, 7, 2, 7, -1, 5, 1],
             "no_valid": [9, 10, 11, 12, 13, 14, 15, 16],
             "no_ts": [-1] * R, "mixed": [4, -1, 6, 3, -1, 8, 2, 6]}
    for name, ts_l in cases.items():
        ts = torch.tensor(ts_l, dtype=torch.int32, device=dev)
        for clock in (0, 4, 6, 7, 20):
            got, ok = SS.snapshot_select(ring, ts, clock)
            want, wok = SS.snapshot_select_plain(ring, ts, clock)
            check(equal(torch, got, want) and bool(ok) == bool(wok),
                  f"snapshot_select != plain ({name}, clock {clock})")
    ragged = ring[:, :1001].contiguous()
    ts = torch.tensor(cases["mixed"], dtype=torch.int32, device=dev)
    got, ok = SS.snapshot_select(ragged, ts, 6)
    want, wok = SS.snapshot_select_plain(ragged, ts, 6)
    check(equal(torch, got, want) and bool(ok) == bool(wok),
          "snapshot_select != plain on a ragged row")
    check(ok.dtype == torch.bool and ok.dim() == 0,
          f"snapshot_select: ok is {ok.dtype} {tuple(ok.shape)}, not a "
          "0-d bool")
    emit({"kernel_check": "snapshot_select", "cases": 5 * len(cases) + 1,
          "bit_identical": True})
    # the one-stream rule: a launch from a side stream is refused
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        try:
            SS.snapshot_select(ring, ts, 6)
            refused = ""
        except RuntimeError as e:
            refused = str(e)
    check("one-stream rule" in refused,
          "snapshot_select ran on a side stream")
    ts = torch.tensor([1, 2, 3, 4, 5, 6, 7, 8], dtype=torch.int32,
                      device=dev)
    slot = int(SS.select_slot_plain(ts, 5)[0])
    emit({"host_split": "snapshot_select", "shape": f"R={R} n={n} int32",
          "ns_per_call": snapshot_select_host_split(torch, dev, ring, ts,
                                                    slot)})
    # the wrapper and the library call are both host-bound, and the
    # host's speed drifts: time them in turns (ABBA), 15 runs of 100 calls
    # each, and keep the medians
    ms, lib_ms = [], []
    for i in range(15):
        pair = [(ms, lambda: SS.snapshot_select(ring, ts, 5)),
                (lib_ms, lambda: ring[slot].clone())]
        for runs, fn in (pair if i % 2 == 0 else pair[::-1]):
            runs.append(time_ms(torch, fn, iters=100, warm=10))
    # the host's speed moves between two levels within a run, so the two
    # lists' medians can fall on different levels: the turns pair them
    ratios = [a / b for a, b in zip(ms, lib_ms)]
    return {"snapshot_select": {n: dict(
        ms=float(np.median(ms)), ms_runs=ms,
        paired_ratio_median=float(np.median(ratios)),
        turns_at_or_under_library=sum(r <= 1 for r in ratios),
        **device_times(torch, lambda: SS.snapshot_select(ring, ts, 5),
                       DEVICE_KERNELS["snapshot_select"]),
        shape=f"R={R} n={n} int32",
        plain_ms=time_ms(torch, lambda: SS.snapshot_select_plain(ring, ts,
                                                                 5)),
        library_ms=float(np.median(lib_ms)), library_ms_runs=lib_ms,
        library="ring[slot].clone()",
        bound_ms=bound(SS.work(ring, ts, 5)[1]))}}


def snapshot_select_host_split(torch, dev, ring, ts, slot, calls=1000):
    """Host time of one ``snapshot_select`` call, by part: the mean of
    ``calls`` runs of each part, ``time.perf_counter_ns`` around the loop
    (the card drains after each part, outside the clock).  The parts of
    the launch path before this one (a device context, two stream objects
    and a 1-element int32 ``ok`` read back through ``ok[0] != 0``) are
    timed as they were, beside the path the wrapper takes now."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import snapshot_select as SS

    lib = _lib.library()
    fn = lib.snapshot_select_rows
    out = ring.new_empty(ring.shape[1:])
    ok = torch.empty((), dtype=torch.bool, device=dev)
    ok32 = torch.empty(1, dtype=torch.int32, device=dev)
    R, row_bytes = ring.shape[0], out.numel() * out.element_size()
    index = torch.cuda.current_device()
    stream = torch.cuda.default_stream(dev).cuda_stream
    args = (ring.data_ptr(), R, row_bytes, ts.data_ptr(), 5, out.data_ptr(),
            ok.data_ptr())

    def previous_checks():
        if ring.dim() < 1 or ring.shape[0] < 1 or ts.dtype != torch.int32 \
                or ts.shape != (R,) or ts.device != ring.device:
            raise ValueError
        _lib.device_kind(ring)
        if not ring.is_contiguous() or not ts.is_contiguous():
            raise ValueError

    def context():
        with torch.cuda.device(dev):
            pass

    def previous_path():
        previous_checks()
        o = torch.empty(ring.shape[1:], dtype=ring.dtype, device=dev)
        k = torch.empty(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            st = torch.cuda.current_stream(dev)
            if st != torch.cuda.default_stream(dev):
                raise RuntimeError
            fn(ring.data_ptr(), R, row_bytes, ts.data_ptr(), 5,
               o.data_ptr(), k.data_ptr(), st.cuda_stream)
        SS.launches.add()
        return o, k[0] != 0

    parts = {
        "previous_checks": previous_checks,
        "empty_out": lambda: torch.empty(ring.shape[1:], dtype=ring.dtype,
                                         device=dev),
        "new_empty_out": lambda: ring.new_empty(ring.shape[1:]),
        "empty_ok_int32": lambda: torch.empty(1, dtype=torch.int32,
                                              device=dev),
        "empty_ok_bool": lambda: torch.empty((), dtype=torch.bool,
                                             device=dev),
        "ok_from_block": lambda: _lib.fresh_ok(dev),
        "device_context": context,
        "stream_objects": lambda: torch.cuda.current_stream(dev)
        != torch.cuda.default_stream(dev),
        "raw_stream_handles": lambda: (
            torch._C._cuda_getDevice(),
            torch._C._cuda_getCurrentRawStream(index) != stream),
        "ctypes_call": lambda: fn(*args, stream),
        "ctypes_call_no_launch": lambda: lib.cuda_error_string(0),
        "ok_index_compare": lambda: ok32[0] != 0,
        "launch_counter": SS.launches.add,
        "lib_launch": lambda: _lib.launch("snapshot_select_rows", dev,
                                          *args),
        "previous_path": previous_path,
        "wrapper": lambda: SS.snapshot_select(ring, ts, 5),
        "ring_slot_clone": lambda: ring[slot].clone(),
    }
    split = {}
    for name, part in parts.items():
        for _ in range(calls // 10):
            part()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            part()
        split[name] = (time.perf_counter_ns() - t0) / calls
        torch.cuda.synchronize()
    return split


#: flash_attention cases: name -> (B, Sq, Sk, H, KV, D, causal, dtype);
#: the first is qwen2.5-3b's prefill in the serving trial
FLASH_CASES = {
    "qwen_prefill_512": (1, 512, 512, 16, 2, 128, True, "bfloat16"),
    "qwen_prefill_2048": (1, 2048, 2048, 16, 2, 128, True, "bfloat16"),
    "noncausal_f32": (2, 512, 512, 16, 2, 128, False, "float32"),
    "ragged_causal_bf16": (1, 300, 300, 16, 2, 128, True, "bfloat16"),
    "ragged_noncausal_f32": (2, 100, 77, 4, 1, 40, False, "float32"),
    # the trainer's forward (4 x 512 tokens a step)
    "train_fwd_b4_512": (4, 512, 512, 16, 2, 128, True, "bfloat16"),
    # paligemma-3b's heads (8 query heads over one kv head of 256)
    "mqa_d256_512": (1, 512, 512, 8, 1, 256, True, "bfloat16"),
    # the paligemma-3b and moonshot-v1-16b-a3b trainers' forward (4 x 512
    # positions a step)
    "paligemma_train_b4_512": (4, 512, 512, 8, 1, 256, True, "bfloat16"),
    "moonshot_train_b4_512": (4, 512, 512, 16, 16, 128, True, "bfloat16"),
    "d256_ragged_f32": (1, 200, 200, 8, 1, 256, True, "float32"),
    # a seamless-style cross-attention: 100 queries over 77 keys
    "cross_d64_bf16": (2, 100, 77, 16, 16, 64, False, "bfloat16"),
    # seamless-m4t-medium at full width (its serving trial's prefill): the
    # encoder over 4096 frames, and the decoder's 512 tokens over them
    "seamless_encoder_4096": (4, 4096, 4096, 16, 16, 64, False,
                              "bfloat16"),
    "seamless_cross_512x4096": (4, 512, 4096, 16, 16, 64, False,
                                "bfloat16"),
    # a head dim the 64-wide padding leaves ragged
    "ragged_d40_bf16": (2, 100, 77, 4, 1, 40, False, "bfloat16"),
    # rows not 16-byte aligned (D % 8 != 0): masked element loads/stores
    "unaligned_d36_bf16": (1, 100, 100, 4, 2, 36, True, "bfloat16"),
}
TOLERANCE = {"bfloat16": 2e-2, "float32": 2e-4}   # rtol = atol


def max_abs_err(torch, got, want, dtype, tol=None):
    """Largest |got - want|; fails unless every element is finite and
    within ``tol`` (``TOLERANCE[dtype]`` by default; rtol = atol, as
    numpy's allclose)."""
    tol = TOLERANCE[dtype] if tol is None else tol
    g, w = got.detach().float(), want.detach().float()
    err = (g - w).abs()
    check(bool(torch.isfinite(g).all()), "non-finite values")
    check(bool((err <= tol + tol * w.abs()).all()),
          f"beyond {tol}: max abs error {float(err.max())}")
    return float(err.max())


def flash_checks(torch, dev):
    """flash_attention against its plain version on the card at every
    case of ``FLASH_CASES``, each then timed: CUDA events, the profiler's
    kernel time, the plain version and ``scaled_dot_product_attention``
    (the library yardstick; the port never calls it) on the same inputs.
    The bound is the larger of the operations (4 B H D per reachable
    (query, key) pair) over the dtype's peak and the bytes of q, k, v and
    the output over the memory rate."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}
    for name, (B, Sq, Sk, H, KV, D, causal, dt) in FLASH_CASES.items():
        dtype = getattr(torch, dt)
        q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, Sk, KV, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, Sk, KV, D, generator=gen, device=dev).to(dtype)
        got = FA.flash_attention(q, k, v, causal=causal)
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        try:
            err = max_abs_err(torch, got, want, dt)
        except Failed as e:
            raise Failed(f"flash_attention != plain ({name}): {e}")
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
        ops = 4 * B * H * D * pairs
        # the plain version at seamless's encoder size takes ~50 ms a call
        plain_iters = dict(iters=10, warm=2) if B * H * pairs > 2 ** 28 \
            else dict(iters=50, warm=5)
        nbytes = FA.work(q, k, v, causal=causal)[1]
        t_ops = ops / PEAK_FLOPS[dt] * 1e3
        t_bytes = nbytes / HBM_BW * 1e3
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rows[name] = kernel_row(
            torch, "flash_attention",
            lambda: FA.flash_attention(q, k, v, causal=causal),
            shape=f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} "
                  f"{'causal' if causal else 'non-causal'} {dt}",
            max_abs_err=err, tolerance=TOLERANCE[dt],
            plain_ms=time_ms(torch, lambda: FA.flash_attention_plain(
                q, k, v, causal=causal), **plain_iters),
            library_ms=time_ms(torch, lambda: sdpa(
                qt, kt, vt, is_causal=causal, enable_gqa=True)),
            library="scaled_dot_product_attention(enable_gqa=True)",
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    emit({"kernel_check": "flash_attention", "cases": len(FLASH_CASES),
          "max_abs_err": {n: r["max_abs_err"] for n, r in rows.items()}})
    return {"flash_attention": rows}


#: ssd_scan cases: name -> (B, S, H, P, N, chunk, dtype, init_state); the
#: reference's sweep (``tests/test_kernels.py::test_ssd_scan_sweep``) at
#: float32 and bfloat16, then mamba2-780m's prefill in the serving trial
#: (one 512-token prompt: 2 chunks of 256, 48 heads of 64, d_state 128),
#: from the zero state the model passes (timed) and from a random one
SSD_CASES = {
    **{f"sweep_{B}x{S}x{H}x{P}x{N}_q{q}_{dt}": (B, S, H, P, N, q, dt, False)
       for B, S, H, P, N, q in ((1, 64, 2, 8, 4, 16), (2, 128, 4, 16, 8, 32),
                                (1, 256, 2, 32, 16, 64))
       for dt in ("float32", "bfloat16")},
    "mamba_prefill_512": (1, 512, 48, 64, 128, 256, "bfloat16", "zeros"),
    "mamba_prefill_512_init": (1, 512, 48, 64, 128, 256, "bfloat16",
                               "random"),
    "mamba_prefill_512_f32": (1, 512, 48, 64, 128, 256, "float32",
                              "random"),
    # a 200-token prompt: Q = 200, three full 64-row tiles and a short one
    "mamba_prompt_200": (1, 200, 48, 64, 128, 256, "bfloat16", "random"),
    "mamba_prompt_200_f32": (1, 200, 48, 64, 128, 256, "float32", "random"),
    # jamba-v0.1-52b's Mamba layers: 128 heads of 64, d_state 16 (the
    # kernel's N <= 64 instantiation), one 512-token prompt (timed)
    "jamba_prefill_512": (1, 512, 128, 64, 16, 256, "bfloat16", "random"),
}
#: the cases timed (the first is the summary line's)
SSD_TIMED = ("mamba_prefill_512", "jamba_prefill_512")
#: the reference's SSD tolerances (rtol = atol): y in its dtype; the final
#: state is float32 in both
SSD_TOL = {"float32": 2e-3, "bfloat16": 5e-2}


def ssd_macs(S, H, P, N, Q) -> int:
    """Multiply-adds the chunked scan needs: per chunk C.B^T and the
    weighted product over the Q(Q+1)/2 (i, j <= i) pairs, and per head
    the carried state's term and the state update (Q N P each)."""
    pairs = Q * (Q + 1) // 2
    return S // Q * (pairs * N + H * (pairs * P + 2 * Q * N * P))


def ssd_stage_checks(torch, SS, args, q, st0, dt):
    """Each of the four launches of ``ssd_scan`` alone against its plain
    stage on the same inputs: a stage reads its inputs from the scratch,
    where the plain stages' results are put first.  The f32 scratch (C.B^T
    at and below the diagonal's tiles, cum, the chunk states) within 2e-3,
    y within ``SSD_TOL``.  Returns {stage: max abs error}."""
    xh, dts, A, Bm, Cm = args
    S, N = xh.shape[1], Bm.shape[-1]
    Q = min(q, S)
    cb_w = SS.chunk_cb_plain(Bm, Cm, Q)
    cum_w = SS.chunk_cum_plain(dts, A, Q)
    local_w = SS.chunk_state_plain(xh, dts, Bm, cum_w, Q)
    ins_w, final_w = SS.fold_plain(local_w, cum_w, st0)
    y_w = SS.output_plain(xh, dts, Cm, cb_w, cum_w, ins_w, Q)
    tiles = torch.arange(Q, device=xh.device) // 64
    below = tiles[None, :] <= tiles[:, None]        # the tiles computed
    work = SS.scratch(xh, N, Q)
    cb, cum, states = work
    y = torch.empty_like(xh)
    final = torch.empty_like(final_w)

    def run(stage):
        SS.launch_stages(stage, xh, dts, A, Bm, Cm, st0, y, final, work, Q)
        torch.cuda.synchronize()

    errs = {}
    run(SS.STAGE_CB)
    errs["cb"] = max_abs_err(torch, cb[..., :Q, :Q][..., below],
                             cb_w[..., below], "float32", 2e-3)
    run(SS.STAGE_STATE)
    errs["cum"] = max_abs_err(torch, cum, cum_w, "float32", 2e-3)
    errs["state"] = max_abs_err(torch, states, local_w, "float32", 2e-3)
    cum.copy_(cum_w)
    states.copy_(local_w)
    run(SS.STAGE_FOLD)
    errs["fold"] = max(max_abs_err(torch, states, ins_w, "float32", 2e-3),
                       max_abs_err(torch, final, final_w, "float32", 2e-3))
    cb[..., :Q, :Q].copy_(cb_w)
    states.copy_(ins_w)
    run(SS.STAGE_OUT)
    errs["out"] = max_abs_err(torch, y, y_w, dt, SSD_TOL[dt])
    return errs


def ssd_checks(torch, dev):
    """ssd_scan against its plain version on the card at every case of
    ``SSD_CASES``: each of its four launches alone against its plain
    stage (``ssd_stage_checks``), then the whole call, y within
    ``SSD_TOL`` and the final state within 2e-3.  The two prefill cases
    (``SSD_TIMED``: mamba2-780m's and jamba-v0.1-52b's) are timed: CUDA
    events, the profiler's kernel time, the plain version (no
    single PyTorch call computes the scan: no library time).  The bound is
    the larger of ``ssd_macs`` at the peak of the route's arithmetic (bf16
    on the tensor cores, f32 off them) and the bytes of x, dt, A, B, C, y
    and the two states over the memory rate, for one batch row."""
    import torch.nn.functional as F

    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, errs = {}, {}
    for name, (B, S, H, P, N, q, dt, init) in SSD_CASES.items():
        dtype = getattr(torch, dt)
        xh = (torch.randn(B, S, H, P, generator=gen, device=dev) * 0.5
              ).to(dtype)
        dts = F.softplus(torch.randn(B, S, H, generator=gen, device=dev))
        A = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.3)
        Bm = (torch.randn(B, S, N, generator=gen, device=dev) * 0.5
              ).to(dtype)
        Cm = (torch.randn(B, S, N, generator=gen, device=dev) * 0.5
              ).to(dtype)
        st0 = None
        if init:
            st0 = torch.zeros(B, H, N, P, device=dev) if init == "zeros" \
                else torch.randn(B, H, N, P, generator=gen, device=dev)
        args = (xh, dts, A, Bm, Cm)
        try:
            stage_errs = ssd_stage_checks(torch, SS, args, q, st0, dt)
        except Failed as e:
            raise Failed(f"ssd_scan stage != plain stage ({name}): {e}")
        y, st = SS.ssd_scan(*args, chunk=q, init_state=st0)
        yw, stw = SS.ssd_scan_plain(*args, chunk=q, init_state=st0)
        torch.cuda.synchronize()
        try:
            err = max_abs_err(torch, y, yw, dt, SSD_TOL[dt])
            serr = max_abs_err(torch, st, stw, "float32", 2e-3)
        except Failed as e:
            raise Failed(f"ssd_scan != plain ({name}): {e}")
        check(y.dtype == dtype and st.dtype == torch.float32,
              f"ssd_scan ({name}): output dtypes {y.dtype}, {st.dtype}")
        errs[name] = {"y": err, "final_state": serr, "stages": stage_errs}
        if name not in SSD_TIMED:
            continue
        if name == KERNELS["ssd_scan"][2]:
            timed = (args, q, st0)
        Q = min(q, S)
        t_ops = 2 * B * ssd_macs(S, H, P, N, Q) / PEAK_FLOPS[dt] * 1e3
        nbytes = SS.work(*args, chunk=q, init_state=st0)[1]
        t_bytes = nbytes / HBM_BW * 1e3

        def scan(args=args, q=q, st0=st0):
            return SS.ssd_scan(*args, chunk=q, init_state=st0)
        rows[name] = kernel_row(
            torch, "ssd_scan", scan,
            # each launch's own device time (one trace each)
            stage_device_ms={st: device_times(
                torch, scan, (f"ssd_scan_kernel_{st}",))["kernel_device_ms"]
                for st in ("cb", "state", "fold", "out")},
            shape=f"B={B} S={S} H={H} P={P} N={N} Q={Q} {dt}, "
                  f"{init} init_state, final state out",
            max_abs_err=err, final_state_max_abs_err=serr,
            stage_max_abs_err=stage_errs, tolerance=SSD_TOL[dt],
            plain_ms=time_ms(torch, lambda args=args, q=q, st0=st0:
                             SS.ssd_scan_plain(*args, chunk=q,
                                               init_state=st0),
                             iters=20, warm=3),
            library_ms=None, library="none (no one call)",
            macs=B * ssd_macs(S, H, P, N, Q), bytes=nbytes,
            ops_ms=t_ops, bytes_ms=t_bytes, peak=dt,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    emit({"kernel_check": "ssd_scan", "cases": len(SSD_CASES),
          "max_abs_err": errs})
    emit({"host_split": "ssd_scan",
          "shape": rows[KERNELS["ssd_scan"][2]]["shape"],
          "ns_per_call": ssd_host_split(torch, SS, *timed)})
    return {"ssd_scan": rows}


def ssd_host_split(torch, SS, args, q, st0, calls=1000):
    """Host time of one ``ssd_scan`` call at the prefill shape, by part:
    the argument checks, the two output allocations, the scratch's one
    allocation, the C call (its four launches) and the whole wrapper."""
    xh, dts, A, Bm, Cm = args
    Bsz, S, H, P = xh.shape
    N, Q = Bm.shape[-1], min(q, S)
    starts, _, total = SS._layout(Bsz, S, H, P, N, Q)
    y = torch.empty_like(xh)
    st = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=xh.device)
    work = torch.empty(total, dtype=torch.float32, device=xh.device)
    ptrs = [work.data_ptr() + 4 * a for a in starts]
    parts = {
        "checks": lambda: SS._check(*args, st0),
        "outputs_alloc": lambda: (torch.empty_like(xh), torch.empty(
            (Bsz, H, N, P), dtype=torch.float32, device=xh.device)),
        "scratch_alloc": lambda: torch.empty(total, dtype=torch.float32,
                                             device=xh.device),
        "c_call_four_launches": lambda: SS._launch(
            SS.ALL_STAGES, *args, st0, y, st, ptrs, Q),
        "wrapper": lambda: SS.ssd_scan(*args, chunk=q, init_state=st0),
    }
    return run_split(torch, parts, calls)


#: the gradient checks' extra case: mamba2-780m's training shape (4 x 512
#: tokens, no state), where the backward's peak memory is recorded
SSD_TRAIN_CASE = {"mamba_train_4x512": (4, 512, 48, 64, 128, 256,
                                        "bfloat16", None)}


def ssd_grad_checks(torch, dev):
    """The scan's gradient on the card: ``models.mamba.ssd_chunk_scan`` on
    inputs that require grad goes through ``SSDScanFn`` (one ``ssd_scan``
    launch forward; ``ssd_scan_bwd`` backward: the kernel for bf16, the
    plain scan's gradient, recomputed, for f32).  At
    every case of ``SSD_CASES`` (the short tile Q = 200 included) and at
    the training shape, its y and final state, and the gradients of a
    seeded <w_y, y> + <w_s, final state> for xh, dt, A, B_, C_ and
    init_state, against autograd straight through ``ssd_scan_plain`` on
    the card over float32 copies of the inputs, each gradient rounded to
    its input's dtype once, within ``SSD_TOL`` by xh's dtype (rtol =
    atol); each of the Function's gradients in its input's dtype.  The
    bare wrapper must still refuse an input that requires grad.  Records, at the training shape, the
    backward's peak memory above what was allocated before it."""
    import torch.nn.functional as F

    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import mamba

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    errs, train = {}, {}
    for name, (B, S, H, P, N, q, dt, init) in {**SSD_CASES,
                                               **SSD_TRAIN_CASE}.items():
        dtype = getattr(torch, dt)
        xh = (torch.randn(B, S, H, P, generator=gen, device=dev) * 0.5
              ).to(dtype)
        dts = F.softplus(torch.randn(B, S, H, generator=gen, device=dev))
        A = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.3)
        Bm = (torch.randn(B, S, N, generator=gen, device=dev) * 0.5
              ).to(dtype)
        Cm = (torch.randn(B, S, N, generator=gen, device=dev) * 0.5
              ).to(dtype)
        st0 = None
        if init:
            st0 = torch.zeros(B, H, N, P, device=dev) if init == "zeros" \
                else torch.randn(B, H, N, P, generator=gen, device=dev)
        wy = torch.randn(B, S, H, P, generator=gen, device=dev)
        ws = torch.randn(B, H, N, P, generator=gen, device=dev)
        base = [t for t in (xh, dts, A, Bm, Cm, st0) if t is not None]
        runs = {}
        for route in ("function", "plain"):
            # the plain route differentiates over float32 copies of the
            # leaves and rounds each gradient to its input's dtype once,
            # as the kernel does: autograd through bf16 leaves rounds
            # each use's gradient to bf16 before adding the uses, and at
            # a cancelling element that lies further from the float32
            # sum than the tolerance (one read 0.0 against 0.109)
            leaves = [t.clone().requires_grad_() if route == "function"
                      else t.detach().float().requires_grad_()
                      for t in base]
            args = leaves[:5]
            init_leaf = leaves[5] if init else None
            torch.cuda.synchronize()
            before = SS.launches.value
            if route == "function":
                y, st = mamba.ssd_chunk_scan(*args, chunk=q,
                                             init_state=init_leaf)
                check(SS.launches.value == before + 1 and
                      type(y.grad_fn).__name__ == "SSDScanFnBackward",
                      f"{name}: ssd_chunk_scan did not run SSDScanFn")
            else:
                y, st = SS.ssd_scan_plain(*args, chunk=q,
                                          init_state=init_leaf)
            loss = (y.to(dtype).float() * wy).sum() + (st * ws).sum()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            if name in SSD_TRAIN_CASE:
                train[route] = {
                    "backward_s": time.perf_counter() - t0,
                    "backward_peak_bytes_above_held":
                        torch.cuda.max_memory_allocated() - held}
            if route == "function":
                check(all(g.dtype == t.dtype for g, t in zip(grads, base)),
                      f"{name}: a gradient is not in its input's dtype")
            else:
                grads = tuple(g.to(t.dtype) for g, t in zip(grads, base))
            runs[route] = (y.to(dtype), st) + tuple(grads)
            del loss
        labels = ("y", "final_state", "d_xh", "d_dt", "d_A", "d_B", "d_C",
                  "d_init_state")
        try:
            errs[name] = {n: max_abs_err(torch, a, b, dt, SSD_TOL[dt])
                          for n, a, b in zip(labels, runs["function"],
                                             runs["plain"])}
        except Failed as e:
            raise Failed(f"ssd_scan gradient != plain autograd ({name}): "
                         f"{e}")
        del runs
    x = torch.zeros(1, 32, 2, 8, device=dev, requires_grad=True)
    dt1 = torch.ones(1, 32, 2, device=dev)
    bc = torch.zeros(1, 32, 4, device=dev)
    refused = False
    try:
        SS.ssd_scan(x, dt1, -dt1[0, 0], bc, bc, chunk=16)
    except RuntimeError as e:
        refused = "requires grad" in str(e)
    check(refused, "the bare CUDA ssd_scan wrapper accepted an input that "
                   "requires grad")
    row = {"ssd_grad_check": "SSDScanFn vs plain autograd",
           "cases": len(errs), "tolerance": SSD_TOL, "max_abs_err": errs,
           "train_shape": {"case": next(iter(SSD_TRAIN_CASE)), **train},
           "bare_wrapper_refuses_grad": True}
    emit(row)
    free_card(torch)
    return row


#: ssd_scan_bwd cases: name -> (B, S, H, P, N, chunk, init_state, dfinal,
#: dt scale); the sweep's shapes and the short tile (Q = 200) at bf16,
#: mamba2-780m's training shape at one row of 512 and at train_U's 4 x
#: 2048 (both timed), jamba-v0.1-52b's heads (128 of 64, d_state 16: the
#: N <= 64 instantiation; timed), and a steep decay (dt * A near -40 a row)
SSD_BWD_CASES = {
    "sweep_1x64x2x8x4_q16": (1, 64, 2, 8, 4, 16, False, True, 1.0),
    "sweep_2x128x4x16x8_q32": (2, 128, 4, 16, 8, 32, True, True, 1.0),
    "sweep_1x256x2x32x16_q64": (1, 256, 2, 32, 16, 64, True, False, 1.0),
    "mamba_prompt_200": (1, 400, 48, 64, 128, 200, True, True, 1.0),
    "steep_1x256x4x64x128": (1, 256, 4, 64, 128, 256, True, True, 40.0),
    "mamba_train_1x512": (1, 512, 48, 64, 128, 256, False, False, 1.0),
    "mamba_train_4x2048": (4, 2048, 48, 64, 128, 256, False, False, 1.0),
    "jamba_train_2x2048": (2, 2048, 128, 64, 16, 256, False, False, 1.0),
}
SSD_BWD_TIMED = ("mamba_train_4x2048", "mamba_train_1x512",
                 "jamba_train_2x2048")
#: the backward's launches, by their __global__ names
SSD_BWD_LAUNCHES = ("ssd_bwd_dstate", "ssd_bwd_fold", "ssd_bwd_dx",
                    "ssd_bwd_dbc", "ssd_bwd_dt")
#: the gradients' tolerance against the plain backward on the card, as a
#: share of the largest |element| of the plain gradient (bf16 dx, dB, dC:
#: both sides round the f32 sum to bf16 once, 2^-8 of the element at most;
#: f32 ddt, dA, dinit: the kernel's split products, ~2^-16 a term, and
#: another order of summation)
SSD_BWD_TOL = {"dx": 2 ** -7, "ddt": 1e-3, "dA": 1e-3, "dB": 2 ** -7,
               "dC": 2 ** -7, "dinit": 1e-3}
#: dA's at the steep decay: its terms cancel to ~1e-3 of their size there,
#: and the plain backward's own f32 dA lies 9.2e-4 of its largest element
#: from a float64 evaluation (on the CPU; the kernel's staged plain
#: version 9.3e-6)
SSD_BWD_STEEP_TOL = {"dA": 1e-2}


def ssd_bwd_inputs(torch, gen, dev, B, S, H, P, N, init, dfin, scale):
    """Seeded bf16 inputs of the backward: xh, dt, A, B_, C_, init_state,
    dy, dfinal (the last three None where not asked for)."""
    import torch.nn.functional as F

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    xh = (rn(B, S, H, P) * 0.5).bfloat16()
    dts = F.softplus(rn(B, S, H)) * scale
    A = -torch.exp(rn(H) * 0.3)
    Bm, Cm = (rn(B, S, N) * 0.5).bfloat16(), (rn(B, S, N) * 0.5).bfloat16()
    st0 = rn(B, H, N, P) if init else None
    dy = rn(B, S, H, P).bfloat16()
    df = rn(B, H, N, P) if dfin else None
    return xh, dts, A, Bm, Cm, st0, dy, df


def _rel_err(torch, got, want):
    """max |got - want| over max |want| (0 for an all-zero want); fails on
    a non-finite element."""
    g, w = got.detach().float(), want.detach().float()
    check(bool(torch.isfinite(g).all()), "non-finite values")
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def ssd_bwd_stage_errs(torch, SS, args, q, saved):
    """The backward's five launches in one call, their scratch held
    against the plain stages over the plain forward: the state gradient
    after the fold (g), the fold's sums (sig), r, rd, dw, u (its partials
    summed) and v, each as ``_rel_err``."""
    xh, dts, A, Bm, Cm, st0, dy, df = args
    Q = min(q, xh.shape[1])
    N = Bm.shape[-1]
    cum = SS.chunk_cum_plain(dts, A, Q)
    state_in, _ = SS.fold_plain(SS.chunk_state_plain(xh, dts, Bm, cum, Q),
                                cum, st0)
    g, sig, _ = SS.bwd_fold_plain(SS.bwd_dstate_plain(dy, Cm, cum, Q), cum,
                                  state_in, df)
    _, r, rd, dw, u = SS.bwd_dx_plain(xh, dts, Bm, dy,
                                      SS.chunk_cb_plain(Bm, Cm, Q), cum, g,
                                      Q)
    _, _, v = SS.bwd_dbc_plain(xh, dts, Bm, Cm, dy, cum, state_in, g, Q)
    parts = SS.bwd_scratch(xh, N, Q)
    outs = tuple(None if t is None else torch.empty_like(t)
                 for t in (xh, dts, A, Bm, Cm, st0))
    SS.launch_bwd(xh, dts, A, Bm, Cm, dy, df, saved, outs, parts, Q)
    torch.cuda.synchronize()
    gk, sigk, uk, rk, rdk, dwk, vk = parts
    nt = uk.shape[3]
    tile = torch.arange(uk.shape[4], device=xh.device) // 64
    written = torch.arange(nt, device=xh.device)[:, None] <= tile[None, :]
    uk = torch.where(written, uk, 0.).sum(3)[..., :Q]
    return {n: _rel_err(torch, a, b) for n, a, b in (
        ("g", gk, g), ("sig", sigk.sum(-1), sig), ("r", rk, r),
        ("rd", rdk, rd), ("dw", dwk, dw), ("u", uk, u), ("v", vk, v))}


def ssd_bwd_checks(torch, dev):
    """ssd_scan_bwd (the backward kernel) on the card at every case of
    ``SSD_BWD_CASES``: each gradient against the plain backward
    (``ssd_scan_bwd_plain``, autograd through the plain scan) within
    ``SSD_BWD_TOL``; the launches' scratch against the plain stages
    (``ssd_bwd_stage_errs``); two calls equal bit for bit (no atomics).
    The ``SSD_BWD_TIMED`` cases are timed: CUDA events, the profiler's
    kernel time in all and by launch, the plain backward; the bound is the
    larger of ``bwd_work``'s flops at the bf16 peak and its bytes over
    the memory rate."""
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    names = ("dx", "ddt", "dA", "dB", "dC", "dinit")
    rows, errs = {}, {}
    for name, (B, S, H, P, N, q, init, dfin, scale) in \
            SSD_BWD_CASES.items():
        args = ssd_bwd_inputs(torch, gen, dev, B, S, H, P, N, init, dfin,
                              scale)
        xh, dts, A, Bm, Cm, st0, dy, df = args
        with torch.no_grad():
            _, _, saved = SS.ssd_scan(xh, dts, A, Bm, Cm, chunk=q,
                                      init_state=st0, want_state=False,
                                      keep_scratch=True)
        before = SS.bwd_launches.value
        got = SS.ssd_scan_bwd(*args, chunk=q, saved=saved)
        again = SS.ssd_scan_bwd(*args, chunk=q, saved=saved)
        want = SS.ssd_scan_bwd_plain(*args, chunk=q)
        torch.cuda.synchronize()
        check(SS.bwd_launches.value == before + 2,
              f"ssd_scan_bwd ({name}): {SS.bwd_launches.value - before} "
              "launches for 2 calls")
        case = {}
        for n, a, b, c in zip(names, got, want, again):
            if b is None:
                continue
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"ssd_scan_bwd ({name}): {n} is {a.dtype} "
                  f"{tuple(a.shape)}, the plain {b.dtype} {tuple(b.shape)}")
            check(equal(torch, a, c),
                  f"ssd_scan_bwd ({name}): {n} differs between two calls")
            case[n] = _rel_err(torch, a, b)
        case["stages"] = ssd_bwd_stage_errs(torch, SS, args, q, saved)
        errs[name] = case
        emit({"ssd_bwd_case": name, **case})
        tol = dict(SSD_BWD_TOL, **(SSD_BWD_STEEP_TOL if scale > 1 else {}))
        for n, e in case.items():
            if n != "stages":
                check(e <= tol[n],
                      f"ssd_scan_bwd ({name}): {n} off the plain backward "
                      f"by {e} of its largest element")
        if name not in SSD_BWD_TIMED:
            del args, saved, got, again, want
            continue
        flops, nbytes = SS.bwd_work(*args, chunk=q)
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_BW * 1e3

        def bwd(args=args, q=q, saved=saved):
            return SS.ssd_scan_bwd(*args, chunk=q, saved=saved)
        del got, again, want
        plain_ms = time_ms(torch, lambda args=args, q=q:
                           SS.ssd_scan_bwd_plain(*args, chunk=q),
                           iters=5, warm=1)
        rows[name] = kernel_row(
            torch, "ssd_scan_bwd", bwd, iters=50,
            launch_device_ms={k: device_times(torch, bwd, (k,), iters=20)[
                "kernel_device_ms"] for k in SSD_BWD_LAUNCHES},
            shape=f"B={B} S={S} H={H} P={P} N={N} Q={min(q, S)} bf16",
            max_rel_err=case, tolerance=SSD_BWD_TOL, plain_ms=plain_ms,
            library_ms=None, library="none (no one call)", flops=flops,
            bytes=nbytes, ops_ms=t_ops, bytes_ms=t_bytes,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        emit({"ssd_bwd_row": name, **rows[name]})
        del args, saved
        free_card(torch)
    emit({"kernel_check": "ssd_scan_bwd", "cases": len(SSD_BWD_CASES),
          "max_rel_err": errs})
    return {"ssd_scan_bwd": rows}


#: fused_adamw cases: name -> (shape, p dtype, g dtype, ring slots); the
#: reference's sweep (``tests/test_kernels.py::test_fused_adamw_sweep``),
#: a ragged n, n = 0, a bf16 gradient and qwen2.5-3b's largest leaf (the
#: stacked FFN weight, 811,597,824 elements), timed
ADAMW_CASES = {
    **{f"sweep_{'x'.join(map(str, shape))}_{'ring' if r else 'noring'}_"
       f"{dt}": (shape, dt, "float32", 3 if r else 0)
       for shape in ((64,), (24, 16), (3, 5, 8)) for r in (True, False)
       for dt in ("float32", "bfloat16")},
    "ragged_bf16": ((1_000_003,), "bfloat16", "float32", 2),
    "empty": ((0,), "float32", "float32", 2),
    "bf16_grad": ((4096, 300), "bfloat16", "bfloat16", 2),
    "ffn_leaf": ((36, 2048, 11008), "bfloat16", "bfloat16", 2),
}
#: p and ring by p's dtype; the moments 1e-5 (tests/test_kernels.py)
ADAMW_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
ADAMW_KW = dict(b1=0.9, b2=0.95, eps=1e-8)


def adamw_checks(torch, dev):
    """fused_adamw against its plain version on the card at every case of
    ``ADAMW_CASES`` (slot 2 of 3 or 1 of 2; lr 3e-3, scale 0.7, step 3;
    weight decay 0.1 on leaves of 2 or more dims); the FFN leaf then
    timed: CUDA events, the profiler's kernel time, the plain version and
    ``torch._fused_adamw_`` (the library yardstick, never called by the
    port: it writes no ring and takes one dtype per group, so its
    moments are bf16 here).  The bound is bytes."""
    from repro_torch.kernels import fused_adamw as FA
    from repro_torch.launch.roofline import HBM_BW

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs, bitwise, rows = {}, {}, {}
    scalars = torch.tensor([3e-3, 0.7, 1 - 0.9 ** 3, 1 - 0.95 ** 3],
                           dtype=torch.float32, device=dev)
    for name, (shape, pdt, gdt, slots) in ADAMW_CASES.items():
        def randn(scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale
        p = randn().to(getattr(torch, pdt))
        g = randn().to(getattr(torch, gdt))
        m, v = randn(0.1), randn().abs_() * 0.01
        ring = (torch.zeros((slots,) + shape, dtype=p.dtype, device=dev)
                if slots else None)
        slot = slots - 1 if slots else 0
        kw = dict(ADAMW_KW, wd=0.1 if len(shape) >= 2 else 0.0)
        outs = {}
        for route in ("kernel", "plain"):
            mm, vv = m.clone(), v.clone()
            rr = ring.clone() if ring is not None else None
            fn = FA.fused_adamw if route == "kernel" else FA.fused_adamw_plain
            outs[route] = (fn(p, g, mm, vv, rr, slot, scalars, **kw), mm, vv,
                           rr)
        torch.cuda.synchronize()
        (pk, mk, vk, rk), (pp, mp, vp, rp) = outs["kernel"], outs["plain"]
        err = {}
        try:
            check(pk.dtype == p.dtype and pk.shape == p.shape,
                  "p' has the wrong dtype or shape")
            if p.numel():
                err = {"p": max_abs_err(torch, pk, pp, pdt, ADAMW_TOL[pdt]),
                       "m": max_abs_err(torch, mk, mp, "float32", 1e-5),
                       "v": max_abs_err(torch, vk, vp, "float32", 1e-5)}
            if ring is not None and p.numel():
                err["ring"] = max_abs_err(torch, rk, rp, pdt,
                                          ADAMW_TOL[pdt])
                check(bool((rk[:slot] == 0).all()),
                      "a ring slot other than the chosen one was written")
        except Failed as e:
            raise Failed(f"fused_adamw != plain ({name}): {e}")
        errs[name] = max(err.values(), default=0.0)
        bitwise[name] = all(
            equal(torch, a, b) for a, b in zip((pk, mk, vk, rk),
                                               (pp, mp, vp, rp))
            if a is not None)
        if name == KERNELS["fused_adamw"][2]:
            del outs, pk, mk, vk, rk, pp, mp, vp, rp
            mm, vv, rr = m.clone(), v.clone(), ring.clone()
            lib = [p.clone()], [g], [m.to(p.dtype)], [v.to(p.dtype)]
            steps = [torch.tensor(3.0, device=dev)]
            t_bytes = FA.work(p, g, mm, vv, rr, slot, scalars)[1] \
                / HBM_BW * 1e3
            rows[name] = kernel_row(
                torch, "fused_adamw",
                lambda: FA.fused_adamw(p, g, mm, vv, rr, slot, scalars, **kw),
                iters=20, shape=f"{'x'.join(map(str, shape))} {pdt} p, "
                                f"{gdt} g, f32 m/v, ring R={slots}",
                max_abs_err=errs[name], tolerance=ADAMW_TOL[pdt],
                bit_identical=bitwise[name],
                plain_ms=time_ms(torch, lambda: FA.fused_adamw_plain(
                    p, g, mm, vv, rr, slot, scalars, **kw), iters=3, warm=1),
                library_ms=time_ms(torch, lambda: torch._fused_adamw_(
                    *lib, [], steps, lr=3e-3, beta1=0.9, beta2=0.95,
                    weight_decay=0.1, eps=1e-8, amsgrad=False,
                    maximize=False), iters=20, warm=2),
                library="torch._fused_adamw_ (bf16 moments, no ring)",
                bound_ms=t_bytes, bound_by="bytes")
            del lib, mm, vv, rr
        del p, g, m, v, ring
        free_card(torch)
    emit({"kernel_check": "fused_adamw", "cases": len(ADAMW_CASES),
          "max_abs_err": errs, "bit_identical": bitwise})
    return {"fused_adamw": rows}


#: attention gradient cases: name -> (B, S, H, KV, D, causal, dtype)
ATTN_GRAD_CASES = {
    "qwen_s512_bf16": (1, 512, 16, 2, 128, True, "bfloat16"),
    "qwen_s512_f32": (1, 512, 16, 2, 128, True, "float32"),
    "ragged_gqa_f32": (2, 100, 6, 2, 40, True, "float32"),
}


def attention_grad_checks(torch, dev):
    """``models.attention.attention`` on inputs that require grad goes
    through ``FlashAttentionFn`` (one ``flash_attention`` launch, then
    the plain backward); its output and dq, dk, dv for a seeded output
    gradient against autograd through ``naive_attention`` on the card,
    within ``TOLERANCE``.  The bare CUDA wrapper must refuse the same
    inputs rather than return an output without a graph."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as ATT

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {}
    for name, (B, S, H, KV, D, causal, dt) in ATTN_GRAD_CASES.items():
        dtype = getattr(torch, dt)
        q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dtype)
        w = torch.randn(B, S, H, D, generator=gen, device=dev)
        runs = {}
        for route in ("function", "naive"):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            before = FA.launches.value
            if route == "function":
                o = ATT.attention(*leaves, causal=causal)
                check(FA.launches.value == before + 1 and
                      type(o.grad_fn).__name__ == "FlashAttentionFnBackward",
                      f"{name}: attention did not run FlashAttentionFn")
            else:
                o = ATT.naive_attention(*leaves, causal=causal)
            grads = torch.autograd.grad((o.float() * w).sum(), leaves)
            runs[route] = (o,) + tuple(grads)
        try:
            errs[name] = {n: max_abs_err(torch, a, b, dt)
                          for n, a, b in zip(("o", "dq", "dk", "dv"),
                                             runs["function"],
                                             runs["naive"])}
        except Failed as e:
            raise Failed(f"attention gradient != naive autograd ({name}): "
                         f"{e}")
        refused = False
        try:
            FA.flash_attention(q.clone().requires_grad_(), k, v,
                               causal=causal)
        except RuntimeError as e:
            refused = "requires grad" in str(e)
        check(refused, f"{name}: the bare CUDA flash_attention wrapper "
                       "accepted an input that requires grad")
    emit({"attention_grad_check": "FlashAttentionFn vs naive autograd",
          "cases": len(ATTN_GRAD_CASES), "max_abs_err": errs,
          "bare_wrapper_refuses_grad": True})


# ---------------------------------------------------------------------------
# phase 3: the same schedule on the card and on the CPU
# ---------------------------------------------------------------------------


def run_schedule(make_tm, AbortTx, device, seed, forced_mode=None,
                 steps=400, region=600, backend="multiverse"):
    """Two tids' transactions interleaved from one thread: a scan reads
    ``region`` words in chunks, one chunk per step, while the other tid
    commits point transfers or block rotations between its chunks (each
    update runs whole inside one step, so no lock is ever held across a
    step and no reader can spin on the other tid).  Aborts restart the
    operation.  Returns ``(trace, raw stats, tm)``."""
    from repro_torch.configs.paper_stm import MultiverseParams

    params = MultiverseParams(k1=2, k2=6, k3=6, lock_table_bits=8)
    if backend == "multiverse":
        tm = make_tm(backend, 2, array_heap=True, start_bg=False,
                     device=device, forced_mode=forced_mode, params=params)
    elif backend == "mvstore":
        tm = make_tm(backend, 2, start_bg=False, device=device,
                     ring_slots=4, params=params)
    else:
        tm = make_tm(backend, 2, array_heap=True, device=device,
                     params=params)
    base = tm.alloc(region, INITIAL)
    rng = random.Random(seed)
    trace, scan = [], {}

    def update(tid):
        tx = tm.begin(tid)
        try:
            if rng.random() < 0.5:
                i, j = rng.sample(range(region), 2)
                a, b = tx.read(base + i), tx.read(base + j)
                tx.write(base + i, a - AMOUNT)
                tx.write(base + j, b + AMOUNT)
                got = (int(a), int(b))
            else:
                off = base + 300 * rng.randrange(2)
                vals = [int(v) for v in tx.read_bulk(range(off, off + 300))]
                tx.write_bulk(np.arange(off, off + 300),
                              np.roll(np.asarray(vals, np.int64), 1))
                got = sum(vals)
            tm.commit(tx)
            trace.append((tid, "update", got))
        except AbortTx:
            tm.abort(tx)
            trace.append((tid, "update-abort"))

    for _ in range(steps):
        tid = rng.randrange(2)
        if tid not in scan and rng.random() < 0.5:
            tm.begin_operation(tid)
            update(tid)
            continue
        if tid not in scan:
            tm.begin_operation(tid)
            scan[tid] = None
        if scan[tid] is None:
            scan[tid] = [tm.begin(tid), 0, 0]
        tx, off, acc = scan[tid]
        try:
            if off == region:
                tm.commit(tx)
                trace.append((tid, "scan", acc))
                del scan[tid]
                continue
            vals = [int(v) for v in tx.read_bulk(
                range(base + off, base + off + 100))]
            scan[tid] = [tx, off + 100, acc + sum(vals)]
            trace.append((tid, "chunk", sum(vals)))
        except AbortTx:
            tm.abort(tx)
            scan[tid] = None
            trace.append((tid, "scan-abort"))
    for st in scan.values():
        if st is not None:
            tm.abort(st[0])
    stats = tm.stats() if backend == "mvstore" else tm.raw.stats()
    tm.stop()
    return trace, stats, tm


def _state(tm):
    """The array state of a word backend or of the MVStore, as numpy."""
    from repro_torch.api import dump_numpy_state

    if getattr(tm, "name", "") != "mvstore":
        return dump_numpy_state(tm)
    st = tm.state
    out = {"clock": st.clock, "block_clocks": sorted(
        st.block_clocks.items()), "heap": st.live["heap"].cpu().numpy()}
    for k in st.ring:
        out["ring" + k] = st.ring[k].cpu().numpy()
        out["ring_ts" + k] = st.ring_ts[k].cpu().numpy()
    return out


def schedule_check(torch):
    from repro_torch.api import AbortTx, make_tm

    runs = [("multiverse", 0, "U"), ("multiverse", 1, None),
            ("multiverse", 2, "Q")]
    runs += [(b, 3, None) for b in BACKENDS[1:]]
    for backend, seed, mode in runs:
        out = {}
        for device in ("cuda", "cpu"):
            trace, stats, tm = run_schedule(make_tm, AbortTx, device, seed,
                                            mode, backend=backend)
            out[device] = (trace, stats, _state(tm))
        (tg, sg, dg), (tc, sc, dc) = out["cuda"], out["cpu"]
        what = f"schedule {backend} seed {seed}"
        check(tg == tc, f"{what}: traces differ")
        check(sg == sc, f"{what}: stats differ {sg} {sc}")
        check(set(dg) == set(dc), f"{what}: state keys differ")
        for k in dc:
            check(np.array_equal(np.asarray(dg[k]), np.asarray(dc[k])),
                  f"{what}: {k} differs")
        emit({"schedule": seed, "backend": backend, "forced_mode": mode,
              "steps": len(tg), "aborts": sg["aborts"],
              "commits": sg["commits"],
              "version_gather_hits": sg.get("version_gather_hits"),
              "cuda_equals_cpu": True})


# ---------------------------------------------------------------------------
# phase 4: the main path in threads
# ---------------------------------------------------------------------------


class _Stopped(Exception):
    """Raised inside a long transaction once the trial window closed."""


def run_trial(workers, duration_s, warmup_s=0.0, done=None, probe=None,
              min_s=0.0):
    """Run ``workers[i](stop, counters[i])`` threads.  The window closes
    after ``duration_s`` — or earlier, once ``min_s`` has passed and
    ``done(totals)`` holds.
    Returns (counter deltas after the warmup, seconds measured); the
    violations count is the raw total.  A ``probe`` (a ``torch.profiler``
    run) is started and stopped with the window."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(2e-5)            # the eval's (eval/driver.py)
    stop = threading.Event()
    counters = [defaultdict(int) for _ in workers]
    errors = []

    def guard(w, c):
        try:
            w(stop, c)
        except BaseException as e:          # reported, fails the trial
            errors.append(repr(e))
            stop.set()

    threads = [threading.Thread(target=guard, args=(w, c), daemon=True)
               for w, c in zip(workers, counters)]
    try:
        for t in threads:
            t.start()
        time.sleep(warmup_s)
        baseline = [dict(c) for c in counters]
        if probe is not None:
            probe.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < duration_s and not stop.is_set():
            time.sleep(0.05)
            if (done is not None and time.perf_counter() - t0 >= min_s
                    and done(_totals(counters, baseline))):
                break
        dt = time.perf_counter() - t0
        if probe is not None:
            probe.stop()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=300)
        sys.setswitchinterval(old)
    check(not any(t.is_alive() for t in threads), "a worker did not stop")
    check(not errors, f"worker raised: {errors}")
    return _totals(counters, baseline), dt


def _totals(counters, baseline):
    total = defaultdict(int)
    for c, b in zip(counters, baseline):
        for k, v in list(c.items()):
            total[k] += v if k == "violations" else v - b.get(k, 0)
    return total


def _sum(vals):
    if hasattr(vals, "sum") and not isinstance(vals, list):
        return int(vals.sum())
    return sum(int(v) for v in vals)


def _make(backend, n_threads, params, **kw):
    """The trial's TM on the card: word backends on the int64 array
    heap (eval/workloads.py ``_make``), the MVStore on its int32 block."""
    from repro_torch.api import make_tm

    return make_tm(backend, n_threads, array_heap=True, params=params, **kw)


def longread_trial(torch, name, scan, lock_bits, duration_s, warmup_s,
                   forced_mode=None, min_scans=None, backend="multiverse",
                   probe=None):
    """1 scanner + 2 transfer updaters (eval/workloads.py longread).
    Multiverse must finish scans; the other backends must make progress
    in updates (an unversioned scan may starve: the paper's result)."""
    from repro_torch import kernels as K
    from repro_torch.api import MaxRetriesExceeded, run
    from repro_torch.configs.paper_stm import MultiverseParams

    chunk = 256
    kw = {"forced_mode": forced_mode} if forced_mode else {}
    tm = _make(backend, 3, MultiverseParams(k1=2, k2=3, k3=3,
                                            lock_table_bits=lock_bits), **kw)
    base = tm.alloc(scan, INITIAL)
    expected = scan * INITIAL
    done_at = []                 # perf_counter() of each completed scan

    def scanner(stop, c):
        def scan_tx(tx):
            # chunk sums accumulate on the card; one read at the end
            tot = 0
            for off in range(0, scan, chunk):
                if stop.is_set():
                    raise _Stopped()
                vals = tx.read_bulk(
                    range(base + off, base + min(off + chunk, scan)))
                tot = tot + (vals.sum() if isinstance(vals, torch.Tensor)
                             else sum(int(v) for v in vals))
            return int(tot)
        while not stop.is_set():
            try:
                tot = run(tm, scan_tx, tid=0, max_retries=60)
            except MaxRetriesExceeded:
                c["failed_scans"] += 1
                continue
            except _Stopped:
                return
            c["scans"] += 1
            done_at.append(time.perf_counter())
            if tot != expected:
                c["violations"] += 1

    def updater(tid):
        r = random.Random(SEED * 10007 + 100 + tid)

        def transfer(tx):
            i = r.randrange(scan)
            j = r.randrange(scan - 1)
            if j >= i:
                j += 1
            a = tx.read(base + i)
            b = tx.read(base + j)
            tx.write(base + i, a - AMOUNT)
            tx.write(base + j, b + AMOUNT)

        def work(stop, c):
            while not stop.is_set():
                try:
                    run(tm, transfer, tid=tid, max_retries=2000)
                    c["updates"] += 1
                except MaxRetriesExceeded:
                    c["failed_updates"] += 1
        return work

    done = None if min_scans is None else \
        (lambda tot: tot["scans"] >= min_scans)
    t_start = time.perf_counter()
    tot, dt = run_trial([scanner, updater(1), updater(2)], duration_s,
                        warmup_s, done, probe)
    window = K.launch_counts()
    per_chunk = chunk_launches(tm, base, min(scan, 16 * chunk), chunk)
    # multiverse's versioned path: a reader made versioned, as the
    # tests make one (the count scan runs alone, so none aborts into it)
    per_vchunk = (chunk_launches(tm, base, min(scan, 16 * chunk), chunk,
                                 versioned=True)
                  if backend == "multiverse" else None)
    final = run(tm, lambda tx: _sum(tx.read_bulk(range(base, base + scan))),
                tid=0)
    stats = tm.stats()
    tm.stop()
    check(final == expected, f"{name}: final region sum {final}")
    row = {"trial": name, "backend": backend, "scan_words": scan,
           "chunk": chunk, "lock_bits": lock_bits,
           "forced_mode": forced_mode,
           "seconds": dt, "scans": tot["scans"],
           "scans_per_s": tot["scans"] / dt,
           "failed_scans": tot["failed_scans"],
           "first_scan_s": done_at[0] - t_start if done_at else None,
           "updates_per_s": tot["updates"] / dt,
           "failed_updates": tot["failed_updates"],
           "violations": tot["violations"],
           "mode_transitions": stats["mode_transitions"],
           "final_mode": stats["mode"],
           "launches_per_chunk": per_chunk,
           "launches_per_versioned_chunk": per_vchunk,
           "window_launches": window}
    check(tot["updates"] > 0 and (tot["scans"] > 0
                                  or backend != "multiverse"),
          f"{name}: no progress ({dict(tot)})")
    if backend in LOCKVER_BACKENDS:
        check(per_chunk["gather_read"] == per_chunk["gather_bracketed"] == 1,
              f"{name}: a scanned chunk did not take one bracketed gather "
              f"({per_chunk})")
    if per_vchunk is not None:
        check(per_chunk["version_select"] == per_chunk["mirror_select"] == 0
              and per_vchunk == {"gather_read": 1, "gather_bracketed": 1,
                                 "version_select": 1, "mirror_select": 1,
                                 "validate": 0},
              f"{name}: a versioned chunk did not take one bracketed gather "
              f"and one mirror_select ({per_vchunk}; unversioned "
              f"{per_chunk})")
    return row


def chunk_launches(tm, base, words, chunk, versioned=False):
    """Kernel launches per scanned chunk: one read-only scan of ``words``
    words in ``chunk``-word ``read_bulk`` calls once the trial's workers
    have stopped, the launch counts read at the start and at the end of
    the transaction's body (the attempt that commits).  ``versioned``:
    the reader is made versioned first (multiverse's versioned read
    path)."""
    from repro_torch import kernels as K
    from repro_torch.api import run

    seen = {}

    def scan_tx(tx):
        if versioned:
            tx._ctx.versioned = True
        before = K.launch_counts()
        for off in range(0, words, chunk):
            tx.read_bulk(range(base + off, base + min(off + chunk, words)))
        after = K.launch_counts()
        seen.update({k: (after[k] - before[k]) for k in after})

    run(tm, scan_tx, tid=0)
    chunks = -(-words // chunk)
    return {k: v / chunks for k, v in seen.items()
            if k in ("gather_read", "gather_bracketed", "version_select",
                     "mirror_select", "validate")}


def revalidation_launches(tm, base, words):
    """Kernel launches per bulk revalidation: once the trial's workers
    have stopped, one transaction reads ``words`` words in one
    ``read_bulk`` and checks its read set (``Txn.validate_bulk``, the
    commit's revalidation), with the launch counts read around every
    bulk revalidation it makes.  Returns [{validate, gather_read}, ...],
    one entry per bulk revalidation."""
    from repro_torch import kernels as K
    from repro_torch.api import run
    from repro_torch.core.engine import validation as V

    inner, seen = V.revalidate_bulk, []

    def counted(*args):
        before = K.launch_counts()
        out = inner(*args)
        after = K.launch_counts()
        seen.append({k: after[k] - before[k]
                     for k in ("validate", "gather_read")})
        return out

    def body(tx):
        tx.read_bulk(range(base, base + words))
        check(tx.validate_bulk(), "a quiet read set failed validation")

    V.revalidate_bulk = counted
    try:
        run(tm, body, tid=0)
    finally:
        V.revalidate_bulk = inner
    return seen


def rwmix_trial(torch, name, wb, duration_s, warmup_s, backend="multiverse",
                probe=None):
    """2 block-rotation updaters + 1 checker (eval/workloads.py rwmix)."""
    from repro_torch.api import MaxRetriesExceeded, run
    from repro_torch.configs.paper_stm import MultiverseParams

    n_blocks, n_upd = 8, 2
    tm = _make(backend, 3, MultiverseParams(k1=30, k2=200, k3=200,
                                            lock_table_bits=16))
    base = tm.alloc(wb * n_blocks, INITIAL)
    block_sum = wb * INITIAL

    def updater(tid):
        r = random.Random(SEED * 10007 + 300 + tid)
        mine = [b for b in range(n_blocks) if b % n_upd == tid]

        def rotate(tx):
            off = base + wb * mine[r.randrange(len(mine))]
            vals = tx.read_bulk(range(off, off + wb))
            if isinstance(vals, list):
                vals = torch.tensor(vals, dtype=torch.int64)
            tx.write_bulk(range(off, off + wb), torch.roll(vals, 1))

        def work(stop, c):
            while not stop.is_set():
                try:
                    run(tm, rotate, tid=tid, max_retries=2000)
                    c["updates"] += 1
                except MaxRetriesExceeded:
                    c["failed_updates"] += 1
        return work

    def checker(stop, c):
        r = random.Random(SEED * 10007 + 900 + n_upd)

        def chk(tx):
            off = base + wb * r.randrange(n_blocks)
            return _sum(tx.read_bulk(range(off, off + wb)))
        while not stop.is_set():
            try:
                got = run(tm, chk, tid=n_upd, max_retries=2000)
                c["checks"] += 1
                if got != block_sum:
                    c["violations"] += 1
            except MaxRetriesExceeded:
                c["failed_checks"] += 1

    tot, dt = run_trial([updater(0), updater(1), checker], duration_s,
                        warmup_s, probe=probe)
    per_reval = (revalidation_launches(tm, base, wb)
                 if backend in LOCKVER_BACKENDS else None)
    final = run(tm, lambda tx: [_sum(tx.read_bulk(
        range(base + wb * b, base + wb * (b + 1)))) for b in range(n_blocks)],
        tid=0)
    stats = tm.stats()
    tm.stop()
    check(final == [block_sum] * n_blocks, f"{name}: final sums {final}")
    row = {"trial": name, "backend": backend, "write_words": wb,
           "n_blocks": n_blocks,
           "seconds": dt, "updates_per_s": tot["updates"] / dt,
           "failed_updates": tot["failed_updates"],
           "checks_per_s": tot["checks"] / dt,
           "failed_checks": tot["failed_checks"],
           "violations": tot["violations"],
           "mode_transitions": stats["mode_transitions"],
           "final_mode": stats["mode"],
           "launches_per_revalidation": per_reval}
    check(tot["updates"] > 0 and tot["checks"] > 0,
          f"{name}: no progress ({dict(tot)})")
    if per_reval is not None:
        check(per_reval and all(r == {"validate": 1, "gather_read": 0}
                                for r in per_reval),
              f"{name}: a bulk revalidation did not take one validate "
              f"launch and no gather ({per_reval})")
    return row


def group_trial(torch, name, backend, duration_s=6.0, warmup_s=1.0,
                probe=None, wal_dir=None, keep=None):
    """Group commit on a 1,000,000-word heap with the 2^16 lock table
    (eval/workloads.py durability, ``inmem-group``, at rwmix's 1024-word
    writes): 2 updaters each commit batches of 8 disjoint contiguous
    1024-word rotations through ``CommitBatcher``; 1 checker reads block
    sums.  With ``wal_dir`` (``durable-group``): a ``WriteAheadLog(
    group_sync=True)`` journals every group, and the window is run twice
    around a quiesced ``wal.checkpoint`` of the whole heap; ``keep``
    receives the final heap (one copy home), the clock and the log's
    counters."""
    from repro_torch.api import MaxRetriesExceeded, run
    from repro_torch.reliability.wal import WriteAheadLog, attach_wal
    from repro_torch.configs.paper_stm import MultiverseParams
    from repro_torch.core.engine.errors import AbortTx
    from repro_torch.core.engine.groupcommit import CommitBatcher

    heap_words, wb, n_blocks, n_upd = 1_000_000, 1024, 16, 2
    # member tids are the block ids; the checker sits above them
    tm = _make(backend, n_blocks + 1, MultiverseParams(
        k1=30, k2=200, k3=200, lock_table_bits=16))
    base = tm.alloc(heap_words, INITIAL)
    eng = tm.raw
    block_sum = wb * INITIAL

    def updater(worker):
        mine = [b for b in range(n_blocks) if b % n_upd == worker]

        def work(stop, c):
            batcher = CommitBatcher(eng)
            while not stop.is_set():
                txs = []
                for b in mine:
                    off = base + wb * b
                    for _attempt in range(4):
                        tx = eng.begin(b)
                        try:
                            vals = tx.read_bulk(range(off, off + wb))
                            vals = torch.as_tensor(vals, dtype=torch.int64)
                            tx.write_bulk(range(off, off + wb),
                                          torch.roll(vals, 1))
                            txs.append(tx)
                            break
                        except AbortTx:
                            continue
                for tx in txs:
                    batcher.add(tx)
                ok = batcher.commit_all()
                c["updates"] += sum(ok)
                c["failed_updates"] += len(ok) - sum(ok)
                c["batches"] += 1
            c["groups"] = batcher.stats["groups"]
            c["grouped_members"] = batcher.stats["grouped"]
        return work

    def checker(stop, c):
        r = random.Random(SEED * 10007 + 900)

        def chk(tx):
            off = base + wb * r.randrange(n_blocks)
            return _sum(tx.read_bulk(range(off, off + wb)))
        while not stop.is_set():
            try:
                got = run(tm, chk, tid=n_blocks, max_retries=2000)
                c["checks"] += 1
                if got != block_sum:
                    c["violations"] += 1
            except MaxRetriesExceeded:
                c["failed_checks"] += 1

    workers = [updater(0), updater(1), checker]
    wal = None
    if wal_dir is None:
        tot, dt = run_trial(workers, duration_s, warmup_s, probe=probe)
    else:
        wal = attach_wal(tm, WriteAheadLog(wal_dir, group_sync=True))
        tot, dt = run_trial(workers, duration_s, warmup_s)
        t0 = time.perf_counter()
        wal.checkpoint(eng.heap.live(), eng.clock.load())  # quiesced
        keep["checkpoint_s"] = time.perf_counter() - t0
        tot2, dt2 = run_trial(workers, duration_s, warmup_s)
        for k, v in tot2.items():
            tot[k] += v
        dt += dt2
    final = run(tm, lambda tx: [_sum(tx.read_bulk(
        range(base + wb * b, base + wb * (b + 1)))) for b in range(n_blocks)],
        tid=n_blocks)
    groups = tot["groups"]
    if wal is not None:
        keep.update(heap=eng.heap.live().cpu().numpy(),
                    clock=eng.clock.load(), wal_stats=wal.stats(),
                    sums=[(base + wb * b, wb, block_sum)
                          for b in range(n_blocks)])
        wal.close()
        eng.wal = None
    tm.stop()
    check(final == [block_sum] * n_blocks, f"{name}: final sums {final}")
    row = {"trial": name, "backend": backend, "heap_words": heap_words,
           "write_words": wb, "n_blocks": n_blocks, "batch": n_blocks // 2,
           "seconds": dt, "updates_per_s": tot["updates"] / dt,
           "failed_updates": tot["failed_updates"],
           "groups": groups, "grouped_members": tot["grouped_members"],
           "checks_per_s": tot["checks"] / dt,
           "failed_checks": tot["failed_checks"],
           "violations": tot["violations"]}
    check(groups > 0 and tot["updates"] > 0 and tot["checks"] > 0,
          f"{name}: no progress ({dict(tot)})")
    return row


def mvstore_trial(torch, name, duration_s=6.0, warmup_s=1.0, probe=None,
                  wal_dir=None, keep=None):
    """The MVStore on a 1,000,000-word int32 block, every block versioned,
    an 8-slot ring: 2 updaters commit 2-word transfers (each publish one
    ``commit_fused`` launch, out of place, plus the ring refresh) and 1
    scanner reads the whole block at the current or a past clock, in
    turn with ``snapshot_bulk`` and with ``snapshot`` (``mv_snapshot``,
    the trainer snapshot's call: one ``snapshot_select`` launch).
    Afterwards every clock of the ring window resolves through
    ``snapshot`` and must equal the plain ``snapshot_select`` on the same
    ring and ``snapshot_bulk``.  With ``wal_dir`` a ``WriteAheadLog(
    group_sync=True)`` journals every publish and ``keep`` receives the
    final block (one copy home), the clock and the log's counters."""
    from repro_torch.api import MaxRetriesExceeded, run
    from repro_torch.configs.paper_stm import MultiverseParams
    from repro_torch.kernels import snapshot_select as SS
    from repro_torch.reliability.wal import WriteAheadLog, attach_wal

    words, R = 1_000_000, 8
    h = _make("mvstore", 3, MultiverseParams(k1=2, k2=3, k3=3),
              versioned="all", ring_slots=R)
    base = h.alloc(words, INITIAL)
    expected = words * INITIAL
    addrs = np.arange(base, base + words, dtype=np.int64)
    wal = (None if wal_dir is None
           else attach_wal(h, WriteAheadLog(wal_dir, group_sync=True)))

    def scanner(stop, c):
        r = random.Random(SEED * 10007 + 7)
        whole = False
        while not stop.is_set():
            rc = max(0, h.clock - r.randrange(R))
            whole = not whole
            if whole:
                view, ok = h.snapshot(rc)
                ok = bool(ok)
                vals = view["heap"][base:base + words] if ok else None
            else:
                vals, ok = h.snapshot_bulk(addrs, rc)
            if not ok:
                c["stale_scans"] += 1
                continue
            c["scans"] += 1
            c["snapshot_scans"] += whole
            if _sum(vals) != expected:
                c["violations"] += 1

    def updater(tid):
        r = random.Random(SEED * 10007 + 100 + tid)

        def transfer(tx):
            i = r.randrange(words)
            j = r.randrange(words - 1)
            if j >= i:
                j += 1
            a = tx.read(base + i)
            b = tx.read(base + j)
            tx.write(base + i, a - AMOUNT)
            tx.write(base + j, b + AMOUNT)

        def work(stop, c):
            while not stop.is_set():
                try:
                    run(h, transfer, tid=tid, max_retries=2000)
                    c["updates"] += 1
                except MaxRetriesExceeded:
                    c["failed_updates"] += 1
        return work

    tot, dt = run_trial([scanner, updater(1), updater(2)], duration_s,
                        warmup_s, probe=probe)
    clock = h.clock
    window = list(range(max(0, clock - R + 1), clock + 1))
    state = h.state
    ring, ring_ts = state.ring["['heap']"], state.ring_ts["['heap']"]
    for rc in window:
        vp, okp = h.snapshot(rc)
        vx, okx = SS.snapshot_select_plain(ring, ring_ts, rc)
        vb, okb = h.snapshot_bulk(addrs, rc)
        check(bool(okp) and bool(okx) and okb,
              f"{name}: clock {rc} of the ring window did not resolve")
        blk = vp["heap"][base:base + words]
        check(equal(torch, vp["heap"], vx),
              f"{name}: mv_snapshot != plain snapshot_select at clock {rc}")
        check(equal(torch, blk, vb), f"{name}: mv_snapshot != snapshot_bulk "
                                     f"at clock {rc}")
        check(_sum(blk) == expected, f"{name}: snapshot sum at clock {rc}")
    stats = h.stats()
    if wal is not None:
        keep.update(block=h.state.live["heap"].cpu().numpy(),
                    clock=h.clock, wal_stats=wal.stats())
        wal.close()
        h.wal = None
    h.stop()
    row = {"trial": name, "backend": "mvstore", "block_words": words,
           "ring_slots": R, "seconds": dt,
           "scans_per_s": tot["scans"] / dt,
           "snapshot_scans": tot["snapshot_scans"],
           "stale_scans": tot["stale_scans"],
           "updates_per_s": tot["updates"] / dt,
           "failed_updates": tot["failed_updates"],
           "violations": tot["violations"], "ring_window_checked": window,
           "mode_transitions": stats["mode_transitions"]}
    check(tot["scans"] > 0 and tot["updates"] > 0,
          f"{name}: no progress ({dict(tot)})")
    return row


# ---------------------------------------------------------------------------
# the model server: qwen2.5-3b from MVStore snapshots
# ---------------------------------------------------------------------------

ARCH = "qwen2.5-3b"
MAMBA = "mamba2-780m"
MOONSHOT = "moonshot-v1-16b-a3b"
JAMBA = "jamba-v0.1-52b"
PALIGEMMA = "paligemma-3b"
SCOUT = "llama4-scout-17b-a16e"
DENSE = ("deepseek-7b", "minitron-4b", "mistral-large-123b")
SEAMLESS = "seamless-m4t-medium"
BATCH, PROMPT, GEN, REQUESTS = 4, 512, 32, 8
#: each trained model: its sequence kernel, launched once per layer
#: (per attention of an encoder-decoder: ``prefill_launches``)
PREFILL_KERNEL = {ARCH: "flash_attention", MAMBA: "ssd_scan",
                  SEAMLESS: "flash_attention", PALIGEMMA: "flash_attention",
                  MOONSHOT: "flash_attention"}
#: the families phase's depth cuts (full width; one card does not hold
#: the whole model): jamba one interleave period of its 32 layers (13.3 B
#: of 52 B parameters), llama4-scout 4 of 48 layers (10.9 B), the dense
#: three 2 layers (mistral-large-123b's 88 would be 246 GB)
DEPTH = {JAMBA: 8, SCOUT: 4, "deepseek-7b": 2, "minitron-4b": 2,
         "mistral-large-123b": 2}
#: the vision prefix the model check puts ahead of paligemma's tokens
PATCHES = {PALIGEMMA: 256}
#: the frame embeddings the model check hands seamless-m4t-medium's encoder
FRAMES = {SEAMLESS: 256}


def _config(arch):
    """``arch``'s full config, at its ``DEPTH`` cut where it has one."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch in DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH[arch])
    return cfg


def _reduced(arch):
    """The row's record of ``arch``'s depth cut (None at full depth)."""
    from repro_torch.configs import get_config

    return f"depth {DEPTH[arch]} of {get_config(arch).n_layers} layers" \
        if arch in DEPTH else None


def prefill_launches(cfg) -> dict:
    """The kernel launches one prefill of ``cfg`` makes: one
    ``flash_attention`` an attention layer, one ``ssd_scan`` a Mamba
    layer (whatever the batch: a launch takes every row); an
    encoder-decoder's ``flash_attention`` once an encoder layer and twice
    a decoder layer (self and cross)."""
    from repro_torch.models.transformer import layer_kinds, n_groups

    if cfg.is_encdec:
        return {"flash_attention": cfg.n_encoder_layers + 2 * cfg.n_layers}
    out = defaultdict(int)
    for mixer, _ in layer_kinds(cfg):
        out["flash_attention" if mixer == "attn" else "ssd_scan"] += \
            n_groups(cfg)
    return dict(out)


def free_card(torch):
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _grow(torch, cache, extra):
    """A prefill cache with ``extra`` zeroed positions appended to its
    self-attention k/v leaves (a Mamba state has no sequence axis; an
    encoder-decoder's ``cross_k``/``cross_v`` keep the frames')."""
    def grow(n, t):
        if isinstance(t, dict):
            return {m: grow(m, u) for m, u in t.items()}
        if n not in ("k", "v"):
            return t
        return torch.cat([t, t.new_zeros(t.shape[:2] + (extra,)
                                         + t.shape[3:])], dim=2)

    return {n: grow(n, t) for n, t in cache.items()}


class _Routes:
    """While entered, records every MoE layer's expert choices by run
    (``run`` names the run being driven), wrapping
    ``repro_torch.models.moe.select``.  A run in ``pinned`` is given the
    choices run ``"cpu32"`` made at the same call instead of its own
    (its own are kept in ``natural``); ``margin`` keeps each run's
    smallest gap between a token's k-th and (k+1)-th router
    probabilities."""

    def __init__(self, torch, pinned=()):
        self.torch, self.pinned = torch, set(pinned)
        self.run = None
        self.picks, self.natural = defaultdict(list), defaultdict(list)
        self.margin = {}

    def __enter__(self):
        from repro_torch.models import moe

        inner, torch = moe.select, self.torch

        def recording(x, w, k):
            probs, top, sel = inner(x, w, k)
            v = torch.topk(probs, k + 1, dim=-1).values
            gap = float((v[..., k - 1] - v[..., k]).min())
            self.margin[self.run] = min(gap, self.margin.get(self.run, 1.0))
            if self.run in self.pinned:
                self.natural[self.run].append(sel.cpu())
                sel = self.picks["cpu32"][len(self.picks[self.run])].to(
                    sel.device)
                top = torch.gather(probs, -1, sel)
            self.picks[self.run].append(sel.cpu())
            return probs, top, sel

        self._mod, self._inner = moe, inner
        moe.select = recording
        return self

    def __exit__(self, *exc):
        self._mod.select = self._inner


def model_check(torch, dev, arch=ARCH, prompt=(2, 64)):
    """``arch`` at full width and a depth of 2 layers: one set of
    seeded bf16 weights (``materialize`` on the card, copied to the
    CPU), run as bf16 and, upcast, as float32, on the card and on the
    CPU: prefill of ``prompt`` tokens (for paligemma-3b behind
    ``PATCHES`` seeded patch embeddings) and 4 decode steps, every run
    fed the CPU float32 run's greedy tokens; each card prefill must
    launch the arch's prefill kernels once per layer.  float32: the
    card's logits within 2e-4 of the CPU's and the same greedy tokens
    (TF32 off); for a MoE model also the same experts chosen at every
    layer, token and step (the smallest top-k margin printed).
    bfloat16: an element-wise tolerance does not survive two layers at
    this width (two CPU bf16 routes that differ only in the order of
    their float32 sums differ by more than 2e-2), so each bf16 run is
    held against the float32 logits of the same weights: the card's mean
    and max error must stay within twice the CPU's.  A MoE model's bf16
    runs take the float32 CPU run's expert choices (a choice is
    discrete: bf16 rounding flips near-ties, each flip moving a token's
    output by as much as a fault would); how often their own choices
    differ is printed.  A fault on the path (mask, scale, head mapping,
    cache write, decay, state carry, dispatch, combine) moves logits by
    0.1-1; bf16 rounding by ~0.01.  qwen2.5-3b runs 2 x 64 tokens;
    mamba2-780m 2 x 512, two chunks of 256, so the scan's state also
    crosses a chunk inside the kernel before decode takes it over.
    seamless-m4t-medium (2 encoder and 2 decoder layers) runs 2 x 64
    tokens over ``FRAMES`` seeded frame embeddings, bf16 and, for the
    float32 runs, upcast (frames narrower than the weights would change
    the encoder's carry dtype, which the reference refuses); each card
    prefill launches ``flash_attention`` once an encoder layer and twice
    a decoder layer."""
    from repro_torch import kernels as K
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.launch.sharding import tree_map
    from repro_torch.models import model_zoo as zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    pcfg = ParallelConfig(remat="none", attn_block_q=64, attn_block_k=64)
    cfg16 = dataclasses.replace(get_config(arch), n_layers=2)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    p16 = zoo.init_params(cfg16, torch.Generator(device=dev).manual_seed(
        SEED))
    p32 = tree_map(lambda t: t.float(), p16)
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg16.vocab_size, prompt).astype(np.int32))}
    if arch in PATCHES:
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (prompt[0], PATCHES[arch], cfg16.d_model), dtype=np.float32)
        ).to(torch.bfloat16)
    if arch in FRAMES:
        batch["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (prompt[0], FRAMES[arch], cfg16.d_model), dtype=np.float32)
        ).to(torch.bfloat16)
    moe = bool(cfg16.moe.num_experts)
    routes = _Routes(torch, pinned=("cpu16", "card16") if moe else ())
    runs = {}
    K.reset_launch_counts()
    with routes:
        for name, cfg, d in (("cpu32", cfg32, "cpu"), ("cpu16", cfg16, "cpu"),
                             ("card32", cfg32, dev), ("card16", cfg16, dev)):
            p = tree_map(lambda t: t.to(d), p32 if cfg is cfg32 else p16)
            b = {k: v.to(d) for k, v in batch.items()}
            if "frame_embeds" in b and cfg is cfg32:
                b["frame_embeds"] = b["frame_embeds"].float()
            routes.run = name
            logits, cache, clen = zoo.prefill_fn(p, b, cfg, pcfg)
            runs[name] = [logits, _grow(torch, cache, 4), clen, p, cfg, d]
        for kernel, n in prefill_launches(cfg16).items():
            check(K.launch_counts()[kernel] == 2 * n,
                  f"the card's prefills did not run {kernel} once per "
                  "layer")
        steps = []
        for step in range(5):
            lg = {n: r[0].float().cpu() for n, r in runs.items()}
            ref = lg["cpu32"]
            tok = torch.argmax(ref, dim=-1).to(torch.int32)
            try:
                err32 = max_abs_err(torch, lg["card32"], ref, "float32")
            except Failed as e:
                raise Failed(f"card != CPU at float32, step {step}: {e}")
            check(torch.equal(torch.argmax(lg["card32"], dim=-1)
                              .to(torch.int32), tok),
                  f"card and CPU greedy tokens differ at float32, step "
                  f"{step}")
            e_card = (lg["card16"] - ref).abs()
            e_cpu = (lg["cpu16"] - ref).abs()
            row = {"step": step, "f32_max_abs_err": err32,
                   "bf16_card_vs_cpu_max_abs_err":
                       float((lg["card16"] - lg["cpu16"]).abs().max()),
                   "bf16_vs_f32_mean_err": {"card": float(e_card.mean()),
                                            "cpu": float(e_cpu.mean())},
                   "bf16_vs_f32_max_err": {"card": float(e_card.max()),
                                           "cpu": float(e_cpu.max())}}
            steps.append(row)
            check(row["bf16_vs_f32_mean_err"]["card"]
                  <= 2 * row["bf16_vs_f32_mean_err"]["cpu"]
                  and row["bf16_vs_f32_max_err"]["card"]
                  <= 2 * row["bf16_vs_f32_max_err"]["cpu"],
                  f"the card's bf16 logits are off the float32 reference "
                  f"by more than twice the CPU's bf16 logits, step {step}: "
                  f"{row}")
            if step == 4:
                break
            for name, r in runs.items():
                routes.run = name
                r[0], r[1], r[2] = zoo.decode_fn(r[3], r[1], r[2],
                                                 tok.to(r[5]), r[4], pcfg)
    out = {"model_check": arch, "layers": 2, "prompt": list(prompt),
           "prefix_embeds": PATCHES.get(arch, 0),
           "frame_embeds": FRAMES.get(arch, 0), "decode_steps": 4,
           "f32_tolerance": TOLERANCE["float32"],
           "f32_greedy_tokens_equal": True, "steps": steps}
    if moe:
        card, cpu = routes.picks["card32"], routes.picks["cpu32"]
        same = len(card) == len(cpu) and all(
            torch.equal(a, b) for a, b in zip(card, cpu))
        choices = sum(t.numel() for t in cpu)
        out.update({
            "moe_calls": len(cpu), "expert_choices": choices,
            "f32_experts_equal": same,
            "f32_min_topk_margin": {"card": routes.margin["card32"],
                                    "cpu": routes.margin["cpu32"]},
            "bf16_own_choices_differing_from_f32": {
                r: sum(int((a != b).sum()) for a, b in
                       zip(routes.natural[r], cpu))
                for r in ("card16", "cpu16")}})
        check(same, f"{arch}: the card's float32 run chose other experts "
                    "than the CPU's")
    emit(out)
    del runs, p16, p32
    free_card(torch)
    return out


def _prompts(arch=ARCH):
    return np.random.default_rng(SEED).integers(
        0, _config(arch).vocab_size, (REQUESTS, PROMPT)).astype(np.int32)


def _server(mode, arch=ARCH):
    """The server on the card, its parameters drawn from ``SEED``; Mode U
    versions every block in a 2-slot ring."""
    from repro_torch.configs import MVStoreConfig
    from repro_torch.launch.serve import Server

    return Server(_config(arch), batch=BATCH, prompt_len=PROMPT,
                  max_len=PROMPT + GEN, seed=SEED,
                  mvcfg=MVStoreConfig(mode=mode, ring_slots=2))


def _fresh_metrics(server):
    """Forget the warm-up request's telemetry."""
    from repro_torch.serve.metrics import ServeMetrics

    server.metrics = server.scheduler.metrics = ServeMetrics(seed=SEED)


def serving_trial(torch, launches, arch=ARCH, idle_window_s=0.0):
    """``Server`` over ``arch`` at full width (and full depth, or its
    ``DEPTH`` cut), Mode Q: one warm-up request, then 8 seeded requests
    through 4 slots.  Launch counters are set to 0 just before the 8 and
    read just after; every prefill must have run its prefill kernels
    (``flash_attention`` an attention layer, ``ssd_scan`` a Mamba layer:
    ``prefill_launches``) once per layer.  With ``idle_window_s``, the same
    server then serves under a profiler trace for that long
    (``idle_trace``; its launches are not counted).  Last, one batched
    decode step of the 4 slots counted by ``launch.roofline.count()``
    (``roofline_read``)."""
    from repro_torch import kernels as K
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import roofline as RL
    from repro_torch.models import model_zoo as zoo

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = _server("Q", arch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    prompts = _prompts(arch)
    server.serve_batch(prompts[:1], 2)                  # warm-up
    _fresh_metrics(server)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [server.submit(p, GEN) for p in prompts]
    while any(r.outcome is r.outcome.PENDING for r in reqs):
        server.pump()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    for k, v in counts.items():
        launches[k] += v
    m = server.metrics
    toks = np.array([r.tokens for r in reqs])
    per_token = [(r.t_done - r.t_first_token) / (len(r.tokens) - 1)
                 for r in reqs]
    cfg = server.cfg
    row = {"trial": f"serve_{arch}", "mode": "Q", "batch": BATCH,
           "prompt_len": PROMPT, "gen": GEN, "requests": REQUESTS,
           "layers": cfg.n_layers, "reduced": _reduced(arch),
           "params": zoo.param_counts(cfg)["total"],
           "init_s": init_s, "init_max_memory_allocated": init_peak,
           "seconds": dt, "tokens_per_s": toks.size / dt,
           "ttft_ms_p50": m.ttft.percentile(50) * 1e3,
           "ttft_ms_p99": m.ttft.percentile(99) * 1e3,
           "per_token_ms_p50": float(np.percentile(per_token, 50)) * 1e3,
           "per_token_ms_p99": float(np.percentile(per_token, 99)) * 1e3,
           "occupancy": m.occupancy, "aborts": server.aborts,
           "completed": m.completed,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": counts}
    emit(row)
    check(m.completed == REQUESTS and toks.shape == (REQUESTS, GEN),
          "serving: not every request completed")
    check(bool(((toks >= 0) & (toks < cfg.padded_vocab())).all()),
          "serving: a token outside the padded vocab")
    for kernel, n in prefill_launches(cfg).items():
        check(counts[kernel] >= n * REQUESTS,
              f"serving {arch}: {counts[kernel]} {kernel} launches for "
              f"{REQUESTS} prefills of {n} such layers")
    if idle_window_s:
        idle_trace(torch, server, arch, idle_window_s)
    clocks = [server.executor.current_clock()] * BATCH
    with RL.count() as rec:
        server.executor.decode(list(range(BATCH)), clocks)
    K.reset_launch_counts()
    roofline_read(torch, rec, cfg, ShapeConfig(
        f"decode_{BATCH}x{PROMPT + GEN}", PROMPT + GEN, BATCH, "decode"),
        arch, row["per_token_ms_p50"] / 1e3, mode="Q",
        peak=row["max_memory_allocated"], reduced=row["reduced"])
    del server
    free_card(torch)
    return row, toks


def snapshot_checks(torch, launches, served, arch=ARCH, modes=("U", "Q")):
    """A writer commits a new version (``lm_head`` negated; for a model
    with tied embeddings, mamba2-780m, ``final_norm``) with
    ``mv_commit`` while all 4 slots decode.  Mode U (every block
    versioned, 2 ring slots): no abort, the tokens of the run without
    the commit, which are also the serving trial's first 4 requests'
    (Mode Q reads the live blocks; Mode U copies them out of the ring
    through ``snapshot_select``).  Mode Q: every in-flight request
    aborts once and restarts at the new clock; all complete."""
    from repro_torch import kernels as K
    from repro_torch.configs import MVStoreConfig
    from repro_torch.core import mvstore

    prompts = _prompts(arch)[:BATCH]
    rows = {}
    for mode in modes:
        mvcfg = MVStoreConfig(mode=mode, ring_slots=2)
        server = _server(mode, arch)
        baseline = None
        if mode == "U":
            baseline = server.serve_batch(prompts, GEN)
            _fresh_metrics(server)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [server.submit(p, GEN) for p in prompts]
        server.pump()
        pinned = [r.pinned_clock for r in reqs]
        check(all(len(r.tokens) == 2 for r in reqs),
              f"Mode {mode}: the slots were not all decoding")
        new = dict(server.mv_state.live)
        key = "lm_head" if "lm_head" in new else "final_norm"
        new[key] = -new[key]
        server.mv_state = mvstore.mv_commit(server.mv_state, new,
                                            local_mode=mode, cfg=mvcfg)
        while any(r.outcome is r.outcome.PENDING for r in reqs):
            server.pump()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = K.launch_counts()
        for k, v in counts.items():
            launches[k] += v
        toks = np.array([r.tokens for r in reqs])
        row = {"trial": f"snapshot_commit_{mode}"
                        + ("" if arch == ARCH else f"_{arch}"),
               "negated": key, "mode": mode,
               "ring_slots": 2 if mode == "U" else 0, "seconds": dt,
               "pinned_clocks": pinned, "aborts": server.aborts,
               "completed": server.metrics.completed,
               "served_clocks": sorted({c for r in reqs
                                        for c in r.served_clocks}),
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": counts}
        if mode == "U":
            row["tokens_equal_no_commit"] = bool(
                np.array_equal(toks, baseline))
            row["tokens_equal_serving_trial"] = bool(
                np.array_equal(toks, served[:BATCH]))
        emit(row)
        check(server.metrics.completed == BATCH,
              f"Mode {mode}: not every request completed")
        if mode == "U":
            check(server.aborts == 0, "Mode U: a pinned reader aborted")
            check(row["tokens_equal_no_commit"],
                  "Mode U: the commit changed the pinned requests' tokens")
            check(row["tokens_equal_serving_trial"],
                  "Mode U tokens differ from the Mode Q serving trial's")
            check(row["served_clocks"] == [0],
                  "Mode U: a request was served a newer version")
            check(counts["snapshot_select"] > 0,
                  "Mode U: snapshot_select was never launched")
        else:
            check(server.aborts >= BATCH, f"Mode Q: {server.aborts} aborts "
                                          f"for {BATCH} in-flight requests")
            check(all(r.pinned_clock == 1 for r in reqs),
                  "Mode Q: a request did not restart at the new clock")
        rows[mode] = row
        del server, new
        free_card(torch)
    return rows


def idle_trace(torch, server, arch, window_s=TRACE_S):
    """``window_s`` of the Mode-Q ``server`` under load (the queue kept at
    8 requests) under a profiler trace of its GPU activity: prints the
    card's busy time and idle share and its prefill kernels' time."""
    from torch.profiler import ProfilerActivity

    prompts = _prompts(arch)
    prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
    pending, i, done = [], 0, 0
    prof.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < window_s:
        while len(pending) < REQUESTS:
            pending.append(server.submit(prompts[i % REQUESTS], GEN))
            i += 1
        server.pump()
        done += sum(r.outcome is not r.outcome.PENDING for r in pending)
        pending = [r for r in pending if r.outcome is r.outcome.PENDING]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    prof.stop()
    gpu = gpu_events(prof)
    busy_us = sum(e["dur"] for e in gpu)
    row = {"trace": f"serve_{arch}", "window_s": dt, "gpu_events": len(gpu),
           "requests_completed": done,
           "device_busy_ms": busy_us / 1e3 if gpu else None,
           "device_idle_share": 1 - busy_us / 1e3 / (dt * 1e3) if gpu
           else None}
    for kernel in prefill_launches(server.cfg):
        row[f"{kernel}_ms"] = kernel_us(gpu, DEVICE_KERNELS[kernel]) / 1e3 \
            if gpu else None
    emit(row)
    return row


def prefill_decode_trial(torch, launches, arch):
    """``arch`` at full width and its ``DEPTH`` cut, bf16, weights drawn on
    the card from ``SEED``: one prefill of 4 x 512 seeded tokens
    (``zoo.prefill_fn``) and 4 greedy decode steps.  Gates: finite logits
    at every step, and exactly one ``flash_attention`` launch per
    attention layer in the prefill (each launch takes the 4 rows).
    Records the parameters, the init, prefill and per-step times (host
    clock, each ending in a sync) and the peak memory."""
    from repro_torch import kernels as K
    from repro_torch.configs import ParallelConfig
    from repro_torch.models import model_zoo as zoo

    cfg = _config(arch)
    pcfg = ParallelConfig(remat="none", attn_block_q=PROMPT,
                          attn_block_k=PROMPT)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = zoo.init_params(cfg, torch.Generator(device=CARD)
                             .manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.from_numpy(_prompts(arch)[:BATCH]).to(CARD)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache, clen = zoo.prefill_fn(params, {"tokens": toks}, cfg,
                                             pcfg)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill = K.launch_counts()
        finite = [bool(torch.isfinite(logits).all())]
        cache, step_s = _grow(torch, cache, 4), []
        for _ in range(4):
            t0 = time.perf_counter()
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            logits, cache, clen = zoo.decode_fn(params, cache, clen, tok,
                                                cfg, pcfg)
            finite.append(bool(torch.isfinite(logits).all()))
            step_s.append(time.perf_counter() - t0)
    counts = K.launch_counts()
    for k, v in counts.items():
        launches[k] += v
    row = {"trial": f"prefill_decode_{arch}", "layers": cfg.n_layers,
           "reduced": _reduced(arch),
           "params": zoo.param_counts(cfg)["total"], "batch": BATCH,
           "prompt_len": PROMPT, "decode_steps": 4, "init_s": init_s,
           "prefill_s": prefill_s, "decode_step_ms": [t * 1e3
                                                      for t in step_s],
           "logits_finite": finite,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "prefill_launches": prefill, "launches": counts}
    emit(row)
    check(all(finite), f"{arch}: non-finite logits")
    want = prefill_launches(cfg)["flash_attention"]
    check(prefill["flash_attention"] == want,
          f"{arch}: {prefill['flash_attention']} flash_attention launches "
          f"in a prefill of {want} attention layers")
    del params, cache, logits
    free_card(torch)
    return row


def families_phase(torch, dev):
    """The decoder families beside qwen2.5-3b and mamba2-780m, each at full
    width: moonshot-v1-16b-a3b and paligemma-3b card = CPU
    (``model_check``, depth 2; paligemma behind 256 patch embeddings);
    moonshot-v1-16b-a3b served at full depth (48 layers, 28.05 B
    parameters, Mode Q) and its Mode-Q commit check; jamba-v0.1-52b served
    at one interleave period (its idle share traced on the same server);
    llama4-scout-17b-a16e and the three dense archs one prefill and 4
    decode steps each (``prefill_decode_trial``).  Each trial frees the
    card before the next.  Returns the launch totals of the trials."""
    t0 = time.perf_counter()
    totals = defaultdict(int)
    model_check(torch, dev, arch=MOONSHOT)
    model_check(torch, dev, arch=PALIGEMMA)
    _, toks = serving_trial(torch, totals, arch=MOONSHOT)
    snapshot_checks(torch, totals, toks, arch=MOONSHOT, modes=("Q",))
    serving_trial(torch, totals, arch=JAMBA, idle_window_s=TRACE_S)
    for arch in (SCOUT,) + DENSE:
        prefill_decode_trial(torch, totals, arch)
    emit({"families_phase_seconds": time.perf_counter() - t0})
    return totals


def encdec_serving_trial(torch, launches, arch=SEAMLESS,
                         idle_window_s=TRACE_S):
    """``arch`` (seamless-m4t-medium) at full width and depth, bf16,
    weights drawn on the card from ``SEED`` into an MVStore in Mode U
    (every block versioned, 2 ring slots), served the way the reference
    can serve the family (its ``Server`` hands a prefill no frame
    embeddings): ``make_prefill_step`` over a ``concrete_batch`` of 4 x
    4096 bf16 frame embeddings and 4 x 512 tokens, then 32 greedy
    ``make_decode_step`` steps, all at read clock 0.  Launch counters are
    set to 0 just before (after one warm-up prefill) and read just after.
    Gates: every step ``ok``, finite logits, the tokens of the same calls
    on the live parameters, 36 ``flash_attention`` launches in the
    prefill (12 encoder, 12 decoder self, 12 cross) and one
    ``snapshot_select`` a versioned block a step.  Records the init,
    prefill and per-step times (host clock, each ending in a sync), the
    peak memory and, over ``idle_window_s`` of further prefills and
    decode steps under a profiler trace, the card's idle share; last, one
    decode step from the snapshot counted by ``launch.roofline.count()``
    (``roofline_read``)."""
    from torch.profiler import ProfilerActivity

    from repro_torch import kernels as K
    from repro_torch.configs import (MVStoreConfig, ParallelConfig,
                                     ShapeConfig, get_config)
    from repro_torch.core import mvstore
    from repro_torch.launch import roofline as RL
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import model_zoo as zoo

    cfg = get_config(arch)
    pcfg = ParallelConfig(remat="none", attn_block_q=PROMPT,
                          attn_block_k=PROMPT)
    mvcfg = MVStoreConfig(mode="U", ring_slots=2)
    gen = torch.Generator(device=CARD).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mv = mvstore.mv_init(zoo.init_params(cfg, gen), mvcfg, versioned="all")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    batch = zoo.concrete_batch(cfg, ShapeConfig("serve_encdec", PROMPT,
                                                BATCH, "prefill"), gen)
    prefill = steps_mod.make_prefill_step(cfg, pcfg, mvcfg)
    decode = steps_mod.make_decode_step(cfg, pcfg, mvcfg)
    rc = mv.clock

    def generate(step_s=None):
        """The prefill and GEN decode steps from the snapshot at ``rc``:
        (greedy tokens [B, GEN], the steps' ok flags, finite flags)."""
        t0 = time.perf_counter()
        logits, cache, clen, ok = prefill(mv, batch, rc)
        cache, toks, oks = _grow(torch, cache, GEN), [], [ok]
        finite = [torch.isfinite(logits).all()]
        if step_s is not None:
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        for _ in range(GEN):
            t0 = time.perf_counter()
            toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
            logits, cache, clen, ok = decode(mv, cache, clen, toks[-1], rc)
            oks.append(ok)
            finite.append(torch.isfinite(logits).all())
            if step_s is not None:
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
        return torch.stack(toks, 1), torch.stack(oks), torch.stack(finite)

    with torch.no_grad():
        prefill(mv, batch, rc)                            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        step_s = []
        toks, oks, finite = generate(step_s)
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for k, v in counts.items():
            launches[k] += v
        logits, cache, clen = zoo.prefill_fn(mv.live, batch, cfg, pcfg)
        cache, live = _grow(torch, cache, GEN), []
        for _ in range(GEN):
            live.append(torch.argmax(logits, dim=-1).to(torch.int32))
            logits, cache, clen = zoo.decode_fn(mv.live, cache, clen,
                                                live[-1], cfg, pcfg)
        same = bool(torch.equal(toks, torch.stack(live, 1)))
        cache = _grow(torch, cache, 1)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        with RL.count() as rec:
            decode(mv, cache, clen, tok, rc)
        del logits, cache
        prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        t0, rounds = time.perf_counter(), 0
        while time.perf_counter() - t0 < idle_window_s:
            generate()
            rounds += 1
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        prof.stop()
    K.reset_launch_counts()
    gpu = gpu_events(prof)
    busy_us = sum(e["dur"] for e in gpu)
    n_blocks = len(mv.ring)
    row = {"trial": f"serve_{arch}", "mode": "U", "ring_slots": 2,
           "route": "make_prefill_step / make_decode_step",
           "batch": BATCH, "frames": cfg.frontend_len,
           "frames_dtype": str(batch["frame_embeds"].dtype),
           "prompt_len": PROMPT, "gen": GEN, "layers":
           [cfg.n_encoder_layers, cfg.n_layers],
           "params": zoo.param_counts(cfg)["total"],
           "versioned_blocks": n_blocks, "init_s": init_s,
           "init_max_memory_allocated": init_peak,
           "prefill_s": step_s[0],
           "per_token_ms_p50": float(np.percentile(step_s[1:], 50)) * 1e3,
           "per_token_ms_p99": float(np.percentile(step_s[1:], 99)) * 1e3,
           "tokens_per_s": BATCH * GEN / sum(step_s[1:]),
           "steps_ok": int(oks.sum()), "steps": GEN + 1,
           "tokens_equal_live": same,
           "max_memory_allocated": peak, "launches": counts,
           "trace_window_s": window, "trace_rounds": rounds,
           "gpu_events": len(gpu),
           "device_busy_ms": busy_us / 1e3 if gpu else None,
           "device_idle_share": 1 - busy_us / 1e3 / (window * 1e3)
           if gpu else None,
           "flash_attention_ms": kernel_us(
               gpu, DEVICE_KERNELS["flash_attention"]) / 1e3
           if gpu else None}
    emit(row)
    check(bool(oks.all()), f"serve {arch}: a snapshot step was not ok")
    check(bool(finite.all()), f"serve {arch}: non-finite logits")
    check(same, f"serve {arch}: the snapshot's tokens differ from the "
                "live parameters'")
    want = prefill_launches(cfg)["flash_attention"]
    check(counts["flash_attention"] == want,
          f"serve {arch}: {counts['flash_attention']} flash_attention "
          f"launches in a prefill of {want} attentions")
    check(counts["snapshot_select"] == n_blocks * (GEN + 1),
          f"serve {arch}: {counts['snapshot_select']} snapshot_select "
          f"launches for {n_blocks} blocks x {GEN + 1} steps")
    check(rec.kernels.get("snapshot_select", [0])[0] == n_blocks,
          f"serve {arch}: the counted decode step's kernels {rec.kernels}")
    roofline_read(torch, rec, cfg, ShapeConfig(
        f"decode_{BATCH}x{PROMPT + GEN}", PROMPT + GEN, BATCH, "decode"),
        arch, row["per_token_ms_p50"] / 1e3, mode="U", peak=peak)
    del mv, batch
    free_card(torch)
    return row


def seamless_phase(torch, dev):
    """The encoder-decoder family at full width: seamless-m4t-medium card =
    CPU (``model_check``, 2 encoder and 2 decoder layers over 2 x 256
    frames), served from Mode-U snapshots (``encdec_serving_trial``) and
    trained (``train_trial``, ``STEPS`` steps, AdamW
    warming up over ``TRAIN_WARMUP``, one step traced: a step takes
    ~2.9 s).  Returns
    the launch totals of the trials."""
    t0 = time.perf_counter()
    totals = defaultdict(int)
    model_check(torch, dev, arch=SEAMLESS)
    encdec_serving_trial(torch, totals)
    train_trial(torch, totals, arch=SEAMLESS)
    emit({"seamless_phase_seconds": time.perf_counter() - t0})
    return totals


def family_training_phase(torch, dev):
    """paligemma-3b and moonshot-v1-16b-a3b trained: each card = CPU at
    its reduced config in float32 (``train_check(smoke=True)``; float32
    keeps moonshot's expert choices the CPU's), then
    ``train_trial`` at full width (moonshot at its ``TRAIN_DEPTH``),
    ``STEPS`` Mode-U fused steps each, one step traced and
    one counted; the card is freed between them.  Returns the launch
    totals of the trials."""
    t0 = time.perf_counter()
    totals = defaultdict(int)
    for arch in (PALIGEMMA, MOONSHOT):
        train_check(torch, dev, arch=arch, smoke=True)
    for arch in (PALIGEMMA, MOONSHOT):
        train_trial(torch, totals, arch=arch)
    emit({"family_training_phase_seconds": time.perf_counter() - t0})
    return totals


# ---------------------------------------------------------------------------
# the trainer: qwen2.5-3b trained into the MVStore
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 20, 512, 4
TRAIN_TOL = 1e-4            # card vs CPU, float32, rtol = atol
FUSED_TOL = 2e-3            # fused vs unfused (tests/test_train_e2e.py)
#: the CPU run each of the train check's card runs is held against, by
#: arch: on the CPU, Mode U's versioned commit and its fused commit leave
#: Mode Q's live blocks, moments and losses bit for bit (the ring is extra
#: state; ``tests/test_torch_train.py::test_cpu_runs_of_every_mode_equal_
#: mode_q``), so qwen2.5-3b's one CPU run serves all three (a second one
#: took 30-38 s of the run); mamba2-780m's fused run keeps its own
CPU_RUN = {ARCH: {"Q": "Q", "U": "Q", "U_fused": "Q"},
           MAMBA: {"Q": "Q", "U": "Q", "U_fused": "U_fused"},
           PALIGEMMA: {"Q": "Q", "U": "U", "U_fused": "U_fused"},
           MOONSHOT: {"Q": "Q", "U": "U", "U_fused": "U_fused"}}


def _state_leaves(state):
    """Live blocks and moments of a train state, by path."""
    from repro_torch.core import mvstore

    return {f"{k}{p}": t for k, tree in
            (("live", state.mv.live), ("mu", state.opt.mu),
             ("nu", state.opt.nu)) for p, t in mvstore._flatten(tree)}


def _tree_err(torch, got, want, tol, dev):
    """Largest |got - want| over the leaves of two ``_state_leaves``,
    compared on the card (a CPU leaf is copied over); fails past ``tol``
    (rtol = atol) or on a non-finite value."""
    check(sorted(got) == sorted(want), "the two states hold other leaves")
    return max(max_abs_err(torch, got[k].to(dev), want[k].to(dev),
                           "float32", tol) for k in want)


def _train_check_cfg(arch, smoke):
    """``(cfg, shape)`` of ``arch``'s train check: float32, at full width
    and a depth of 2 layers or (``smoke``) at ``smoke_config``, 2 x 64
    positions."""
    from repro_torch.configs import ShapeConfig, get_config, smoke_config

    base = smoke_config(arch) if smoke else \
        dataclasses.replace(get_config(arch), n_layers=2)
    return (dataclasses.replace(base, dtype="float32"),
            ShapeConfig("train_check", 64, 2, "train"))


def _train_modes():
    from repro_torch.configs import MVStoreConfig

    return {"Q": MVStoreConfig(mode="Q"), "U": MVStoreConfig(mode="U"),
            "U_fused": MVStoreConfig(mode="U", fused_commit=True)}


def _train_run(torch, cfg, shape, init, mvcfg, where):
    """Two ``Trainer`` steps on ``where`` from ``init``, the second counted
    by ``launch.roofline.count()``: ``(losses, state leaves, launch
    counts, count record)``.  The launch counters are set to 0 only for
    the card (the CPU launches nothing, and its runs may overlap other
    phases' counts)."""
    from repro_torch import kernels as K
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.train import Trainer

    if torch.device(where).type != "cpu":
        K.reset_launch_counts()
    tr = Trainer(cfg, shape, mvcfg=mvcfg, params=init, device=where)
    state, tr.state = tr.state, None
    losses = []
    state, metrics = tr.train_step(state, tr.batch_at(0))
    losses.append(float(metrics["loss"]))
    with RL.count(device=torch.device(where).type) as rec:
        state, metrics = tr.train_step(state, tr.batch_at(1))
    losses.append(float(metrics["loss"]))
    tr.controller.stop()
    return losses, _state_leaves(state), K.launch_counts(), rec


def train_cpu_runs(torch, arch, smoke=False):
    """The CPU side of ``arch``'s train check: ``(init, {mode: (run,
    seconds)})``, one run per mode ``CPU_RUN[arch]`` names, from weights
    drawn on the CPU from ``SEED`` (``init``, numpy: the card's runs
    start from them too)."""
    from repro_torch.launch.sharding import tree_map
    from repro_torch.models import model_zoo as zoo

    cfg, shape = _train_check_cfg(arch, smoke)
    init = tree_map(lambda t: t.numpy(), zoo.init_params(
        cfg, torch.Generator().manual_seed(SEED)))
    modes, runs = _train_modes(), {}
    for ref in dict.fromkeys(CPU_RUN[arch].values()):
        t0 = time.perf_counter()
        runs[ref] = (_train_run(torch, cfg, shape, init, modes[ref], "cpu"),
                     time.perf_counter() - t0)
    return init, runs


class CPUReference:
    """The full-width train checks' CPU runs (``train_cpu_runs`` of each
    arch in turn), computed in a thread started at the beginning of the
    run, beside the build, the schedules and the model checks: on the
    host of an NVIDIA H100 80GB HBM3 (700.00 W) they took 42-87 s, most
    of it elementwise AdamW over 466 M float32 parameters.  ``get`` waits for an arch's runs and
    re-raises the thread's error."""

    def __init__(self, torch, archs):
        self._out, self._done = {}, {a: threading.Event() for a in archs}
        # not a daemon: a failed run exits only once the thread is done
        self._thread = threading.Thread(target=self._run, args=(torch,),
                                        name="cpu-reference")
        self._thread.start()

    def _run(self, torch):
        for arch, done in self._done.items():
            try:
                self._out[arch] = train_cpu_runs(torch, arch)
            except BaseException as e:          # handed to get()
                self._out[arch] = e
            done.set()

    def get(self, arch):
        t0 = time.perf_counter()
        self._done[arch].wait()
        out = self._out.pop(arch)
        if isinstance(out, BaseException):
            raise out
        return out, time.perf_counter() - t0


def train_check(torch, dev, arch=ARCH, smoke=False, cpu=None):
    """The trainer on the card against the trainer on the CPU: ``arch``
    at full width and a depth of 2 layers (or, ``smoke``, at the
    reduced config of ``smoke_config``), float32 (TF32 off), one set of
    seeded weights, 2 steps of 2 x 64 positions in Mode Q (adamw.apply +
    mv_commit, no ring), Mode U (the same with a 2-slot ring) and Mode U
    fused (``fused_adamw`` per leaf), each against the CPU's run of
    ``CPU_RUN[arch][mode]`` (one CPU run serves several; ``cpu``, when
    given, is a ``CPUReference``, which computed them beforehand).
    Losses, live blocks and moments within 1e-4; the card's fused run
    within 2e-3 of its unfused one.  The card's runs must launch the
    arch's sequence kernel (``flash_attention``, or ``ssd_scan`` through
    ``SSDScanFn``) for each layer's forward and recompute, and the fused
    run ``fused_adamw`` once per leaf and step.  Each run's second step
    is counted (``launch.roofline.count()``: the CPU's plain routes, the
    card's kernels); a card run's flops and bytes must equal those of
    the CPU run of its own mode, wherever there is one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    waited = None
    if cpu is None:
        init, cpu_runs = train_cpu_runs(torch, arch, smoke)
    else:
        (init, cpu_runs), waited = cpu.get(arch)
    cfg, shape = _train_check_cfg(arch, smoke)
    modes, rows, card = _train_modes(), {}, {}
    for name, mvcfg in modes.items():
        ref = CPU_RUN[arch][name]
        (lc, tc, _, rec_c), cpu_s = cpu_runs[ref]
        secs = {"cpu": cpu_s, "cpu_run": ref}
        t0 = time.perf_counter()
        lg, tg, counts, rec_g = _train_run(torch, cfg, shape, init, mvcfg,
                                           dev)
        secs[str(dev)] = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            row = {"mode": name,
                   "loss_max_abs_err": max_abs_err(
                       torch, torch.tensor(lg), torch.tensor(lc), "float32",
                       TRAIN_TOL),
                   "state_max_abs_err": _tree_err(torch, tg, tc, TRAIN_TOL,
                                                  dev),
                   "losses_card": lg, "losses_cpu": lc,
                   "launches": {k: counts[k] for k in ("flash_attention",
                                                       "ssd_scan",
                                                       "fused_adamw")},
                   "counted_step": {"card": [rec_g.flops, rec_g.bytes],
                                    "cpu": [rec_c.flops, rec_c.bytes],
                                    "cpu_mode": ref}}
        except Failed as e:
            raise Failed(f"train check {arch}, Mode {name}: card != CPU: "
                         f"{e}")
        if ref == name:
            same = (rec_g.flops, rec_g.bytes) == (rec_c.flops, rec_c.bytes)
            row["counted_step"]["equal"] = same
            if not same:
                diff = {k: (rec_g.by_op.get(k), rec_c.by_op.get(k))
                        for k in set(rec_g.by_op) | set(rec_c.by_op)
                        if rec_g.by_op.get(k) != rec_c.by_op.get(k)}
                raise Failed(f"train check {arch}, Mode {name}: the counted "
                             f"step differs between the card and the CPU "
                             f"(card, cpu by operation): {diff}")
        secs["compare"] = time.perf_counter() - t0
        row["seconds"] = secs
        seq_kernel = PREFILL_KERNEL[arch]
        check(counts[seq_kernel] == 2 * 2 * 2,
              f"train check {arch}, Mode {name}: {counts[seq_kernel]} "
              f"{seq_kernel} launches for 2 layers x (forward + "
              "recompute) x 2 steps")
        want_fa = 2 * len(tg) // 3 if name == "U_fused" else 0
        check(counts["fused_adamw"] == want_fa,
              f"train check {arch}, Mode {name}: {counts['fused_adamw']} "
              f"fused_adamw launches, expected {want_fa}")
        rows[name] = row
        if name in ("U", "U_fused"):
            card[name] = (lg, tg)
        del tc, tg
    try:
        fused_err = max(
            max_abs_err(torch, torch.tensor(card["U_fused"][0]),
                        torch.tensor(card["U"][0]), "float32", FUSED_TOL),
            _tree_err(torch, card["U_fused"][1], card["U"][1], FUSED_TOL,
                      dev))
    except Failed as e:
        raise Failed(f"train check {arch}: fused != unfused on the card: {e}")
    out = {"train_check": arch, "smoke": smoke, "layers": cfg.n_layers,
           "width": cfg.d_model, "tokens": [2, 64], "steps": 2,
           "cpu_reference_waited_s": waited,
           "tolerance": TRAIN_TOL, "fused_vs_unfused_max_abs_err": fused_err,
           "fused_tolerance": FUSED_TOL, "modes": rows}
    emit(out)
    del card, init, cpu_runs
    free_card(torch)
    return out


def _checksums(torch, tree):
    """Per leaf: (sum, sum of squares) of its raw bit patterns as int64,
    taken 2**26 elements at a time — equal for bit-identical leaves."""
    from repro_torch.core import mvstore

    out = {}
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    for path, t in mvstore._flatten(tree):
        s1 = s2 = 0
        for c in t.reshape(-1).split(1 << 26):
            w = c.view(view[t.element_size()]).to(torch.int64)
            s1 = s1 + w.sum()
            s2 = s2 + (w * w).sum()
        out[path] = (s1, s2)
    return {p: (int(a), int(b)) for p, (a, b) in out.items()}


def flash_f32_split(gpu, steps):
    """Per step of a traced training window: the device ms of
    ``flash_attention``'s float32 (FMA) launches, and of those among them
    with the largest grid (an encoder-decoder's encoder over its frames:
    more query tiles than the cross-attention's text), from the trace's
    kernel records (None without grid records)."""
    fma = [e for e in gpu if e["cat"] == "kernel"
           and "flash_attention_kernel_fma" in e["name"]]
    grids = [int(np.prod(e.get("args", {}).get("grid", [0]))) for e in fma]
    big = max(grids, default=0)
    return {"flash_f32_launches": len(fma),
            "flash_f32_device_ms_per_step":
                sum(e["dur"] for e in fma) / 1e3 / steps,
            "flash_f32_largest_grid": big or None,
            "flash_f32_largest_grid_device_ms_per_step":
                sum(e["dur"] for e, g in zip(fma, grids) if g == big)
                / 1e3 / steps if big else None}


#: each trained model's parameter count at full width and its
#: ``TRAIN_DEPTH`` (full depth where it has none)
TRAIN_PARAMS = {ARCH: 3_397_627_904, MAMBA: 780_222_720,
                SEAMLESS: 977_860_608, PALIGEMMA: 3_035_703_296,
                MOONSHOT: 4_094_453_760}
#: the trainers' depth cuts (full width): moonshot-v1-16b-a3b at 6 of 48
#: layers, 4.09 B parameters, ~65.5 GB in Mode U before activations (a
#: fused step keeps ~16 B a parameter: bf16 live and ring slots, f32
#: moments, bf16 gradients)
TRAIN_DEPTH = {MOONSHOT: 6}
#: the AdamW warm-up of each trainer (``Trainer``'s default 10 elsewhere):
#: at 10, a trainer's first 10 losses stay flat
TRAIN_WARMUP = {SEAMLESS: 2, PALIGEMMA: 2, MOONSHOT: 2}
#: each trainer's steps where it is not ``TRAIN_STEPS``: mamba2-780m 12
#: (its loss falls from step 10, as the warm-up ends), seamless-m4t-medium
#: (a step ~4x qwen2.5-3b's) and paligemma-3b 10; moonshot-v1-16b-a3b
#: keeps 20, since after 10 steps its loss had not fallen yet (the mean
#: of its last 5 above that of its first 5, 12.700 against 12.685)
STEPS = {MAMBA: 12, SEAMLESS: 10, PALIGEMMA: 10}


#: the rows ``roofline_read`` writes to ``build/roofline.jsonl`` (the
#: JAX package's ``benchmarks/roofline_report`` row keys)
ROOFLINE_ROWS = []
ROOFLINE_JSONL = os.path.join(HERE, "build", "roofline.jsonl")


def roofline_read(torch, rec, cfg, shape, arch, step_s, *, mode, peak,
                  reduced=None):
    """One row of the roofline table from a step counted on the card
    (``rec``, a ``launch.roofline.count()`` record) and the step's p50
    time ``step_s``: ``model_flops``, the counted flops and bytes, the
    bytes of score-shaped products (the plain attention backward's),
    ``mfu`` (model flops over the step's time at the bf16 peak), the
    hardware share (counted flops over the same) and
    ``roofline_terms``."""
    from repro_torch.launch import roofline as RL
    from repro_torch.models import model_zoo as zoo

    S = shape.seq_len
    scores = {(S, S)} if shape.kind != "decode" else set()
    if cfg.is_encdec and shape.kind != "decode":
        scores |= {(cfg.frontend_len, cfg.frontend_len),
                   (S, cfg.frontend_len)}
    mf = zoo.model_flops(cfg, shape)
    at_peak = step_s * RL.PEAK_FLOPS["bfloat16"]
    terms = RL.roofline_terms(cfg, shape, cost=rec.cost(),
                              collectives=RL.collective_bytes(rec),
                              n_chips=1)
    row = {"arch": arch, "shape": shape.name, "mesh": "1xH100",
           "mv_mode": mode, "status": "ok", "reduced": reduced,
           "memory": {"peak_bytes_per_device": peak},
           "layers": cfg.n_layers, "batch": shape.global_batch,
           "seq_len": S, "model_flops": mf, "flops": rec.flops,
           "bytes": rec.bytes,
           "attention_score_bytes": sum(RL.attention_score_bytes(rec, q, k)
                                        for q, k in sorted(scores)),
           "step_s_p50": step_s, "mfu": mf / at_peak,
           "hw_flops_share": rec.flops / at_peak,
           "kernels": rec.kernels, "roofline": terms}
    emit({"roofline_row": f"{shape.kind}_{arch}", **row})
    check(mf > 0 and rec.flops > 0 and rec.bytes > 0
          and np.isfinite(row["mfu"]) and not rec.collectives,
          f"roofline {arch} {shape.name}: {rec.summary()}")
    ROOFLINE_ROWS.append(row)
    return row


def train_trial(torch, launches, arch=ARCH):
    """``Trainer`` over ``arch`` at full width and depth, or its
    ``TRAIN_DEPTH`` cut (bfloat16, random weights from ``SEED``, 4 x 512
    positions a step: for paligemma-3b 256 patch embeddings and 256
    tokens; for seamless-m4t-medium beside the data pipeline's 4096
    float32 frame embeddings, so its encoder runs in float32) for
    ``STEPS`` steps under ``TrainSupervisor.run`` (checkpoints beyond the
    last step: one would be 40 GB of ``.npy`` for qwen2.5-3b), AdamW
    warming up over ``TRAIN_WARMUP`` steps (the ``Trainer``'s default
    10 where it has none), Mode U with the fused commit and a 2-slot
    ring.  Launch counters are set to 0 just before
    the run and read just after; every step must launch ``fused_adamw``
    once per leaf and the arch's sequence kernel (``flash_attention``,
    or ``ssd_scan`` through ``SSDScanFn``) at least twice per layer
    (forward and recompute; an encoder-decoder's 36 attentions).
    After each step a reader one step behind must get an ``ok`` snapshot
    whose leaf checksums are the previous step's live ones.  Then one
    more step under a profiler trace (idle share, the device time of
    ``fused_adamw`` and of the sequence kernel; for ``flash_attention``
    also of its float32 (FMA) launches, and of those with the largest
    grid: an encoder-decoder's encoder).
    Last, one more step counted by ``launch.roofline.count()``
    (``roofline_read``)."""
    from torch.profiler import ProfilerActivity

    from repro_torch import kernels as K
    from repro_torch.configs import MVStoreConfig, ShapeConfig, get_config
    from repro_torch.core import mvstore
    from repro_torch.kernels import fused_adamw as FW
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.train import Trainer
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault_tolerance import TrainSupervisor

    cfg = get_config(arch)
    reduced = None
    if arch in TRAIN_DEPTH:
        reduced = f"depth {TRAIN_DEPTH[arch]} of {cfg.n_layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_DEPTH[arch])
    warmup = TRAIN_WARMUP.get(arch, 10)
    steps = STEPS.get(arch, TRAIN_STEPS)
    seq_kernel = PREFILL_KERNEL[arch]
    shape = ShapeConfig("train_chip", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, shape,
                      mvcfg=MVStoreConfig(mode="U", fused_commit=True),
                      opt_cfg=adamw.AdamWConfig(warmup_steps=warmup),
                      seed=SEED)
    state, trainer.state = trainer.state, None
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in mvstore._flatten(state.mv.live))
    n_leaves = len(mvstore._flatten(state.mv.live))
    bound_ms = sum(FW.work(t, t, None, None, state.mv.ring.get(path), 0,
                           None)[1]
                   for path, t in mvstore._flatten(state.mv.live)) \
        / RL.HBM_BW * 1e3
    prev = [_checksums(torch, state.mv.live)]
    losses, step_s, snaps = [], [], []
    mark = [0.0]

    def on_step(step, st, metrics):
        step_s.append(time.perf_counter() - mark[0])
        losses.append(float(metrics["loss"]))
        view, ok = mvstore.mv_snapshot(st.mv, st.mv.clock - 1)
        snaps.append(bool(ok) and _checksums(torch, view) == prev[0])
        del view
        prev[0] = _checksums(torch, st.mv.live)
        mark[0] = time.perf_counter()

    ckpt_dir = os.path.join(HERE, "build", "train_ckpt")
    sup = TrainSupervisor(ckpt_dir=ckpt_dir, ckpt_every=steps + 1,
                          reader=trainer.snapshot_reader())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_stats()
    K.reset_launch_counts()
    # the run gets the only reference to the initial state: held here,
    # its live blocks (the fused commit's old parameters) would stay on
    # the card through every step and count in the peak
    held = [state]
    del state
    mark[0] = t0 = time.perf_counter()
    try:
        step, state = sup.run(state=held.pop(),
                              train_step=trainer.train_step,
                              batch_at=trainer.batch_at,
                              n_steps=steps, on_step=on_step)
    finally:
        sup.manager.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    alloc = {k: torch.cuda.memory_stats()[k] - alloc0[k]
             for k in ("num_alloc_retries", "num_device_alloc",
                       "num_device_free")}
    for k, v in counts.items():
        launches[k] += v
    tokens = TRAIN_SEQ * TRAIN_BATCH
    row = {"trial": f"train_{arch}", "mode": "U", "fused_commit": True,
           "ring_slots": 2, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
           "layers": cfg.n_layers, "reduced": reduced,
           "warmup_steps": warmup,
           "steps": step, "params": n_params, "leaves": n_leaves,
           "init_s": init_s, "seconds": dt, "losses": losses,
           "first_step_s": step_s[0],
           "step_s_p50": float(np.percentile(step_s[1:], 50)),
           "step_s_p99": float(np.percentile(step_s[1:], 99)),
           "tokens_per_s": tokens * len(step_s[1:]) / sum(step_s[1:]),
           "snapshots_ok": sum(snaps), "restarts": sup.restarts,
           "max_memory_allocated": peak, "allocator": alloc,
           "fused_adamw_bound_ms_per_step": bound_ms,
           "fused_adamw_launches_per_step": counts["fused_adamw"] / step,
           f"{seq_kernel}_launches_per_step": counts[seq_kernel] / step,
           "launches": counts}
    # phase 9's window, taken while the trainer is up
    prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    t0, n = time.perf_counter(), 1
    state, metrics = trainer.train_step(state, trainer.batch_at(step))
    enqueue = time.perf_counter() - t0
    float(metrics["loss"])
    torch.cuda.synchronize()
    window = time.perf_counter() - t0
    prof.stop()
    # one more step, counted: the count costs host time on every
    # operation, so it stays outside the timed and traced windows
    with RL.count() as rec:
        state, metrics = trainer.train_step(state,
                                            trainer.batch_at(step + n))
    float(metrics["loss"])
    trainer.controller.stop()
    restarts, events = sup.restarts, sup.events
    del state, trainer, sup
    free_card(torch)
    gpu = gpu_events(prof)
    ev, busy_us = len(gpu), sum(e["dur"] for e in gpu)
    fa_us, seq_us = (kernel_us(gpu, DEVICE_KERNELS[k])
                     for k in ("fused_adamw", seq_kernel))
    row.update({"trace_window_s": window, "trace_steps": n,
                "host_enqueue_s_per_step": enqueue / n,
                "device_busy_ms": busy_us / 1e3 if ev else None,
                "device_idle_share": 1 - busy_us / 1e3 / (window * 1e3)
                if ev else None,
                "fused_adamw_device_ms_per_step": fa_us / 1e3 / n
                if ev else None,
                f"{seq_kernel}_device_ms_per_step": seq_us / 1e3 / n
                if ev else None})
    if seq_kernel == "flash_attention" and ev:
        row.update(flash_f32_split(gpu, n))
    emit(row)
    K.reset_launch_counts()
    check(n_params == TRAIN_PARAMS[arch],
          f"train {arch}: {n_params} parameters")
    check(step == steps and restarts == 0,
          f"train: {step} steps, {restarts} restarts: {events}")
    check(all(np.isfinite(losses)), f"train: a loss is not finite: {losses}")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"train: the loss did not fall: {losses}")
    check(all(snaps), "train: a one-behind snapshot was not ok or not the "
                      f"previous step's parameters: {snaps}")
    check(counts["fused_adamw"] == n_leaves * steps,
          f"train: {counts['fused_adamw']} fused_adamw launches for "
          f"{n_leaves} leaves x {steps} steps")
    layers = prefill_launches(cfg)[seq_kernel]
    check(counts[seq_kernel] >= 2 * layers * steps,
          f"train: {counts[seq_kernel]} {seq_kernel} launches for "
          f"{layers} layers x (forward + recompute) x {steps} steps")
    check(counts["snapshot_select"] > 0, "train: no snapshot_select launch")
    kernels = rec.kernels
    check(kernels.get("fused_adamw", [0])[0] == n_leaves
          and kernels.get(seq_kernel, [0])[0] >= 2 * layers,
          f"train {arch}: the counted step's kernels {kernels}")
    roofline_read(torch, rec, cfg, shape, arch, row["step_s_p50"],
                  mode="U", peak=peak, reduced=reduced)
    return row


def supervisor_drill(torch):
    """``TrainSupervisor`` on the card at the reduced config (Mode U fused,
    2 x 32 tokens, checkpoints every 2 steps): a failure injected at step
    3 restores step 2 and replays, and every step's loss equals the
    uninterrupted run's."""
    from repro_torch.configs import MVStoreConfig, ShapeConfig, smoke_config
    from repro_torch.launch.train import Trainer
    from repro_torch.runtime.fault_tolerance import FaultPlan, \
        TrainSupervisor

    runs = {}
    for name, fault in (("uninterrupted", None),
                        ("failure_at_3", FaultPlan(fail_at_steps=(3,)))):
        tr = Trainer(smoke_config(ARCH), ShapeConfig("drill", 32, 2, "train"),
                     mvcfg=MVStoreConfig(mode="U", fused_commit=True),
                     seed=SEED)
        ckpt = os.path.join(HERE, "build", "drill_ckpt", name)
        shutil.rmtree(ckpt, ignore_errors=True)
        sup = TrainSupervisor(ckpt_dir=ckpt, ckpt_every=2,
                              reader=tr.snapshot_reader())
        losses = {}
        try:
            step, _ = sup.run(state=tr.state, train_step=tr.train_step,
                              batch_at=tr.batch_at, n_steps=6,
                              fault_plan=fault,
                              on_step=lambda s, st, m: losses.__setitem__(
                                  s, float(m["loss"])))
        finally:
            tr.controller.stop()
            sup.manager.close()
        runs[name] = (step, sup.restarts, sup.events, losses,
                      sup.manager.stats())
    (s0, r0, _, l0, _), (s1, r1, ev1, l1, st1) = runs.values()
    row = {"drill": "supervisor_restart", "steps": s1, "restarts": r1,
           "restored_at": [e[1] for e in ev1 if e[0] == "restored"],
           "losses_equal": l0 == l1, "losses": l1}
    emit(row)
    check(s0 == s1 == 6 and r0 == 0 and r1 == 1 and
          row["restored_at"] == [2] and st1["errors"] == 0,
          f"supervisor drill: {runs['failure_at_3'][:3]}")
    check(l0 == l1, f"supervisor drill: replayed losses {l1} differ from "
                    f"the uninterrupted run's {l0}")
    shutil.rmtree(os.path.join(HERE, "build", "drill_ckpt"),
                  ignore_errors=True)
    return row


# ---------------------------------------------------------------------------
# phase 5: the eval and the transactional structures
# ---------------------------------------------------------------------------

EVAL_WORKLOADS = ("longread", "rwmix", "structrq")
#: the at-scale structure trial (the paper's WorkloadConfig holds 1,000,000
#: keys in a 2,000,000 range; prefilled through the insert path, which is
#: host-bound, the run's time limit cuts it to these sizes: 65,536 and
#: 16,384 keys until the sharded store's phase joined the run, which then
#: passed 700 s)
AT_SCALE = {"hashmap": {"keys": 49_152, "key_range": 98_304,
                        "n_buckets": 1 << 16},
            "extbst": {"keys": 12_288, "key_range": 24_576},
            "abtree": {"keys": 12_288, "key_range": 24_576}}
RQ_SIZE = 10_000               # the paper's range-query size
PREFILL_PER_TXN = 256


class _AbortCauses:
    """Counts the MVStore backend's aborts by cause while it is entered:
    ``MVStoreHandle._abort_ctx`` is wrapped and each abort is classified
    by the method that raised it (a ring read that left the window or
    lost the seqlock race, an unversioned read that saw the clock
    advance, a versioned transaction that wrote, a commit that lost
    validation).  ``take()`` returns the counts since the last call."""

    CAUSES = {"read": "clock_advanced", "read_bulk": "clock_advanced",
              "write": "versioned_write", "write_bulk": "versioned_write",
              "commit": "commit_conflict", "abort": "rollback"}

    def __init__(self):
        self.counts = defaultdict(int)

    def __enter__(self):
        from repro_torch.api.mvhandle import MVStoreHandle, _RACED

        inner, counts, causes = MVStoreHandle._abort_ctx, self.counts, \
            self.CAUSES

        def counted(handle, ctx):
            caller = sys._getframe(1)
            name = caller.f_code.co_name
            if name == "_versioned_read":
                cause = ("ring_seqlock_race"
                         if caller.f_locals.get("out") is _RACED
                         else "ring_window")
            else:
                cause = causes.get(name, name)
            counts[cause] += 1
            return inner(handle, ctx)

        self._cls, self._inner = MVStoreHandle, inner
        MVStoreHandle._abort_ctx = counted
        return self

    def __exit__(self, *exc):
        self._cls._abort_ctx = self._inner

    def take(self):
        out = dict(self.counts)
        self.counts.clear()
        return out


class _MirrorHits:
    """Counts, while entered, multiverse's versioned bulk-read batches in
    which the mirror resolved at least one word
    (``MultiversePolicy._bulk_versioned_gather``) into a batch on the
    card: each such batch writes its hits with one ``scatter_write``
    launch.  A call's hits are the entries its own ``ok`` array turned
    True (the policy's shared hit counter would also show another
    thread's hits landing during the call).  Whether a batch has hits
    depends on a writer racing the read, so a timed run may have none.
    ``take()`` returns the count since the last call."""

    def __init__(self):
        self.batches = 0

    def __enter__(self):
        import torch

        from repro_torch.core.stm import MultiversePolicy

        inner = MultiversePolicy._bulk_versioned_gather

        def counted(policy, eng, addrs, vals, ok, *a):
            misses = int((~ok).sum())
            out = inner(policy, eng, addrs, vals, ok, *a)
            self.batches += (int((~out[1]).sum()) < misses
                             and isinstance(vals, torch.Tensor)
                             and vals.is_cuda)
            return out

        self._cls, self._inner = MultiversePolicy, inner
        MultiversePolicy._bulk_versioned_gather = counted
        return self

    def __exit__(self, *exc):
        self._cls._bulk_versioned_gather = self._inner

    def take(self):
        n, self.batches = self.batches, 0
        return n


def _eval_row(row, causes):
    """An eval row as printed: its keys but the stats, the abort counts of
    ``stm_stats`` and, for the MVStore, the abort causes."""
    st = row["stm_stats"]
    out = {k: v for k, v in row.items() if k != "stm_stats"}
    out["stm_aborts"] = st["aborts"]
    out["stm_commits"] = st["commits"]
    out["stm_ro_commits"] = st["ro_commits"]
    out["stm_versioned_commits"] = st["versioned_commits"]
    out["stm_mode"] = st["mode"]
    if row["backend"] == "mvstore":
        out["abort_causes"] = causes
    return out


def _progress(row):
    """Did the trial commit work on both sides?  Updaters must commit on
    every backend; the long read must complete on the versioned backends
    (an unversioned scan may starve: the paper's result)."""
    versioned = row["backend"] in ("multiverse", "mvstore")
    if "scans_per_sec" in row:
        return row["updates_per_sec"] > 0 and (
            row["scans_per_sec"] > 0 or not versioned)
    if "checks_per_sec" in row:
        return row["updates_per_sec"] > 0 and row["checks_per_sec"] > 0
    return row["updates_per_sec"] > 0 and row["rq_solo_per_sec"] > 0 and (
        row["rqs_per_sec"] > 0 or not versioned)


def eval_phase(torch):
    """``run_eval`` of longread, rwmix and structrq at their full variants
    on the card (every backend of each workload's default set), the launch
    counts read around each run: every row must see its invariant
    (``violations == 0``) and make progress, and each run must launch the
    kernels of its path.  Prints each row (failed scans and updates, the
    abort counts, the MVStore's abort causes) and each headline."""
    from repro_torch import kernels as K
    from repro_torch.eval import (
        longread_headline,
        run_eval,
        rwmix_headline,
        structrq_headline,
    )

    headline = {"longread": longread_headline, "rwmix": rwmix_headline,
                "structrq": structrq_headline}
    #: the kernels each workload's run must launch (the MVStore publishes
    #: through commit_fused; structrq's defaults do not include it, and
    #: its structures' write sets stay under the bulk write-back's
    #: threshold, so its scatter_write launches are the mirror-hit
    #: batches', gated below)
    needs = {"longread": ("gather_read", "gather_bracketed", "scatter_write",
                          "commit_fused"),
             "rwmix": ("gather_read", "gather_bracketed", "scatter_write",
                       "validate", "commit_fused"),
             "structrq": ("gather_read", "gather_bracketed")}
    totals = defaultdict(int)
    with _AbortCauses() as causes, _MirrorHits() as hits:
        for w in EVAL_WORKLOADS:
            rows = []
            t0 = time.perf_counter()
            K.reset_launch_counts()
            hits.take()
            run_eval(w, save=False,
                     progress=lambda r: rows.append(
                         _eval_row(r, causes.take())))
            torch.cuda.synchronize()
            launches = K.launch_counts()
            hit_batches = hits.take()
            for r in rows:
                emit(r)
                check(r["violations"] == 0,
                      f"eval {w}/{r['variant']} {r['backend']}: violations")
                check(_progress(r), f"eval {w}/{r['variant']} "
                                    f"{r['backend']}: no progress")
            emit({"eval": w, "seconds": time.perf_counter() - t0,
                  "trials": len(rows), "launches": launches,
                  "mirror_hit_batches": hit_batches,
                  "headline": headline[w](rows)})
            for k in needs[w]:
                check(launches[k] > 0, f"eval {w} launched no {k}")
            check(launches["scatter_write"] >= hit_batches,
                  f"eval {w}: {launches['scatter_write']} scatter_write "
                  f"launches for {hit_batches} mirror-hit batches")
            for k, v in launches.items():
                totals[k] += v
    return totals


class _Rounds:
    """A transaction handle that counts a traversal's rounds (its
    ``read_bulk`` calls) and the ``gather_bracketed`` launches each makes,
    marks its scalar reads with a profiler range and counts the
    synchronizing operations they make (``scalar_syncs``, read off a
    ``_SyncLog``), and times its ``read_bulk`` calls (``read_bulk_s``)."""

    def __init__(self, tx, torch, syncs):
        self._tx, self._ctx, self._torch = tx, tx._ctx, torch
        self._syncs = syncs
        self.per_round, self.reads, self.read_bulk_s = [], 0, 0.0
        self.scalar_syncs = 0

    def read(self, addr):
        self.reads += 1
        n0 = len(self._syncs)
        with self._torch.profiler.record_function("scalar_read"):
            out = self._tx.read(addr)
        self.scalar_syncs += len(self._syncs) - n0
        return out

    def read_bulk(self, addrs):
        from repro_torch import kernels as K

        before = K.launch_counts()["gather_bracketed"]
        t0 = time.perf_counter()
        out = self._tx.read_bulk(addrs)
        self.read_bulk_s += time.perf_counter() - t0
        self.per_round.append(K.launch_counts()["gather_bracketed"]
                              - before)
        return out


@contextlib.contextmanager
def _wrapped(wrap_callback, wrap_copy=None):
    """The structures' traversals with every ``expand``/``advance`` as
    ``wrap_callback(fn)`` and, given ``wrap_copy``, the round's copy home
    (``traverse.host_words``, the hashmap's head copy) as
    ``wrap_copy(host_words)``."""
    from repro_torch.core.engine import traverse
    from repro_torch.structs import abtree, extbst, hashmap

    saved = (extbst.traverse_bulk, abtree.traverse_bulk, hashmap.chase_bulk,
             traverse.host_words, hashmap.host_words)
    trav, chase, copy = saved[0], saved[2], saved[3]
    extbst.traverse_bulk = abtree.traverse_bulk = \
        lambda tx, roots, expand, **kw: trav(tx, roots,
                                             wrap_callback(expand), **kw)
    hashmap.chase_bulk = lambda tx, cursors, advance: chase(
        tx, cursors, wrap_callback(advance))
    if wrap_copy is not None:
        traverse.host_words = hashmap.host_words = wrap_copy(copy)
    try:
        yield
    finally:
        (extbst.traverse_bulk, abtree.traverse_bulk, hashmap.chase_bulk,
         traverse.host_words, hashmap.host_words) = saved


def _within(events, ranges):
    """The ``events`` (trace events with ``ts`` and ``tid``) that start
    inside one of ``ranges`` (same-named trace events) on their thread."""
    by_tid = defaultdict(list)
    for e in ranges:
        by_tid[e.get("tid")].append((e["ts"], e["ts"] + e["dur"]))
    for spans in by_tid.values():
        spans.sort()
    starts = {t: [lo for lo, _ in spans] for t, spans in by_tid.items()}
    out = []
    for e in events:
        spans = by_tid.get(e.get("tid"))
        if not spans:
            continue
        i = bisect.bisect_right(starts[e.get("tid")], e["ts"]) - 1
        if i >= 0 and e["ts"] < spans[i][1]:
            out.append(e)
    return out


class _SyncLog:
    """The warnings recorded while ``torch.cuda.set_sync_debug_mode`` warns
    on every synchronizing operation (``records`` is the recording list
    while one is open); ``len()`` counts them."""

    def __init__(self):
        self.records = []

    def __len__(self):
        return len(self.records)


def traversal_trace(torch, tm, query):
    """Three quiescent runs of ``query(tx)`` (a tree range query or the
    hashmap's size query), on one thread (the caller stopped every
    other):

      1. under ``torch.cuda.set_sync_debug_mode("warn")``, each
         synchronizing operation (a copy home, ``.item()``, a wait)
         recorded as its warning: the rounds, the ``gather_bracketed``
         launches of each (the wrapper's count), the synchronizing
         operations per round outside the scalar reads (the round's
         copies home) and inside the ``expand``/``advance`` calls;
      2. under a ``torch.profiler`` trace of the host and the card, the
         query and its scalar reads in profiler ranges: the
         ``gather_bracketed`` kernels and the device-to-host copies
         outside the scalar reads that the trace holds (a trace can miss
         GPU records, so both are read as upper bounds);
      3. timed by the host clock alone, its time split into the rounds'
         ``read_bulk`` calls (the bracketed gather, the copy of the lock
         words home and the verdict), their copies home and the
         ``expand``/``advance`` calls.
    """
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import run

    log, counted = _SyncLog(), []

    def body(tx):
        c = _Rounds(tx, torch, log)
        n0 = len(log)
        with torch.profiler.record_function("query"):
            t0 = time.perf_counter()
            out = query(c)
            c.query_s = time.perf_counter() - t0
        c.syncs = len(log) - n0
        counted.append(c)
        return out

    run(tm, body, tid=0)                     # warm

    inside = [0, 0]                          # expand calls, their syncs

    def watched(fn):
        def call(*args):
            n0 = len(log)
            try:
                return fn(*args)
            finally:
                inside[0] += 1
                inside[1] += len(log) - n0
        return call

    with warnings.catch_warnings(record=True) as caught, _wrapped(watched):
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        log.records = caught
        try:
            result = run(tm, body, tid=0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            log.records = []
    synced = counted[-1]
    rounds = len(synced.per_round)

    for attempt in range(3):                 # a trace may miss GPU work
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(tm, body, tid=0)
            torch.cuda.synchronize()
        os.makedirs(TRACE_DIR, exist_ok=True)
        path = os.path.join(TRACE_DIR, f"traverse_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        kernels = sum(1 for e in events if e.get("cat") == "kernel"
                      and "gather_bracketed_kernel" in e.get("name", ""))
        if kernels:
            break
    named = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e:
            named[e["name"]].append(e)
    dtoh = {e["args"]["correlation"] for e in events
            if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")}
    copies = [e for e in events if e.get("cat") == "cuda_runtime"
              and e.get("args", {}).get("correlation") in dtoh]
    in_query = _within(copies, named["query"])
    scalar = _within(in_query, named["scalar_read"])

    spent = defaultdict(float)

    def timed(key):
        def wrap(fn):
            def call(*args):
                t0 = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    spent[key] += time.perf_counter() - t0
            return call
        return wrap

    with _wrapped(timed("expand"), timed("copy_home")):
        run(tm, body, tid=0)
    c = counted[-1]
    split = {"query_ms": c.query_s * 1e3,
             "read_bulk_ms": c.read_bulk_s * 1e3,
             "copy_home_ms": spent["copy_home"] * 1e3,
             "expand_ms": spent["expand"] * 1e3}
    split["rest_ms"] = split["query_ms"] - sum(
        split[k] for k in ("read_bulk_ms", "copy_home_ms", "expand_ms"))
    return {"result": result, "rounds": rounds,
            "gather_bracketed_per_round": synced.per_round,
            "scalar_reads": synced.reads,
            "syncs": synced.syncs,
            "syncs_in_scalar_reads": synced.scalar_syncs,
            "syncs_per_round": (synced.syncs - synced.scalar_syncs)
            / max(rounds, 1),
            "expand_calls": inside[0], "expand_syncs": inside[1],
            "traced_gather_bracketed": kernels,
            "traced_dtoh_copies": len(in_query) - len(scalar),
            "trace_attempts": attempt + 1,
            "host_split": split}


def _at_scale_params():
    from repro_torch.configs.paper_stm import MultiverseParams

    return MultiverseParams(k1=2, k2=3, k3=3, lock_table_bits=16)


def _at_scale_keys(cfg):
    return random.Random(SEED * 7919 + 11).sample(range(cfg["key_range"]),
                                                  cfg["keys"])


def prefill_structure(kind, cfg):
    """``kind``'s at-scale structure (``cfg``, its ``AT_SCALE``) prefilled
    through its insert path, ``PREFILL_PER_TXN`` keys to a transaction, on
    a multiverse engine on the CPU (bit-identical to the card's: phase 3,
    ``tests/test_torch_structs.py``; on the card each scalar read is a
    device sync).  Returns what ``install_structure`` carries to the
    card: the heap buffer and its length, the lock words, the clock and
    the mode (numpy and ints), the structure's fields, and the prefill's
    seconds.  ``StructurePrefills`` runs it in a spawned process, so it
    stays on one core."""
    import torch

    from repro_torch.api import run
    from repro_torch.structs import STRUCTS

    torch.set_num_threads(1)
    host = _make("multiverse", 2, _at_scale_params(), device="cpu")
    s = STRUCTS[kind](host, **({"n_buckets": cfg["n_buckets"]}
                               if kind == "hashmap" else {}))
    keys = _at_scale_keys(cfg)
    t0 = time.perf_counter()
    for i in range(0, len(keys), PREFILL_PER_TXN):
        run(host, lambda tx, ks=keys[i:i + PREFILL_PER_TXN]: [
            s.insert(tx, k, INITIAL) for k in ks], tid=0)
    seconds = time.perf_counter() - t0
    raw = host.raw
    # a single-thread prefill never leaves Mode Q: no version list to carry
    check(raw.policy.vlt.nonempty_count == 0,
          f"prefill {kind}: the engine holds versions")
    out = {"heap": raw.heap._buf.numpy().copy(), "n": len(raw.heap),
           "locks": raw.locks._words.numpy().copy(),
           "clock": raw.clock.load(), "mode": raw.policy.mode_name(raw),
           "fields": {k: v for k, v in vars(s).items() if k != "tm"},
           "seconds": seconds}
    host.stop()
    return out


class StructurePrefills:
    """``prefill_structure`` of each ``AT_SCALE`` structure, in one
    spawned process started at the beginning of the run: the prefills
    are one Python insert a key (~30 s for the three on the host of an
    NVIDIA H100 80GB HBM3, 700.00 W) and run beside phases 1-4 on a core
    of their own.  ``get`` waits for
    one; ``close`` stops the process."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing

        self._pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        self._futures = {k: self._pool.submit(prefill_structure, k, cfg)
                         for k, cfg in AT_SCALE.items()}

    def get(self, kind):
        return self._futures[kind].result()

    def close(self):
        self._pool.shutdown(cancel_futures=True)


def install_structure(torch, kind, got):
    """A multiverse engine on the card holding ``got`` (a
    ``prefill_structure`` result: the heap buffer, the lock row and the
    clock, one copy each) and ``kind``'s structure over it."""
    from repro_torch.structs import STRUCTS

    tm = _make("multiverse", 2, _at_scale_params())
    d = tm.raw
    check(d.policy.mode_name(d) == got["mode"],
          f"prefill {kind}: mode {got['mode']} against the card's "
          f"{d.policy.mode_name(d)}")
    d.heap._install(torch.from_numpy(got["heap"]).to(d.device), got["n"])
    d.locks._words.copy_(torch.from_numpy(got["locks"]))
    d.clock.store(got["clock"])
    torch.cuda.synchronize()
    s = STRUCTS[kind].__new__(STRUCTS[kind])
    vars(s).update(got["fields"], tm=tm)
    return tm, s


def at_scale_trial(torch, kind, prefilled, window_s=1.0, warmup_s=0.5):
    """One structure at the size ``AT_SCALE`` gives, on multiverse on the
    card, prefilled through its insert path ``PREFILL_PER_TXN`` keys to a
    transaction (``prefilled``: a ``prefill_structure`` result, carried
    to the card by ``install_structure``), then one reader beside one
    updater:

      * a tree serves ``RQ_SIZE``-key range queries from seeded ``lo``
        while the updater moves value between the keys of fixed adjacent
        pairs (key ``2j`` and ``2j + 1`` in key order, each starting at
        ``INITIAL``): a completed query must return exactly the
        ``RQ_SIZE`` keys at and after ``lo`` and see every whole pair
        sum to ``2 * INITIAL`` (a torn snapshot breaks a pair);
      * the hashmap serves whole-map size queries while the updater moves
        keys (structrq's size-preserving move): a completed query must
        count exactly the prefill.

    Then one quiescent query under a profiler trace
    (``traversal_trace``)."""
    from repro_torch.api import MaxRetriesExceeded, run

    cfg = AT_SCALE[kind]
    n, key_range = cfg["keys"], cfg["key_range"]
    t0 = time.perf_counter()
    tm, s = install_structure(torch, kind, prefilled)
    install_s = time.perf_counter() - t0
    order = sorted(_at_scale_keys(cfg))

    if kind == "hashmap":
        def query(tx, r):
            return s.size_query(tx)

        def verify(got, _):
            return got == n

        def update(tx, r):
            ka, kb = r.randrange(key_range), r.randrange(key_range)
            if s.delete(tx, ka):
                if not s.insert(tx, kb, INITIAL):
                    s.insert(tx, ka, INITIAL)
    else:
        def query(tx, r):
            i = r.randrange(n - RQ_SIZE)
            return i, s.range_query(tx, order[i], RQ_SIZE)

        def verify(got, _):
            i, pairs = got
            ks = [int(k) for k, _ in pairs]
            vs = [int(v) for _, v in pairs]
            if ks != order[i:i + RQ_SIZE]:
                return False
            first = i + (i & 1)              # the first whole pair
            return all(vs[g - i] + vs[g + 1 - i] == 2 * INITIAL
                       for g in range(first, i + RQ_SIZE - 1, 2))

        def update(tx, r):
            j = 2 * r.randrange(n // 2)
            ka, kb = (order[j], order[j + 1]) if r.random() < 0.5 else \
                (order[j + 1], order[j])
            s.insert(tx, ka, s.search(tx, ka) - AMOUNT)
            s.insert(tx, kb, s.search(tx, kb) + AMOUNT)

    def reader(stop, c):
        r = random.Random(SEED * 10007 + 500)
        while not stop.is_set():
            try:
                got = run(tm, lambda tx: query(tx, r), tid=0,
                          max_retries=60)
            except MaxRetriesExceeded:
                c["failed_queries"] += 1
                continue
            c["queries"] += 1
            if not verify(got, r):
                c["violations"] += 1

    def updater(stop, c):
        r = random.Random(SEED * 10007 + 600)
        while not stop.is_set():
            try:
                run(tm, lambda tx: update(tx, r), tid=1, max_retries=2000)
                c["updates"] += 1
            except MaxRetriesExceeded:
                c["failed_updates"] += 1

    tot, dt = run_trial([reader, updater], window_s, warmup_s)
    tm.raw.stop()                # the background thread: one thread left
    r = random.Random(SEED + 3)
    trace = traversal_trace(torch, tm, lambda tx: query(tx, r))
    result = trace.pop("result")
    stats = tm.stats()
    tm.stop()
    row = {"trial": f"at_scale_{kind}", "backend": "multiverse",
           "structure": kind, "keys": n, "key_range": key_range,
           "rq_size": RQ_SIZE if kind != "hashmap" else None,
           "prefill_per_txn": PREFILL_PER_TXN,
           "prefill_s": prefilled["seconds"], "install_s": install_s,
           "seconds": dt, "queries": tot["queries"],
           "queries_per_s": tot["queries"] / dt,
           "failed_queries": tot["failed_queries"],
           "updates_per_s": tot["updates"] / dt,
           "failed_updates": tot["failed_updates"],
           "violations": tot["violations"],
           "stm_aborts": stats["aborts"], "stm_mode": stats["mode"],
           "mode_transitions": stats["mode_transitions"],
           "trace": trace}
    check(verify(result, None), f"at_scale_{kind}: the quiescent query's "
                                "answer is wrong")
    check(tot["queries"] > 0 and tot["updates"] > 0,
          f"at_scale_{kind}: no progress ({dict(tot)})")
    check(trace["rounds"] > 1 and all(
        g == 1 for g in trace["gather_bracketed_per_round"])
        and trace["traced_gather_bracketed"] <= trace["rounds"],
        f"at_scale_{kind}: a traversal round did not take one "
        f"gather_bracketed ({trace['gather_bracketed_per_round']}; "
        f"{trace['traced_gather_bracketed']} traced)")
    check(1 <= trace["syncs_per_round"] <= 2
          and trace["traced_dtoh_copies"] <= 2 * trace["rounds"],
          f"at_scale_{kind}: {trace['syncs']} synchronizing operations "
          f"({trace['syncs_in_scalar_reads']} in scalar reads) and "
          f"{trace['traced_dtoh_copies']} traced device-to-host copies "
          f"over {trace['rounds']} rounds")
    check(trace["expand_calls"] > 0 and trace["expand_syncs"] == 0,
          f"at_scale_{kind}: {trace['expand_syncs']} synchronizing "
          "operations inside expand/advance")
    return row


def structures_phase(torch, prefills):
    """The at-scale trial of each structure (its prefill from
    ``prefills``, a ``StructurePrefills``), the launch counts read around
    each: every one must launch ``gather_bracketed``."""
    from repro_torch import kernels as K

    totals = defaultdict(int)
    for kind in AT_SCALE:
        got = prefills.get(kind)
        K.reset_launch_counts()
        row = at_scale_trial(torch, kind, got)
        torch.cuda.synchronize()
        row["launches"] = K.launch_counts()
        emit(row)
        check(row["violations"] == 0, f"{row['trial']}: violations")
        check(row["launches"]["gather_bracketed"] > 0,
              f"{row['trial']} launched no gather_bracketed")
        for k, v in row["launches"].items():
            totals[k] += v
    return totals


# ---------------------------------------------------------------------------
# phase 6: the sharded store
# ---------------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4)
#: the at-scale store: the words phase 4's mvstore_1M trial holds, striped
#: over the shards in spans of SHARD_SPAN
SHARD_WORDS, SHARD_SPAN = 1_000_000, 8192
SHARD_RING = 8                 # mvstore_1M's ring depth
CROSS_EVERY = 16               # one update in 16 spans two shards


def seeded_history(seed, n_words, n_ops=40):
    """A deterministic mixed scalar/bulk history over [0, n_words): the
    JAX package's ``tests/test_shardstore.py`` history."""
    r = np.random.RandomState(seed)
    ops = []
    for _ in range(n_ops):
        kind = r.randint(3)
        if kind == 0:                                  # scalar write
            ops.append(("w", int(r.randint(n_words)), int(r.randint(100))))
        elif kind == 1:                                # bulk rotate
            lo = int(r.randint(n_words - 4))
            ln = int(r.randint(2, min(16, n_words - lo) + 1))
            ops.append(("rot", lo, ln))
        else:                                          # bulk stamp
            lo = int(r.randint(n_words - 4))
            ln = int(r.randint(2, min(16, n_words - lo) + 1))
            ops.append(("stamp", lo, ln, int(r.randint(1000))))
    return ops


def _host(vals):
    """A read's values as a host int64 array (tensor or list)."""
    from repro_torch.core.engine.traverse import host_words

    return np.asarray(host_words(vals), np.int64)


def _shard_state(st):
    """The sharded store as numpy: each shard's clock, block stamps,
    block and ring, the clock vector, the epoch and the counters."""
    out = {"clocks": st.clocks, "epoch": st.epoch,
           "epoch_seq": st._epoch_seq.load()}
    stats = st.stats()
    for k in ("commits", "aborts", "ro_commits", "cross_shard_commits"):
        out[k] = stats[k]
    for i, sh in enumerate(st._shards):
        s = sh.state
        out[f"s{i}.clock"] = s.clock
        out[f"s{i}.block_clocks"] = sorted((s.block_clocks or {}).items())
        out[f"s{i}.heap"] = _host(s.live["heap"])
        for k in s.ring:
            out[f"s{i}.ring{k}"] = _host(s.ring[k])
            out[f"s{i}.ring_ts{k}"] = _host(s.ring_ts[k])
    return out


def _same_state(what, got, want):
    check(set(got) == set(want), f"{what}: state keys differ")
    for k in want:
        check(np.array_equal(np.asarray(got[k]), np.asarray(want[k])),
              f"{what}: {k} differs ({got[k]} vs {want[k]})"
              if np.ndim(want[k]) == 0 else f"{what}: {k} differs")


def shard_parity_check(torch):
    """The JAX package's seeded shard histories (``tests/test_shardstore
    .py``) through ``make_tm("shardstore", n_shards=n, span=8)`` on the
    card and on the CPU: final reads, heaps, rings, clocks, epoch and
    counters must be bit-identical; and ``_shard_parity_check``
    (shardstore(1) against mvstore) must hold on the card."""
    from repro_torch.api import make_tm
    from repro_torch.configs.paper_stm import MultiverseParams
    from repro_torch.eval.workloads import _shard_parity_check

    n_words = 64
    for n in SHARD_COUNTS:
        for seed in (0, 1):
            ops = seeded_history(seed, n_words)
            out = {}
            for device in ("cuda", "cpu"):
                st = make_tm("shardstore", 4, n_shards=n, span=8,
                             start_bg=False, device=device,
                             params=MultiverseParams(k1=2, k2=50, k3=50,
                                                     lock_table_bits=8))
                base = st.alloc(n_words, 7)
                for op in ops:
                    with st.txn(tid=0) as tx:
                        if op[0] == "w":
                            tx.write(base + op[1], op[2])
                        elif op[0] == "rot":
                            lo, ln = base + op[1], op[2]
                            vals = _host(tx.read_bulk(range(lo, lo + ln)))
                            tx.write_bulk(range(lo, lo + ln),
                                          np.roll(vals, 1))
                        else:
                            lo, ln, v = base + op[1], op[2], op[3]
                            tx.write_bulk(range(lo, lo + ln),
                                          np.arange(v, v + ln))
                with st.txn(tid=0) as tx:
                    final = _host(tx.read_bulk(range(base,
                                                     base + n_words)))
                out[device] = dict(_shard_state(st), final=final)
                st.stop()
            _same_state(f"shardstore n_shards={n} seed {seed}",
                        out["cuda"], out["cpu"])
            g = out["cuda"]
            emit({"shard_parity": seed, "n_shards": n, "ops": len(ops),
                  "clocks": list(g["clocks"]), "epoch": g["epoch"],
                  "commits": g["commits"], "aborts": g["aborts"],
                  "cross_shard_commits": g["cross_shard_commits"],
                  "cuda_equals_cpu": True})
            check(g["epoch"] == g["cross_shard_commits"],
                  f"shardstore n_shards={n} seed {seed}: epoch "
                  f"{g['epoch']} != {g['cross_shard_commits']} cross "
                  "commits")
    params = MultiverseParams(k1=30, k2=200, k3=200, lock_table_bits=16)
    ok = _shard_parity_check(SEED, 512, 8, params, device="cuda")
    emit({"shard_parity_vs_mvstore": ok, "device": "cuda"})
    check(ok, "shardstore(1) and mvstore differ on the card")


def shardstore_trial(torch, n_shards, duration_s=1.5, warmup_s=0.25,
                     cap_s=30.0):
    """The sharded store at the size of phase 4's ``mvstore_1M``: 1,000,000
    int32 words in spans of 8,192 over ``n_shards`` shards, every block
    versioned, rings of ``SHARD_RING`` slots.  2 updaters commit 2-word
    transfers inside one span — updater ``u`` owns the spans ``k`` with
    ``k % 2 == u``, so from 2 shards up their footprints lie on disjoint
    shards — and, from 2 shards up, one transfer in 16 between two spans
    on different shards (a cross-shard epoch); 1 checker reads the whole
    heap in one read-only transaction (across every shard from 2 up).  Every
    completed check must see ``words * INITIAL``; the epoch must equal
    the cross-shard commits; every shard-local publish is one
    ``commit_fused`` launch, so the launches equal the shards' clock
    advances; the checker's reads launch ``gather_read``; and checks
    must complete while the updaters run (the window runs ``duration_s``
    and on until the first one, at most ``cap_s``)."""
    from repro_torch import kernels as K
    from repro_torch.api import MaxRetriesExceeded, run
    from repro_torch.configs.paper_stm import MultiverseParams

    name = f"shardstore_1M_s{n_shards}_r{SHARD_RING}"
    words, span = SHARD_WORDS, SHARD_SPAN
    h = _make("shardstore", 3, MultiverseParams(k1=2, k2=3, k3=3),
              n_shards=n_shards, span=span, versioned="all",
              ring_slots=SHARD_RING)
    base = h.alloc(words, INITIAL)
    expected = words * INITIAL
    n_spans = -(-words // span)
    bounds = [(k * span, min((k + 1) * span, words))
              for k in range(n_spans)]
    #: for each shard, the spans stored elsewhere
    elsewhere = [[k for k in range(n_spans) if k % n_shards != s]
                 for s in range(n_shards)]

    def checker(stop, c):
        def whole(tx):
            return _sum(tx.read_bulk(range(base, base + words)))
        while not stop.is_set():
            try:
                got = run(h, whole, tid=0, max_retries=60)
                if got != expected:
                    c["violations"] += 1
                # a check that completes once the updaters stopped saw no
                # concurrent commit: it is not progress under load
                c["checks" if not stop.is_set() else "late_checks"] += 1
            except MaxRetriesExceeded:
                c["failed_checks"] += 1

    def updater(u):
        r = random.Random(SEED * 10007 + 500 + u)
        mine = [k for k in range(n_spans) if k % 2 == u]

        def transfer(tx):
            k = r.choice(mine)
            lo, hi = bounds[k]
            if n_shards > 1 and r.randrange(CROSS_EVERY) == 0:
                lo2, hi2 = bounds[r.choice(elsewhere[k % n_shards])]
                i, j = r.randrange(lo, hi), r.randrange(lo2, hi2)
            else:
                i, j = r.sample(range(lo, hi), 2)
            a = tx.read(base + i)
            b = tx.read(base + j)
            tx.write(base + i, a - AMOUNT)
            tx.write(base + j, b + AMOUNT)

        def work(stop, c):
            while not stop.is_set():
                try:
                    run(h, transfer, tid=1 + u, max_retries=2000)
                    c["updates"] += 1
                except MaxRetriesExceeded:
                    c["failed_updates"] += 1
        return work

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clocks0 = h.clocks
    K.reset_launch_counts()
    workers = [checker, updater(0), updater(1)]
    tot, dt = run_trial(workers, cap_s, warmup_s, min_s=duration_s,
                        done=lambda t: t["checks"] > 0)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    stats = h.stats()
    clocks = h.clocks
    h.stop()
    advance = sum(clocks) - sum(clocks0)
    row = {"trial": name, "backend": "shardstore", "n_shards": n_shards,
           "span": span, "block_words": words, "ring_slots": SHARD_RING,
           "seconds": dt, "updates_per_s": tot["updates"] / dt,
           "checks_per_s": tot["checks"] / dt,
           "failed_updates": tot["failed_updates"],
           "failed_checks": tot["failed_checks"],
           "checks_after_the_window": tot["late_checks"],
           "violations": tot["violations"], "aborts": stats["aborts"],
           "commits": stats["commits"],
           "cross_shard_commits": stats["cross_shard_commits"],
           "epoch": stats["epoch"], "clocks": list(clocks),
           "clock_advance": advance,
           "mode_transitions": stats["mode_transitions"],
           "launches": launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(row)
    check(row["violations"] == 0, f"{name}: violations")
    check(tot["updates"] > 0 and tot["checks"] > 0,
          f"{name}: no progress ({dict(tot)})")
    check(row["epoch"] == row["cross_shard_commits"],
          f"{name}: epoch {row['epoch']} != "
          f"{row['cross_shard_commits']} cross-shard commits")
    check(n_shards == 1 or row["cross_shard_commits"] > 0,
          f"{name}: no cross-shard commit")
    check(launches["commit_fused"] == advance,
          f"{name}: {launches['commit_fused']} commit_fused launches "
          f"against {advance} shard clock ticks")
    check(launches["gather_read"] > 0, f"{name} launched no gather_read")
    return row


def shard_batcher_check(torch):
    """``ShardedCommitBatcher`` on the card: eight blind writers with
    disjoint addresses on shard 0 publish as ONE group (one
    ``commit_fused`` launch, one tick of shard 0's clock); a ninth that
    overlaps the first falls back to a solo commit and aborts.  The
    verdicts, the batcher's counts and the store must equal the CPU
    run's."""
    from repro_torch import kernels as K
    from repro_torch.api import make_tm
    from repro_torch.core.engine.groupcommit import ShardedCommitBatcher

    span = 64
    out = {}
    for device in ("cuda", "cpu"):
        st = make_tm("shardstore", 9, n_shards=2, span=span,
                     start_bg=False, device=device)
        base = st.alloc(16 * span, 1)
        b = ShardedCommitBatcher(st)
        for t in range(8):                 # span 2t lies on shard 0
            lo = base + 2 * t * span
            tx = st.begin(tid=t)
            tx.write_bulk(range(lo, lo + span),
                          np.arange(span) + 1000 * (t + 1))
            b.add(tx)
        tx = st.begin(tid=8)
        tx.write(base + 3, -7)             # meets the first writer
        b.add(tx)
        K.reset_launch_counts()
        ok = b.commit_all()
        if device == "cuda":
            torch.cuda.synchronize()
        out[device] = dict(_shard_state(st), ok=ok,
                           launches=K.launch_counts()["commit_fused"],
                           **{f"batcher.{k}": v for k, v in b.stats.items()})
        st.stop()
    g = out["cuda"]
    launches = g.pop("launches")
    out["cpu"].pop("launches")
    _same_state("ShardedCommitBatcher", g, out["cpu"])
    row = {"shard_batcher": "8 blind writers + 1 overlapping", "ok": g["ok"],
           "clocks": list(g["clocks"]), "commit_fused_launches": launches,
           "grouped": g["batcher.grouped"], "groups": g["batcher.groups"],
           "solo": g["batcher.solo"], "failed": g["batcher.failed"],
           "cuda_equals_cpu": True}
    emit(row)
    check(g["ok"] == [True] * 8 + [False],
          f"ShardedCommitBatcher verdicts {g['ok']}")
    check(launches == 1 and g["clocks"] == (1, 0),
          f"ShardedCommitBatcher: {launches} launches, clocks "
          f"{g['clocks']} (one group: 1 launch, one tick)")
    check((g["batcher.grouped"], g["batcher.groups"], g["batcher.solo"])
          == (8, 1, 1), "ShardedCommitBatcher counts")
    return {"commit_fused": launches}


def shard_phase(torch):
    """Phase 6: the sharded store on the card (card against CPU, the 1M-word
    trial at 1, 2 and 4 shards, the sharded group commit, and
    ``run_eval("shardscale")`` at its full variants).  Returns the launch
    counts of its main-path runs."""
    from repro_torch import kernels as K
    from repro_torch.eval import run_eval, shardscale_headline

    t0 = time.perf_counter()
    totals = defaultdict(int)
    shard_parity_check(torch)
    rows = {n: shardstore_trial(torch, n) for n in SHARD_COUNTS}
    for row in rows.values():
        for k, v in row["launches"].items():
            totals[k] += v
    base = rows[1]
    emit({"shardstore_1M_scaling": {"ring_slots": SHARD_RING, **{
        f"ratio_{n}_to_1": {
            "updates": rows[n]["updates_per_s"] / base["updates_per_s"],
            "checks": rows[n]["checks_per_s"] / base["checks_per_s"]}
        for n in SHARD_COUNTS[1:]}}})
    for k, v in shard_batcher_check(torch).items():
        totals[k] += v
    erows = []
    K.reset_launch_counts()
    run_eval("shardscale", save=False,
             progress=lambda r: erows.append(
                 {k: v for k, v in r.items() if k != "stm_stats"}))
    torch.cuda.synchronize()
    launches = K.launch_counts()
    head = shardscale_headline(erows)
    for r in erows:
        emit(r)
        what = f"eval shardscale/{r['variant']}"
        check(r["violations"] == 0, f"{what}: violations")
        check(r["updates_per_sec"] > 0 and r["checks_per_sec"] > 0,
              f"{what}: no progress")
    emit({"eval": "shardscale", "trials": len(erows), "launches": launches,
          "headline": head, "reference_expects_ratio_2_shards": 1.6})
    check(erows[0]["parity_ok"] is True, "shardscale: parity at 1 shard")
    check(head["parity_ok"] and head["violations"] == 0,
          f"shardscale headline {head}")
    for k in ("gather_read", "commit_fused"):
        check(launches[k] > 0, f"eval shardscale launched no {k}")
    for k, v in launches.items():
        totals[k] += v
    emit({"shard_phase_seconds": time.perf_counter() - t0})
    return totals


# ---------------------------------------------------------------------------
# phase 7: the write-ahead log and crash recovery
# ---------------------------------------------------------------------------

CRASH_N = 300                  # >= BULK_MIN (tests/test_crash_matrix.py)
CRASH_POINTS = ("pre_claim", "post_claim", "pre_clock_tick", "pre_scatter",
                "post_scatter", "pre_release")
MV_CRASH_POINTS = ("pre_clock_tick", "pre_scatter", "post_scatter",
                   "pre_release")
#: (point, nth) of the reference's five cross-shard epoch cases
SHARD_EPOCH_CASES = (("pre_claim", 1), ("pre_clock_tick", 1),
                     ("pre_scatter", 1), ("pre_scatter", 2),
                     ("pre_release", 3))
WORD_ENGINES = ("multiverse", "tl2", "dctl", "tinystm")
JOURNAL_TXNS = 40              # the seeded single-thread journal's length


def _word_engine(backend, n_threads, device):
    """The reference crash matrix's engine (``start_bg=False``, default
    parameters) with its heap in an ``ArrayHeap`` on ``device``."""
    from repro_torch.core.baselines import DCTL, TL2, TinySTM
    from repro_torch.core.engine import ArrayHeap
    from repro_torch.core.stm import Multiverse

    heap = ArrayHeap(device=device)
    if backend == "multiverse":
        return Multiverse(n_threads, start_bg=False, heap=heap,
                          device=device)
    cls = {"tl2": TL2, "dctl": DCTL, "tinystm": TinySTM}[backend]
    return cls(n_threads, heap=heap, device=device)


def _h64(t):
    return t.cpu().numpy().astype(np.int64)


def _word_record(eng, n, out, tag):
    """Heap prefix, lock words, clock and mirror rows into ``out``."""
    out[f"{tag}.heap"] = _h64(eng.heap.live()[:n])
    out[f"{tag}.locks"] = _h64(eng.locks._words)
    out[f"{tag}.clock"] = eng.clock.load()
    mirror = getattr(getattr(eng.policy, "vlt", None), "mirror", None)
    if mirror is not None:
        for k in ("_seq", "_addr", "_ts", "_data"):
            out[f"{tag}.mirror{k}"] = _h64(getattr(mirror, k))


def _store_record(h, out, tag):
    s = h.state
    out[f"{tag}.clock"] = s.clock
    out[f"{tag}.heap"] = _h64(s.live["heap"])
    out[f"{tag}.inflight"] = h._inflight is not None
    for k in s.ring:
        out[f"{tag}.ring"] = _h64(s.ring[k])
        out[f"{tag}.ring_ts"] = _h64(s.ring_ts[k])
        out[f"{tag}.host_ts"] = np.asarray(h._snap[3], np.int64)


def _report_record(rep, out, tag="report"):
    for k, v in dataclasses.asdict(rep).items():
        out[f"{tag}.{k}"] = np.asarray(v)


def crash_case(kind, backend, point, nth, device):
    """One case of the reference's crash matrix on ``device``: a kill at
    the ``nth`` arrival at ``point``, then recovery.  Returns the flat
    record (crash image, report, recovered state, invariant violations)
    that card and CPU must agree on."""
    from repro_torch.api import make_tm, run
    from repro_torch.core.engine.groupcommit import CommitBatcher
    from repro_torch.reliability import faultpoints as FP
    from repro_torch.reliability import recovery as REC

    n = CRASH_N
    out = {}

    def crashing(fn):
        sched = FP.install(FP.FaultSchedule([FP.Fault(point, nth, "kill")]))
        try:
            fn()
            out["crashed"] = False
        except FP.SimulatedCrash:
            out["crashed"] = True
        finally:
            FP.uninstall()
        out["fired"] = len(sched.fired)

    try:
        if kind in ("solo", "group"):
            members = 1 if kind == "solo" else 3
            tm = _word_engine(backend, members + 1, device)
            tm.alloc(members * n, 0)
            if kind == "solo":
                run(tm, lambda tx: tx.write_bulk(np.arange(n),
                                                 list(range(n))), tid=0)
                dead = [1]
                clock0 = tm.clock.load()
                crashing(lambda: run(tm, lambda tx: tx.write_bulk(
                    np.arange(n), [v + 1000 for v in range(n)]), tid=1))
            else:
                batcher = CommitBatcher(tm)
                for t in range(members):
                    tx = tm.begin(t)
                    tx.write_bulk(np.arange(t * n, (t + 1) * n),
                                  [t * 10000 + i for i in range(n)])
                    batcher.add(tx)
                dead = list(range(members))
                clock0 = tm.clock.load()
                crashing(batcher.commit_all)
            _word_record(tm, members * n, out, "crash")
            if out["crashed"]:
                out["decided"] = np.asarray(
                    [tm.ctx(t).publish_started for t in dead])
                _report_record(REC.recover_engine(tm, dead), out)
            out["violations"] = np.asarray(REC.check_engine_invariants(
                tm, clock_at_least=clock0))
            _word_record(tm, members * n, out, "recovered")
            tm.stop()
        else:
            st = (make_tm("mvstore", 2, versioned="all", start_bg=False,
                          device=device) if kind == "mvstore" else
                  make_tm("shardstore", 2, n_shards=2, span=4,
                          start_bg=False, device=device))
            st.alloc(32, 0)
            run(st, lambda tx: tx.write_bulk(np.arange(32),
                                             list(range(32))), tid=0)
            crashing(lambda: run(st, lambda tx: tx.write_bulk(
                np.arange(32), [v + 100 for v in range(32)]), tid=1))
            if kind == "mvstore":
                _store_record(st, out, "crash")
                _report_record(REC.recover_handle(st), out)
                out["violations"] = np.asarray(
                    REC.check_store_invariants(st))
                _store_record(st, out, "recovered")
            else:
                out["parked"] = st._epoch_inflight is not None
                for i, sh in enumerate(st._shards):
                    _store_record(sh, out, f"crash.s{i}")
                _report_record(REC.recover_shardstore(st), out)
                out["violations"] = np.asarray(
                    REC.check_shardstore_invariants(st))
                for i, sh in enumerate(st._shards):
                    _store_record(sh, out, f"recovered.s{i}")
                out["epoch"] = st._epoch.load()
            vals, ok = st.snapshot_bulk(np.arange(32))
            out["snapshot.ok"] = bool(ok)
            out["snapshot"] = _host(vals)
            st.stop()
    finally:
        FP.uninstall()
        FP.reset_thread()
    return out


def crash_parity(torch):
    """Every case of ``tests/test_crash_matrix.py``'s matrix (solo: every
    word backend x six points; group buffered and encounter; the MVStore's
    four points; the five cross-shard epoch cases) on the card and on the
    CPU: crash images, whole reports, recovered heaps, lock words, clocks,
    mirror rows, blocks, rings and ring timestamps must be equal, with no
    invariant violated.  Returns the card's launch counts."""
    from repro_torch import kernels as K

    cases = [("solo", b, p, 1) for b in WORD_ENGINES for p in CRASH_POINTS]
    cases += [("group", "tl2", p, 1) for p in CRASH_POINTS]
    cases += [("group", "dctl", p, 1)
              for p in ("pre_clock_tick", "pre_release")]
    cases += [("mvstore", None, p, 1) for p in MV_CRASH_POINTS]
    cases += [("shardstore", None, p, k) for p, k in SHARD_EPOCH_CASES]
    cpu, dev = torch.device("cpu"), torch.device(CARD)
    totals = defaultdict(int)
    summary = defaultdict(int)
    for kind, backend, point, nth in cases:
        what = f"crash {kind}/{backend}/{point}#{nth}"
        K.reset_launch_counts()
        got = crash_case(kind, backend, point, nth, dev)
        torch.cuda.synchronize()
        for k, v in K.launch_counts().items():
            totals[k] += v
        want = crash_case(kind, backend, point, nth, cpu)
        _same_state(what, got, want)
        check(got["violations"].size == 0,
              f"{what}: {got['violations'].tolist()}")
        summary["cases"] += 1
        summary["crashed"] += bool(got["crashed"])
        summary["rolled_forward"] += int(
            np.size(got.get("report.rolled_forward", ())))
        summary["rolled_back"] += int(
            np.size(got.get("report.rolled_back", ())))
        summary["completed_install"] += bool(
            got.get("report.completed_install", False))
    check(summary["crashed"] > 0 and summary["rolled_forward"] > 0
          and summary["rolled_back"] > 0, f"crash matrix {dict(summary)}")
    emit({"crash_matrix_card_equals_cpu": dict(summary),
          "launches": dict(totals)})
    return totals


def _journal(backend, device, wal_dir):
    """A seeded single-thread schedule journaled to ``wal_dir``: 40
    transactions of 1-8 or 300-word writes (some reading first), every
    fourth pair through ``CommitBatcher``.  Returns the final heap."""
    from repro_torch.api import run
    from repro_torch.core.engine.groupcommit import CommitBatcher
    from repro_torch.reliability.wal import WriteAheadLog, attach_wal

    r = random.Random(SEED * 10007 + 11)
    words = 2048
    tm = _word_engine(backend, 3, device)
    tm.alloc(words, 0)
    wal = attach_wal(tm, WriteAheadLog(wal_dir))
    for i in range(JOURNAL_TXNS):
        n = r.choice((1, 8, CRASH_N))
        lo = r.randrange(words - n)
        vals = [r.randrange(-1 << 40, 1 << 40) for _ in range(n)]
        if i % 4 == 3 and backend != "multiverse":
            batcher = CommitBatcher(tm)
            for t, off in ((0, 0), (1, words // 2)):
                tx = tm.begin(t)
                a = np.arange(off, off + 64)
                tx.write_bulk(a, [v + t for v in vals[:1]] * 64)
                batcher.add(tx)
            batcher.commit_all()
            continue

        def body(tx, lo=lo, n=n, vals=vals, i=i):
            if i % 2:
                _sum(tx.read_bulk(range(lo, lo + n)))
            tx.write_bulk(np.arange(lo, lo + n), vals)
        run(tm, body, tid=i % 2)
    heap = _h64(tm.heap.live())
    wal.close()
    tm.stop()
    return heap


def journal_parity(torch, scratch):
    """The seeded journal on the card and on the CPU: the segment files
    must be byte-identical, and each log must replay into a fresh engine
    on the OTHER device to the heap it was written from."""
    from repro_torch.reliability.wal import recover_from_wal

    out = {}
    for backend in ("tl2", "dctl", "multiverse"):
        heaps, dirs = {}, {}
        for dev in (CARD, "cpu"):
            dirs[dev] = os.path.join(scratch, f"journal_{backend}_{dev}")
            heaps[dev] = _journal(backend, torch.device(dev), dirs[dev])
        segs = {d: [open(os.path.join(p, f), "rb").read()
                    for f in sorted(os.listdir(p)) if f.endswith(".seg")]
                for d, p in dirs.items()}
        check(segs[CARD] == segs["cpu"],
              f"journal {backend}: the card's log differs from the CPU's")
        check(np.array_equal(heaps[CARD], heaps["cpu"]),
              f"journal {backend}: card and CPU heaps differ")
        for src, dst in ((CARD, "cpu"), ("cpu", CARD)):
            fresh = _word_engine(backend, 1, torch.device(dst))
            fresh.alloc(heaps[src].size, 0)
            rep = recover_from_wal(dirs[src], fresh)
            check(np.array_equal(_h64(fresh.heap.live()), heaps[src]),
                  f"journal {backend}: the {src} log replayed on {dst} "
                  "differs")
            fresh.stop()
        out[backend] = {"records_replayed": rep.wal_records_replayed,
                        "log_bytes": sum(len(b) for b in segs[CARD])}
    emit({"journal_card_equals_cpu": out})


def durable_group_trial(torch, scratch):
    """``durable_group_tl2_1M``: phase 4's ``group_tl2_1M`` with a
    ``WriteAheadLog(group_sync=True)``, two 1.5 s windows around a
    checkpoint of the whole heap; then a FRESH tl2 engine on the card at
    the same size replays the log: its heap must equal the trial's bit
    for bit, every block sum must hold, and the replay must launch
    ``scatter_write`` exactly once for the base image plus once a
    record."""
    from repro_torch import kernels as K
    from repro_torch.configs.paper_stm import MultiverseParams
    from repro_torch.reliability.recovery import check_engine_invariants
    from repro_torch.reliability.wal import recover_from_wal

    wal_dir = os.path.join(scratch, "durable_group_tl2")
    keep = {}
    K.reset_launch_counts()
    row = group_trial(torch, "durable_group_tl2_1M", "tl2", 1.5, 0.25,
                      wal_dir=wal_dir, keep=keep)
    torch.cuda.synchronize()
    row["launches"] = K.launch_counts()
    check(row["violations"] == 0, "durable_group_tl2_1M: violations")
    fresh = _make("tl2", 1, MultiverseParams(k1=30, k2=200, k3=200,
                                             lock_table_bits=16))
    fresh.alloc(keep["heap"].size, INITIAL)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rep = recover_from_wal(wal_dir, fresh)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    replay = K.launch_counts()
    got = _h64(fresh.raw.heap.live())
    post = check_engine_invariants(fresh, expect_sums=keep["sums"])
    fresh.stop()
    inmem = PHASE4_ROWS["group_tl2_1M"]["updates_per_s"]
    row.update(wal_stats=keep["wal_stats"], checkpoint_s=keep["checkpoint_s"],
               replay_s=replay_s, records_replayed=rep.wal_records_replayed,
               replay_launches=replay,
               ratio_to_group_tl2_1M=row["updates_per_s"] / inmem,
               reference_bar_ratio=0.5)
    emit(row)
    check(rep.wal_records_replayed > 0, "durable_group_tl2_1M: no record")
    check(replay["scatter_write"] == 1 + rep.wal_records_replayed,
          f"durable_group_tl2_1M: {replay['scatter_write']} scatter_write "
          f"launches replaying {rep.wal_records_replayed} records")
    check(np.array_equal(got, keep["heap"]),
          "durable_group_tl2_1M: the replayed heap differs from the trial's")
    check(post == [], f"durable_group_tl2_1M: {post}")
    return row["launches"]


def durable_mvstore_trial(torch, scratch):
    """``durable_mvstore_1M``: phase 4's ``mvstore_1M`` with a
    ``WriteAheadLog`` attached (1.5 s); a fresh 1M-word MVStore on the card
    replays the log to the trial's block and clock with one
    ``commit_fused`` launch a record; then a kill at ``post_scatter`` on
    that store completes its install from ``_inflight``, and
    ``check_store_invariants`` resolves every durable ring timestamp
    through ``snapshot_select``."""
    from repro_torch import kernels as K
    from repro_torch.api import run
    from repro_torch.configs.paper_stm import MultiverseParams
    from repro_torch.reliability import faultpoints as FP
    from repro_torch.reliability.recovery import (check_store_invariants,
                                                  recover_handle)
    from repro_torch.reliability.wal import recover_from_wal

    wal_dir = os.path.join(scratch, "durable_mvstore")
    keep = {}
    K.reset_launch_counts()
    row = mvstore_trial(torch, "durable_mvstore_1M", 1.5, 0.25,
                        wal_dir=wal_dir, keep=keep)
    torch.cuda.synchronize()
    row["launches"] = K.launch_counts()
    check(row["violations"] == 0, "durable_mvstore_1M: violations")
    h = _make("mvstore", 3, MultiverseParams(k1=2, k2=3, k3=3),
              versioned="all", ring_slots=8)
    h.alloc(keep["block"].size, INITIAL)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    rep = recover_from_wal(wal_dir, h)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    replay = K.launch_counts()
    same_block = np.array_equal(h.state.live["heap"].cpu().numpy(),
                                keep["block"])
    row.update(wal_stats=keep["wal_stats"], replay_s=replay_s,
               records_replayed=rep.wal_records_replayed,
               replay_launches=replay, replayed_clock=h.clock,
               trial_clock=keep["clock"])
    check(same_block, "durable_mvstore_1M: the replayed block differs")
    check(h.clock == keep["clock"],
          f"durable_mvstore_1M: clock {h.clock} != {keep['clock']}")
    check(rep.wal_records_replayed > 0
          and replay["commit_fused"] == rep.wal_records_replayed,
          f"durable_mvstore_1M: {replay['commit_fused']} commit_fused "
          f"launches replaying {rep.wal_records_replayed} records")
    FP.install(FP.FaultSchedule([FP.Fault("post_scatter", 1, "kill")]))
    try:
        run(h, lambda tx: tx.write_bulk([0, 1], [INITIAL - AMOUNT,
                                                 INITIAL + AMOUNT]), tid=1)
        crashed = False
    except FP.SimulatedCrash:
        crashed = True
    finally:
        FP.uninstall()
        FP.reset_thread()
    check(crashed and h._inflight is not None,
          "durable_mvstore_1M: the post_scatter kill did not land")
    rec = recover_handle(h)
    K.reset_launch_counts()
    post = check_store_invariants(h)
    torch.cuda.synchronize()
    inv = K.launch_counts()
    h.stop()
    row.update(post_scatter_completed_install=rec.completed_install,
               invariant_launches={k: v for k, v in inv.items() if v})
    emit(row)
    check(rec.completed_install, "durable_mvstore_1M: install not completed")
    check(post == [] and inv["snapshot_select"] > 0,
          f"durable_mvstore_1M: invariants {post}, {inv['snapshot_select']} "
          "snapshot_select launches")
    return row["launches"]


_SIGKILL_CHILD = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[5])
from repro_torch.api import run
from repro_torch.core.baselines import TL2
from repro_torch.core.engine import ArrayHeap
from repro_torch.core.stm import Multiverse
from repro_torch.reliability import faultpoints as FP
from repro_torch.reliability.wal import WriteAheadLog, attach_wal

backend, point, wal_dir, n, dev = sys.argv[1], sys.argv[2], sys.argv[3], \\
    int(sys.argv[4]), sys.argv[6]
heap = ArrayHeap(device=dev)
tm = (Multiverse(2, start_bg=False, heap=heap, device=dev)
      if backend == "multiverse" else TL2(2, heap=heap, device=dev))
tm.alloc(n, 0)
attach_wal(tm, WriteAheadLog(wal_dir))
run(tm, lambda tx: tx.write_bulk(np.arange(n), list(range(n))), tid=0)
FP.install(FP.FaultSchedule([FP.Fault(point, 1, "die")]))
run(tm, lambda tx: tx.write_bulk(np.arange(n),
                                 [v + 1000 for v in range(n)]), tid=1)
sys.exit(3)                    # reached only if the fault missed
"""

#: the reference's three drills (tests/test_wal.py): backend, point, words,
#: whether tid 1's commit must have decided
SIGKILL_DRILLS = (("tl2", "pre_claim", CRASH_N, False),
                  ("tl2", "mid_scatter", CRASH_N, True),
                  ("multiverse", "pre_release", 32, True))


def sigkill_drills(torch, scratch):
    """The three SIGKILL drills with the child on the card: each child
    commits a prefix and kills itself mid-commit (``die``, possibly with
    launches still queued); the parent, touching none of the child's CUDA
    state, recovers a fresh engine on the card from the log directory
    alone, to the decided records replayed onto a zeroed heap."""
    from repro_torch.reliability.wal import recover_from_wal, scan_dir

    script = os.path.join(scratch, "sigkill_child.py")
    with open(script, "w") as f:
        f.write(_SIGKILL_CHILD)
    procs = []
    for backend, point, n, _ in SIGKILL_DRILLS:
        d = os.path.join(scratch, f"sigkill_{backend}_{point}")
        procs.append((d, subprocess.Popen(
            [sys.executable, script, backend, point, d, str(n),
             os.path.join(HERE, "src"), CARD], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)))
    results = []
    try:
        for d, p in procs:
            out, err = p.communicate(timeout=300)
            results.append((d, p.returncode, err))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rows = []
    for (backend, point, n, decides), (d, rc, err) in zip(SIGKILL_DRILLS,
                                                          results):
        what = f"sigkill {backend}/{point}"
        check(rc == -9, f"{what}: child exited {rc}: {err[-2000:]!r}")
        recs, torn, _ = scan_dir(d)
        ref = np.zeros(n, np.int64)
        for r in recs:
            if r.decided:
                ref[r.addrs] = r.values
        fresh = _word_engine(backend, 2, torch.device(CARD))
        fresh.alloc(n, 0)
        rep = recover_from_wal(d, fresh)
        got = _h64(fresh.heap.live())
        fresh.stop()
        decided = any(r.decided and r.tid == 1 for r in recs)
        rows.append({"drill": what, "returncode": rc, "records": len(recs),
                     "torn_bytes": torn, "tid1_decided": decided,
                     "rolled_forward": rep.rolled_forward,
                     "rolled_back": rep.rolled_back})
        check(np.array_equal(got, ref), f"{what}: recovered heap differs")
        check(decided == decides and (1 in rep.rolled_forward) == decides,
              f"{what}: decided {decided}, report {rep.summary()}")
        want = np.arange(n) + (1000 if decides else 0)
        check(np.array_equal(got, want), f"{what}: not the committed prefix")
    emit({"sigkill_drills": rows})


def reliability_evals(torch):
    """``run_eval("reliability")`` (and with ``durable=True``) and
    ``run_eval("durability")`` at the reference's full variants on the
    card: violations 0 and no failed post-trial invariant in every row,
    every durable row's restart drill clean and replaying, and in every
    kill row every kill recovered — the row's kills against its
    recoveries, and every kill the trial's schedule fired (warm-up
    included) against the engine's recovery verdicts, one each.

    How many kills land is recorded, not gated: the reference's seeded
    schedule (seed 0) first fires at the 398th fault-point arrival, about
    the 199th commit, which a 1.5 s trial reaches only above ~133
    commits/s, and a kill row on the card commits 90-200/s (PERF.md).
    Returns the launch counts."""
    from repro_torch import kernels as K
    from repro_torch.eval import (WORKLOADS, durability_headline,
                                  reliability_headline, run_eval)
    from repro_torch.reliability import faultpoints as FP

    totals = defaultdict(int)
    fired = []
    install = FP.install

    def recording_install(schedule):          # the trials' schedules
        fired.append(schedule)
        return install(schedule)

    for name, durable in (("reliability", False), ("reliability", True),
                          ("durability", False)):
        rows, verdicts = [], []
        WORKLOADS["reliability"].durable = durable
        K.reset_launch_counts()
        FP.install = recording_install
        try:
            run_eval(name, save=False, progress=lambda r: (
                verdicts.append(r["stm_stats"]["rolled_forward"]
                                + r["stm_stats"]["rolled_back"]),
                rows.append({k: v for k, v in r.items()
                             if k != "stm_stats"})))
        finally:
            FP.install = install
            WORKLOADS["reliability"].durable = False
        torch.cuda.synchronize()
        launches = K.launch_counts()
        for k, v in launches.items():
            totals[k] += v
        for r, n_verdicts in zip(rows, verdicts):
            what = f"eval {name}/{r['variant']}/{r['backend']}"
            check(r["violations"] == 0 and r["post_invariant_failures"]
                  == [], f"{what}: violations")
            check(r["updates_per_sec"] > 0, f"{what}: no progress")
            if r.get("kill_every"):
                sched = fired.pop(0)
                r["schedule_fired"] = len(sched.fired)
                r["schedule_arrivals"] = sum(
                    sched.arrivals(p) for p in sched.periodic_points)
                check(r["recoveries"] == r["kills"]
                      and n_verdicts == len(sched.fired),
                      f"{what}: kills {r['kills']}, recoveries "
                      f"{r['recoveries']}, {len(sched.fired)} fired, "
                      f"{n_verdicts} recovery verdicts")
            if name == "durability" and r["durable"]:
                check(r["restart_drill_failures"] == []
                      and r["wal_records_replayed"] > 0,
                      f"{what}: restart drill")
            emit(r)
        check(not fired, f"eval {name}: a schedule without its row")
        head = (reliability_headline if name == "reliability"
                else durability_headline)(rows)
        emit({"eval": name, "durable": durable, "trials": len(rows),
              "launches": launches, "headline": head})
        for k in ("gather_read", "scatter_write"):
            check(launches[k] > 0, f"eval {name} launched no {k}")
    return totals


def reliability_phase(torch):
    """Phase 7: the write-ahead log and crash recovery on the card.
    Returns the launch counts of its main-path runs."""
    t0 = time.perf_counter()
    emit({"threads_at_phase_7": sorted(t.name for t in
                                       threading.enumerate())})
    scratch = os.path.join(HERE, "build", "wal")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    totals = defaultdict(int)
    try:
        for part in (crash_parity(torch),):
            for k, v in part.items():
                totals[k] += v
        journal_parity(torch, scratch)
        sigkill_drills(torch, scratch)
        for part in (durable_group_trial(torch, scratch),
                     durable_mvstore_trial(torch, scratch),
                     reliability_evals(torch)):
            for k, v in part.items():
                totals[k] += v
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    for k in ("gather_read", "scatter_write", "commit_fused",
              "snapshot_select", "validate"):
        check(totals[k] > 0, f"phase 7 launched no {k}")
    emit({"reliability_phase_seconds": time.perf_counter() - t0})
    return totals


# ---------------------------------------------------------------------------
# phase 8: the snapshot-serving service
# ---------------------------------------------------------------------------

#: the at-scale store: one block per qwen2.5-3b layer of 1,048,576 int32
#: words (144 MiB a version, 1.125 GiB in the 8-slot ring)
SERVICE_BLOCKS, SERVICE_BLOCK_WORDS, SERVICE_RING = 36, 1 << 20, 8


def _service_gates(row, what):
    """Every serving row: no torn read, drained, every offered request
    completed, shed or failed; Mode U never aborts a reader."""
    check(row["violations"] == 0, f"{what}: {row['violations']} torn reads")
    check(row["drained"], f"{what}: the service did not drain")
    check(row["completed"] + row["shed"] + row["failed_aborts"]
          == row["offered"],
          f"{what}: {row['offered']} offered, {row['completed']} completed, "
          f"{row['shed']} shed, {row['failed_aborts']} failed")
    if row["policy"] == "U":
        check(row["snapshot_aborts"] == 0,
              f"{what}: {row['snapshot_aborts']} Mode-U snapshot aborts")


def _row_numbers(row):
    return {k: v for k, v in row.items() if not isinstance(v, dict)}


def serving_eval(torch):
    """``run_eval("serving")`` at the reference's full variants on the
    card (qps60 with a 28 ms commit interval and qps120 with 12 ms, 2.5 s
    each; the policies multiverse, modeq and unversioned): every row
    passes ``_service_gates``; at qps120 Mode Q aborts snapshots and the
    unversioned policy mixes versions.  The headline is recorded, not
    gated (its throughput depends on the host).  Returns the launch
    counts."""
    from repro_torch import kernels as K
    from repro_torch.eval import run_eval, serving_headline

    K.reset_launch_counts()
    rows, _ = run_eval("serving", save=False)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    for r in rows:
        _service_gates(r, f"eval serving/{r['variant']}/{r['backend']}")
        emit(_row_numbers(r))
    top = {r["backend"]: r for r in rows if r["variant"] == "qps120"}
    check(top["modeq"]["snapshot_aborts"] > 0,
          "eval serving/qps120: Mode Q aborted no snapshot")
    check(top["unversioned"]["mixed_version_requests"] > 0,
          "eval serving/qps120: the unversioned policy mixed no versions")
    check(launches["snapshot_select"] > 0,
          "eval serving launched no snapshot_select")
    emit({"eval": "serving", "trials": len(rows), "launches": launches,
          "headline": serving_headline(rows)})
    return launches


def service_trial(torch, backend):
    """``service_36x1M_<policy>``: ``SnapshotService.synthetic`` over
    ``SERVICE_BLOCKS`` blocks of ``SERVICE_BLOCK_WORDS`` int32 words with
    an 8-slot ring (Mode U) on the card, under the eval's qps60 knobs
    (60 requests/s for 2.5 s, a commit every 28 ms) for the eval's
    ``backend``.  Gated as the eval rows; records qps, latency, the
    trainer's commits against the cadence asked, the host time to issue
    a resolve (no sync), of a decode step's check (the one sync that
    brings ``ok`` and the torn-read flag home) and of a prefill's
    resolve (one sync for ``ok``), and the launches."""
    from repro_torch import kernels as K
    from repro_torch.eval import WORKLOADS
    from repro_torch.serve import SnapshotService

    workload = WORKLOADS["serving"]
    spec = workload.variants()[0]
    p = spec.params
    policy = workload.POLICY[backend]
    cfg = workload.config(backend, spec, SEED, n_blocks=SERVICE_BLOCKS,
                          block_size=SERVICE_BLOCK_WORDS,
                          ring_slots=SERVICE_RING)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc = SnapshotService.synthetic(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ex = svc.executor
    spent = defaultdict(float)
    calls = defaultdict(int)

    def timed(name, fn):
        def run(*a):
            t1 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                spent[name] += time.perf_counter() - t1
                calls[name] += 1
        return run

    for name in ("_snapshot", "_resolve", "_verify", "decode"):
        setattr(ex, name, timed(name, getattr(ex, name)))
    K.reset_launch_counts()
    row = svc.run_open_loop()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    st = svc.trainer.state
    store = sum(t.numel() * t.element_size() for t in st.live.values())
    ring = sum(t.numel() * t.element_size() for t in st.ring.values())
    out = {"trial": f"service_36x1M_{policy}", **_row_numbers(row),
           "n_blocks": SERVICE_BLOCKS, "block_words": SERVICE_BLOCK_WORDS,
           "ring_slots": SERVICE_RING if policy == "U" else 0,
           "version_bytes": store, "ring_bytes": ring, "init_s": init_s,
           "commits_asked": spec.duration_s / p["commit_interval_s"],
           "resolves": calls["_snapshot"], "decode_steps": calls["decode"],
           "snapshot_ms_mean": 1e3 * spent["_snapshot"]
           / max(calls["_snapshot"], 1),
           "verify_ms_mean": 1e3 * spent["_verify"]
           / max(calls["_verify"], 1),
           "prefill_resolve_ms_mean": 1e3 * spent["_resolve"]
           / max(calls["_resolve"], 1),
           "decode_step_ms_mean": 1e3 * spent["decode"]
           / max(calls["decode"], 1),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches}
    emit(out)
    _service_gates(row, out["trial"])
    if policy == "U":
        check(launches["snapshot_select"] >= SERVICE_BLOCKS * calls[
            "_snapshot"], f"{out['trial']}: {launches['snapshot_select']} "
                          f"snapshot_select launches for "
                          f"{calls['_snapshot']} resolves of "
                          f"{SERVICE_BLOCKS} blocks")
    del svc, ex, st
    free_card(torch)
    return launches


def service_schedule(policy, device):
    """The reference's hand-driven schedule for ``policy``
    (``tests/test_serve.py``: a commit between decode steps, driven by
    hand) on a ``SyntheticTrainer`` store on ``device``: the trace of
    (pinned clock, aborts, outcome) after each step and the counters."""
    from repro_torch.serve import (ContinuousBatchingScheduler, Outcome,
                                   Request, RequestQueue, ServeMetrics,
                                   StoreExecutor, SyntheticTrainer)

    trainer = SyntheticTrainer(mode="Q" if policy == "Q" else "U",
                               ring_slots=8, commit_interval_s=3600.0,
                               device=device)
    metrics = ServeMetrics()
    ex = StoreExecutor(lambda: trainer.state, policy=policy, n_slots=1,
                       work_s=0.0, metrics=metrics)
    q = RequestQueue()
    sched = ContinuousBatchingScheduler(q, ex, metrics, max_request_aborts=8)
    r = Request(1, max_new={"U": 6, "Q": 4, "live": 3}[policy])
    q.offer(r)
    trace = []

    def step():
        sched.step()
        trace.append((r.pinned_clock, r.aborts, r.outcome.name))

    step()
    if policy == "Q":
        trainer.commit_once()
        step()
    elif policy == "live":
        trainer.commit_once()
    while r.outcome is Outcome.PENDING:
        if policy == "U":
            trainer.commit_once()
        step()
    return {"trace": trace, "clock": trainer.state.clock,
            "completed": metrics.completed,
            "snapshot_aborts": metrics.snapshot_aborts,
            "violations": metrics.violations,
            "mixed_version_requests": metrics.mixed_version_requests}


def service_schedules(torch):
    """The three hand-driven schedules (Mode U, Mode Q, ``live``) on the
    card and on the CPU: the same pinned clocks, aborts, completions and
    mixed versions; and the reference's outcomes (U: no abort; Q: one
    abort, then completed at the new clock; live: one mixed request)."""
    out = {}
    for policy in ("U", "Q", "live"):
        card, cpu = (service_schedule(policy, d) for d in (CARD, "cpu"))
        check(card == cpu, f"service schedule {policy}: card {card} != CPU "
                           f"{cpu}")
        check(card["completed"] == 1 and card["violations"] == 0,
              f"service schedule {policy}: {card}")
        want = {"U": (0, 0), "Q": (1, 0), "live": (0, 1)}[policy]
        check((card["snapshot_aborts"], card["mixed_version_requests"])
              == want, f"service schedule {policy}: {card}")
        out[policy] = card
    emit({"service_schedules_card_equals_cpu": True, "schedules": out})


def serving_phase(torch):
    """Phase 8: the hand-driven schedules card against CPU, the
    ``serving`` eval, and the service over the at-scale store in Mode U
    and Mode Q.  Returns the launch counts."""
    t0 = time.perf_counter()
    totals = defaultdict(int)
    service_schedules(torch)
    for launches in (serving_eval(torch),
                     service_trial(torch, "multiverse"),
                     service_trial(torch, "modeq")):
        for k, v in launches.items():
            totals[k] += v
    emit({"serving_phase_seconds": time.perf_counter() - t0})
    return totals


#: phase 4's rows by trial name (phase 7 compares its durable trials'
#: rates with the in-memory ones of the same run)
PHASE4_ROWS = {}


# ---------------------------------------------------------------------------
# phase 12: the drivers (``repro_torch.examples``), called as a user calls
# them, in the main process
# ---------------------------------------------------------------------------

#: seconds a backend's quickstart may take before the run fails: the
#: driver retries each audit until it commits, as the reference does, so
#: an audit that starved would otherwise hold the run to its time limit
QUICKSTART_SECONDS = 90.0
#: the reference's bake-off claims (``examples/bakeoff.py``), by table:
#: (size key, size, speedup the reference asserts, strict)
BAKEOFF_BARS = {"validation": ("reads", 1024, 1.0, True),
                "read_bulk": ("reads", 4096, 4.0, False),
                "commit": ("writes", 1024, 3.0, False),
                "group_commit": ("txns", 8, 3.0, False),
                "structrq": ("keys", 4096, 3.0, False)}
#: ``train_lm --full``'s steps: fewer than ``launch.train``'s
#: ``--ckpt-every`` 20, so no 40 GB checkpoint of qwen2.5-3b is written
#: (a checkpoint follows step n only when n % 20 == 0, and n >= 1)
TRAIN_LM_FULL_STEPS = 5


def quickstart_kernels(backend):
    """The kernels a backend's quickstart launches: every bulk audit one
    gather (the lock-version backends' bracketed: the heap and its lock
    words; NOrec's value-log validations one each too), every store
    commit one ``commit_fused``; read and write sets stay under the bulk
    thresholds, so no ``validate`` or ``scatter_write``."""
    if backend in ("mvstore", "shardstore"):
        return ("gather_read", "commit_fused")
    if backend in LOCKVER_BACKENDS:
        return ("gather_read", "gather_bracketed")
    return ("gather_read",)


class _Tee:
    """``sys.stdout`` while a driver runs: its lines are printed and kept."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.lines)


@contextlib.contextmanager
def _train_lm_watch(name):
    """``launch.train``'s ``TrainSupervisor`` replaced by a subclass that
    keeps each supervisor and every ``(step, loss)`` its run reports, in
    order (the CLI's own ``on_step`` still runs); the checkpoints go to a
    fresh ``build/<name>`` (``tempfile.tempdir``), removed after."""
    import tempfile

    from repro_torch.launch import train as T

    real, old_tmp = T.TrainSupervisor, tempfile.tempdir
    sups = []

    class Watched(real):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.losses = []
            sups.append(self)

        def run(self, *, on_step=None, **kw):
            def watched(step, state, metrics):
                self.losses.append((step, float(metrics["loss"])))
                if on_step is not None:
                    on_step(step, state, metrics)
            return super().run(on_step=watched, **kw)

    tmp = os.path.join(HERE, "build", name)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    T.TrainSupervisor, tempfile.tempdir = Watched, tmp
    try:
        yield sups
    finally:
        T.TrainSupervisor, tempfile.tempdir = real, old_tmp
        shutil.rmtree(tmp, ignore_errors=True)


def _driver(torch, fn, totals):
    """Runs ``fn`` with every launch counter set to 0 just before and read
    just after; returns ``(fn(), launches, seconds, stdout text)``; an
    ``AssertionError`` of the driver (its own checks) fails the run."""
    from repro_torch import kernels as K

    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    K.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(tee):
            out = fn()
    except AssertionError as e:
        raise Failed(f"driver assertion: {e}") from e
    torch.cuda.synchronize()
    got = K.launch_counts()
    for k, v in got.items():
        totals[k] += v
    return out, got, time.perf_counter() - t0, tee.text()


def _nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def _bounded(fn, seconds, what):
    """``fn()`` in a daemon thread (the threads it starts are daemons
    too), waited for ``seconds``: a driver that has not returned by then
    fails the run, and its threads end with the process."""
    box = {}

    def body():
        try:
            box["out"] = fn()
        except BaseException as e:          # re-raised in the caller
            box["err"] = e

    th = threading.Thread(target=body, daemon=True)
    th.start()
    th.join(seconds)
    check(not th.is_alive(), f"{what}: not done after {seconds} s")
    if "err" in box:
        raise box["err"]
    return box["out"]


def quickstart_runs(torch, totals):
    """``quickstart.main`` on every backend of ``backend_names()``: no torn
    read (the driver asserts it), all five audits committed on every
    backend, each backend's kernels launched."""
    from repro_torch.api import backend_names
    from repro_torch.examples import quickstart as Q

    rows = []
    for b in backend_names():
        argv = ["--backend", b]
        out, got, secs, _ = _driver(
            torch, lambda: _bounded(lambda: Q.main(argv), QUICKSTART_SECONDS,
                                    f"quickstart {b}"), totals)
        st = out["stats"]
        row = {"driver": "quickstart", "backend": b, "seconds": secs,
               "audits": len(out["totals"]), "mode": st["mode"],
               "commits": st["commits"], "aborts": st["aborts"],
               "versioned_commits": st["versioned_commits"],
               "launches": _nonzero(got)}
        emit(row)
        rows.append(row)
        check(out["totals"] == [Q.N_ACCOUNTS * Q.INITIAL] * 5,
              f"quickstart {b}: audits {out['totals']}")
        for k in quickstart_kernels(b):
            check(got[k] > 0, f"quickstart {b} launched no {k}")
    return rows


def bakeoff_run(torch, totals):
    """``bakeoff.main(["--quick"])``, the reference's CI mode: every
    assertion of the reference holds as written (the driver raises
    otherwise); the rows and each claim's factor beside its bar are
    printed."""
    from repro_torch.examples import bakeoff

    out, got, secs, _ = _driver(
        torch, lambda: bakeoff.main(["--quick"]), totals)
    factors = {}
    for table, (key, size, bar, strict) in BAKEOFF_BARS.items():
        row = next(r for r in out[table] if r[key] >= size)
        factors[table] = {key: row[key], "speedup": row["speedup"],
                          "bar": bar, "strict": strict}
    emit({"driver": "bakeoff", "quick": True, "seconds": secs, **out,
          "factors": factors, "launches": _nonzero(got)})
    for k in ("validate", "gather_bracketed", "scatter_write",
              "commit_fused"):
        check(got[k] > 0, f"bakeoff launched no {k}")
    return factors


def serve_snapshots_run(torch, totals):
    """``serve_snapshots.main(["--steps", "30", "--requests", "6"])``:
    every request completes with its tokens, its served clocks never
    decrease and lie within the trainer's clocks, and the server's reads
    ran ``snapshot_select`` and its prefills ``flash_attention``; the
    snapshot aborts are recorded."""
    from repro_torch.examples import serve_snapshots as S

    out, got, secs, _ = _driver(
        torch, lambda: S.main(["--steps", "30", "--requests", "6"]), totals)
    reqs, clocks = out["requests"], out["clocks"]
    row = {"driver": "serve_snapshots", "steps": 30, "seconds": secs,
           "trainer_clocks": [clocks[0], clocks[-1]],
           "served_clocks": {r.rid: r.served_clocks for r in reqs},
           "completed": sum(r.outcome is S.Outcome.COMPLETED for r in reqs),
           "aborts": out["aborts"], "loss": out["loss"],
           "launches": _nonzero(got)}
    emit(row)
    for r in reqs:
        check(r.outcome is S.Outcome.COMPLETED and
              len(r.tokens) == r.max_new,
              f"serve_snapshots: request {r.rid} {r.outcome.value} with "
              f"{len(r.tokens)} tokens")
        sc = r.served_clocks
        check(sc == sorted(sc) and clocks[0] <= sc[0] and
              sc[-1] <= clocks[-1],
              f"serve_snapshots: request {r.rid} served at {sc}, the "
              f"trainer at {clocks[0]}..{clocks[-1]}")
    check(np.isfinite(out["loss"]), "serve_snapshots: loss not finite")
    for k in ("snapshot_select", "flash_attention"):
        check(got[k] > 0, f"serve_snapshots launched no {k}")
    return row


def train_lm_runs(torch, totals):
    """``train_lm.main``: qwen2.5-3b at full width through ``--full``
    (3,397,627,904 parameters, Mode Q, 8 x 64 tokens a step,
    ``TRAIN_LM_FULL_STEPS`` steps under ``TrainSupervisor``): finite
    losses, the "done on cuda" line, no checkpoint, and at least
    2 x 36 ``flash_attention`` launches a step (forward and recompute);
    then the docstring's drill, mamba2-780m at the smoke config with a
    failure injected at step 30 of 50: one restart, the steps replayed
    from the step-20 checkpoint give the first pass's losses bit for bit,
    and ``ssd_scan`` ran."""
    from repro_torch.configs import get_config
    from repro_torch.examples import train_lm

    def call(argv):
        def fn():
            try:
                train_lm.main(argv)
            except SystemExit as e:
                return e.code
            raise Failed(f"train_lm {argv} returned without SystemExit")
        return fn

    rows = []
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    layers = get_config(ARCH).n_layers
    with _train_lm_watch("train_lm_full") as sups:
        code, got, secs, text = _driver(torch, call(
            ["--full", "--arch", ARCH, "--steps",
             str(TRAIN_LM_FULL_STEPS)]), totals)
    sup, = sups
    losses = [loss for _, loss in sup.losses]
    row = {"driver": "train_lm", "argv": "--full", "arch": ARCH,
           "steps": TRAIN_LM_FULL_STEPS, "seconds": secs, "exit": code,
           "restarts": sup.restarts, "losses": losses,
           "checkpoints": [e for e in sup.events if e[0] == "checkpoint"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": _nonzero(got)}
    emit(row)
    rows.append(row)
    check(code == 0 and "done on cuda" in text,
          f"train_lm --full: exit {code}")
    check(len(losses) == TRAIN_LM_FULL_STEPS and sup.restarts == 0 and
          all(np.isfinite(losses)), f"train_lm --full: losses {losses}")
    check(not row["checkpoints"], "train_lm --full wrote a checkpoint")
    check(got["flash_attention"] >= 2 * layers * TRAIN_LM_FULL_STEPS,
          f"train_lm --full: {got['flash_attention']} flash_attention "
          f"launches in {TRAIN_LM_FULL_STEPS} steps of {layers} layers")
    free_card(torch)

    with _train_lm_watch("train_lm_drill") as sups:
        code, got, secs, text = _driver(torch, call(
            ["--arch", MAMBA, "--steps", "50", "--inject-failure-at", "30"]),
            totals)
    sup, = sups
    restored = [e[1] for e in sup.events if e[0] == "restored"]
    cut = next((i for i in range(1, len(sup.losses))
                if sup.losses[i][0] <= sup.losses[i - 1][0]),
               len(sup.losses))
    first = dict(sup.losses[:cut])
    replay = dict(sup.losses[cut:])
    again = sorted(set(first) & set(replay))
    row = {"driver": "train_lm", "argv": "--inject-failure-at 30",
           "arch": MAMBA, "steps": 50, "seconds": secs, "exit": code,
           "restarts": sup.restarts, "restored_at": restored,
           "replayed_steps": [again[0], again[-1]] if again else [],
           "replayed_losses_equal": all(first[s] == replay[s]
                                        for s in again),
           "launches": _nonzero(got)}
    emit(row)
    rows.append(row)
    check(code == 0 and "done on cuda: 50 steps, restarts=1" in text,
          f"train_lm drill: exit {code}")
    check(sup.restarts == 1 and restored == [20] and
          again == list(range(21, 31)),
          f"train_lm drill: restarts {sup.restarts}, restored at "
          f"{restored}, replayed {again}")
    check(row["replayed_losses_equal"],
          f"train_lm drill: replayed losses "
          f"{[replay[s] for s in again]} differ from the first pass's "
          f"{[first[s] for s in again]}")
    check(got["ssd_scan"] > 0, "train_lm drill launched no ssd_scan")
    return rows


def drivers_phase(torch):
    """Phase 12: the four drivers of ``repro_torch.examples`` through
    their ``main``, each with its launch counts (set to 0 just before,
    read just after); returns the launch totals."""
    t0 = time.perf_counter()
    totals = defaultdict(int)
    quickstart_runs(torch, totals)
    bakeoff_run(torch, totals)
    free_card(torch)
    serve_snapshots_run(torch, totals)
    train_lm_runs(torch, totals)
    free_card(torch)
    emit({"drivers_phase_seconds": time.perf_counter() - t0})
    return totals


# ---------------------------------------------------------------------------
# phase 11: the sharding layer — the sharded step on the card (a), and the
# fake-rank dry run against the card (b) and on the production pod (c)
# ---------------------------------------------------------------------------

#: (a)'s model: qwen2.5-3b at full width, SHARD_DEPTH layers, float32
SHARD_DEPTH = 2
SHARD_SEQ, SHARD_BATCH = 128, 4
SHARD_STEPS = 3
#: sharded vs plain steps on the card, float32 (rtol = atol): both run the
#: same kernels on the same tensors, so only DTensor's own operation order
#: could part them
SHARD_TOL = 1e-4
#: the dry run's per-rank peak against the trainer's measured
#: ``max_memory_allocated``: the trace counts live storages, the
#: allocator rounds blocks and holds cuBLAS workspaces
PEAK_TOL = 0.10
#: (c): two production cells on the fake 16 x 16 mesh, the second an
#: expert-parallel decode
PRODUCTION_CELLS = ((ARCH, "train_4k"), (MOONSHOT, "decode_32k"))


def dryrun_cells():
    """(b) and (c), traced on fake ranks (``launch/dryrun.py``) in a
    process of their own, spawned at the start of the run: a fake
    process group of 512 ranks, this process rank 0, whose tensors are
    ``FakeTensor``s that claim the card's device type.  Nothing is
    allocated on the card or launched there; autograd's engine asks for
    the device's primary context all the same (about 520 MiB of the
    card, held until the process ends).

    (b): ``train_trial``'s own qwen2.5-3b step (full width and depth,
    ``TRAIN_BATCH`` x ``TRAIN_SEQ``, Mode U with the fused commit and a
    2-slot ring, the ``Trainer``'s parallel config) on a fake (1, 1)
    ``"cuda"`` mesh with the default rules.  (c): ``lower_cell`` of each
    ``PRODUCTION_CELLS`` cell on the fake 16 x 16 pod."""
    import torch

    from repro_torch.configs import (MVStoreConfig, ParallelConfig,
                                     ShapeConfig, get_config)
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.launch.roofline import collective_bytes
    from repro_torch.launch.sharding import default_rules
    from repro_torch.optim import adamw

    M.fake_world()
    mesh = M.make_rank_mesh((1, 1), ("data", "model"), "cuda")
    shape = ShapeConfig("train_chip", TRAIN_SEQ, TRAIN_BATCH, "train")
    pcfg = ParallelConfig(attn_block_q=min(1024, TRAIN_SEQ),
                          attn_block_k=min(1024, TRAIN_SEQ))
    rec, memory, t = dryrun.compile_once(
        get_config(ARCH), shape, mesh, pcfg,
        MVStoreConfig(mode="U", fused_commit=True),
        adamw.AdamWConfig(warmup_steps=TRAIN_WARMUP.get(ARCH, 10)),
        default_rules(mesh))
    out = {"card_step": {"flops": rec.flops, "bytes": rec.bytes,
                         "memory": memory, "trace_s": t["trace_s"],
                         "kernels": rec.kernels,
                         "collectives": collective_bytes(rec)["ops"]}}
    for arch, shape_name in PRODUCTION_CELLS:
        row = dryrun.lower_cell(arch, shape_name, multi_pod=False)
        out[f"{arch}/{shape_name}"] = row
    out["cuda_initialized"] = torch.cuda.is_initialized()
    return out


class DryRuns:
    """``dryrun_cells`` in one spawned process started at the beginning
    of the run, beside the phases before it on a core of its own (the
    traces are CPU-bound: they must not share this process's interpreter
    with a profiler trace).  The process ends when its one task does,
    and its CUDA context with it, long before the phases that fill the
    card.  ``get`` waits for the result."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing

        self._pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"),
            max_tasks_per_child=1)
        self._future = self._pool.submit(dryrun_cells)

    def get(self):
        t0 = time.perf_counter()
        out = self._future.result()
        return out, time.perf_counter() - t0

    def close(self):
        self._pool.shutdown(cancel_futures=True)


def sharded_step_check(torch, dev):
    """(a): qwen2.5-3b at full width, ``SHARD_DEPTH`` layers, float32,
    Mode U with the fused commit, on a real process group of one rank
    (``nccl``) and a (1, 1) ``"cuda"`` mesh with the default rules.
    ``reshard_state`` moves a plain initial state onto the mesh (copies);
    ``SHARD_STEPS`` sharded steps (``make_train_step(..., rules,
    mesh)``) must match as many plain steps from the same state and
    batches — losses, parameters and moments within ``SHARD_TOL`` — with
    a one-behind reader's ``mv_snapshot`` after each step.  The kernels'
    launches (``flash_attention``, ``fused_adamw``, ``snapshot_select``)
    must be the same in both runs, and ``CommDebugMode`` must count no
    collective in the sharded run (so NCCL's stream never runs beside
    the one-stream rule's).  Returns the sharded run's launches."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import kernels as K
    from repro_torch.configs import (MVStoreConfig, ParallelConfig,
                                     ShapeConfig, get_config)
    from repro_torch.core import mvstore
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.sharding import (default_rules, is_dtensor,
                                             use_rules)
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import reshard_state

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_rank_mesh((1, 1), ("data", "model"), "cuda")
        rules = default_rules(mesh)
        cfg = dataclasses.replace(get_config(ARCH), n_layers=SHARD_DEPTH,
                                  dtype="float32")
        shape = ShapeConfig("shard_chip", SHARD_SEQ, SHARD_BATCH, "train")
        pcfg = ParallelConfig(attn_block_q=SHARD_SEQ, attn_block_k=SHARD_SEQ)
        mvcfg = MVStoreConfig(mode="U", fused_commit=True)
        opt = adamw.AdamWConfig(warmup_steps=1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        params = zoo.init_params(cfg, gen)
        plain = steps.TrainState(
            mvstore.mv_init(params, mvcfg, versioned="all"),
            adamw.init(params, opt))
        sharded = reshard_state(plain, mesh, rules)
        batches = [zoo.concrete_batch(cfg, shape, gen)
                   for _ in range(SHARD_STEPS)]
        specs = {k: v.spec for k, v in
                 zoo.input_specs(cfg, shape, rules).items()}
        sbatches = [reshard_state(b, mesh, rules, spec_tree=specs)
                    for b in batches]
        check(all(is_dtensor(t) for t in
                  _state_leaves(sharded).values()),
              "sharded: reshard_state left a plain tensor")

        def run(step, state, batches, sharded):
            losses, oks = [], []
            for b in batches:
                state, m = step(state, b)
                losses.append(m["loss"])
                with use_rules(rules if sharded else None,
                               mesh if sharded else None):
                    _, ok = mvstore.mv_snapshot(state.mv,
                                                state.mv.clock - 1)
                oks.append(ok)
            torch.cuda.synchronize()
            return state, losses, oks

        def local(t):
            return t.full_tensor() if is_dtensor(t) else t

        K.reset_launch_counts()
        plain, pl_losses, pl_oks = run(
            steps.make_train_step(cfg, pcfg, mvcfg, opt), plain, batches,
            False)
        plain_counts = K.launch_counts()
        K.reset_launch_counts()
        t1 = time.perf_counter()
        with CommDebugMode() as comm:
            sharded, sh_losses, sh_oks = run(
                steps.make_train_step(cfg, pcfg, mvcfg, opt, rules, mesh),
                sharded, sbatches, True)
        sharded_s = time.perf_counter() - t1
        counts = K.launch_counts()
        n_coll = comm.get_total_counts()
        loss_err = max(max_abs_err(torch, local(a), b, "float32",
                                   SHARD_TOL)
                       for a, b in zip(sh_losses, pl_losses))
        got = {k: local(v) for k, v in _state_leaves(sharded).items()}
        state_err = _tree_err(torch, got, _state_leaves(plain), SHARD_TOL,
                              dev)
        oks = [bool(local(o)) for o in sh_oks + pl_oks]
        row = {"phase": "sharded_step", "arch": ARCH, "layers": SHARD_DEPTH,
               "dtype": "float32", "seq": SHARD_SEQ, "batch": SHARD_BATCH,
               "steps": SHARD_STEPS, "mesh": [1, 1],
               "losses": [float(local(x)) for x in sh_losses],
               "loss_max_abs_err": loss_err,
               "state_max_abs_err": state_err, "tolerance": SHARD_TOL,
               "collectives": n_coll, "launches": counts,
               "plain_launches": plain_counts,
               "sharded_steps_s": sharded_s,
               "seconds": time.perf_counter() - t0}
        emit(row)
    finally:
        dist.destroy_process_group()
    del plain, sharded, batches, sbatches, params
    free_card(torch)
    check(all(oks), "sharded: a one-behind snapshot was not ok")
    check(n_coll == 0, f"sharded: {n_coll} collectives on a (1, 1) mesh")
    for k in ("flash_attention", "fused_adamw", "snapshot_select"):
        check(counts[k] > 0 and counts[k] == plain_counts[k],
              f"sharded: {counts[k]} {k} launches, the plain steps "
              f"{plain_counts[k]}")
    return counts


def dryrun_check(torch, got, waited_s, trainer_row):
    """(b) and (c), from ``dryrun_cells``: the dry run of the trainer's
    own step must count the flops and bytes the trainer's counted step
    wrote to ``build/roofline.jsonl``, integer for integer, and its
    per-rank peak must lie within ``PEAK_TOL`` of the trainer's
    ``max_memory_allocated``; each production cell must be ``ok`` (its
    per-rank peak, collectives by kind and trace seconds are printed)."""
    card = got["card_step"]
    roof = [r for r in ROOFLINE_ROWS if r["arch"] == ARCH
            and r["shape"] == "train_chip"]
    check(len(roof) == 1, f"no counted {ARCH} train step to compare with")
    roof = roof[0]
    peak = card["memory"]["peak_bytes_per_device"]
    measured = trainer_row["max_memory_allocated"]
    emit({"phase": "dryrun_card_step", "arch": ARCH, "mesh": [1, 1],
          "flops": card["flops"], "counted_flops": roof["flops"],
          "bytes": card["bytes"], "counted_bytes": roof["bytes"],
          "peak_bytes_per_device": peak, "max_memory_allocated": measured,
          "peak_ratio": peak / measured, "memory": card["memory"],
          "trace_s": card["trace_s"], "kernels": card["kernels"],
          "collectives": card["collectives"], "waited_s": waited_s,
          "cuda_initialized_in_trace": got["cuda_initialized"]})
    for arch, shape_name in PRODUCTION_CELLS:
        row = got[f"{arch}/{shape_name}"]
        brief = {k: row.get(k) for k in (
            "arch", "shape", "mesh", "status", "microbatches", "remat",
            "trace_s", "error")}
        if row["status"] == "ok":
            brief.update(
                peak_gb_per_rank=row["memory"]["peak_bytes_per_device"] / 1e9,
                collectives={k: {"count": v["count"],
                                 "wire_gb": v["wire_bytes"] / 1e9}
                             for k, v in row["collective_ops"].items()},
                flops_per_rank=row["fit_metrics_scanned"]["flops"],
                dominant=row["roofline"]["dominant"])
        emit({"phase": "dryrun_production_cell", **brief})
    check(card["flops"] == roof["flops"] and card["bytes"] == roof["bytes"],
          f"dry run {card['flops']} flops / {card['bytes']} bytes, the "
          f"counted step {roof['flops']} / {roof['bytes']}")
    check(abs(peak / measured - 1) <= PEAK_TOL,
          f"dry-run peak {peak} against the trainer's {measured}")
    check(not card["collectives"], "the (1, 1) trace issued collectives")
    for arch, shape_name in PRODUCTION_CELLS:
        row = got[f"{arch}/{shape_name}"]
        check(row["status"] == "ok",
              f"dry run {arch} {shape_name}: {row.get('error')}")


def sharding_phase(torch, dev, dryruns, trainer_row):
    """Phase 11: (a), then the spawned process's (b) and (c)."""
    counts = sharded_step_check(torch, dev)
    got, waited = dryruns.get()
    dryruns.close()
    dryrun_check(torch, got, waited, trainer_row)
    return counts


def main_path(torch):
    from repro_torch import kernels as K

    # 1 s windows after 0.25 s of warm-up (2 s after 0.5 s before the
    # drivers phase joined the run, 3 s before the serving phase and the
    # Mamba trainer did, 6 s after 1 s before the eval and structure phase
    # did; the eval drives the same traffic on every backend again)
    win = dict(duration_s=1.0, warmup_s=0.25)
    trials = [
        lambda: longread_trial(torch, "longread_scan4096", 4096, 12, **win),
        # one scan of 1M words under two updaters took 25-76 s on the
        # card: the window runs until the first scan completes, capped at
        # 120 s (until 3 scans or 150 s before the trainer joined the
        # run, 240 s before the model server did)
        lambda: longread_trial(torch, "longread_scan1M", 1_000_000, 16,
                               duration_s=120.0, warmup_s=0.0, min_scans=1),
        lambda: rwmix_trial(torch, "rwmix_w1024", 1024, **win),
    ]
    for b in BACKENDS[1:]:
        trials.append(lambda b=b: longread_trial(
            torch, f"longread_scan4096_{b}", 4096, 12, backend=b, **win))
        trials.append(lambda b=b: rwmix_trial(
            torch, f"rwmix_w1024_{b}", 1024, backend=b, **win))
    trials += [lambda: group_trial(torch, "group_tl2_1M", "tl2", **win),
               lambda: group_trial(torch, "group_dctl_1M", "dctl", **win),
               lambda: mvstore_trial(torch, "mvstore_1M", **win)]
    totals = defaultdict(int)
    rows = {}

    def one(trial):
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        row = trial()
        torch.cuda.synchronize()
        row["launches"] = K.launch_counts()
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        for k, v in row["launches"].items():
            totals[k] += v
        emit(row)
        rows[row["trial"]] = row
        check(row["violations"] == 0, f"{row['trial']}: violations")

    for t in trials:
        one(t)
    PHASE4_ROWS.update(rows)
    # the group publish and the MVStore's ran through their kernels
    # (DCTL groups release only: no commit_fused by design)
    check(rows["group_tl2_1M"]["launches"]["commit_fused"] > 0,
          "group_tl2_1M launched no commit_fused")
    for k in ("commit_fused", "snapshot_select", "gather_read"):
        check(rows["mvstore_1M"]["launches"][k] > 0,
              f"mvstore_1M launched no {k}")
    natural = sum(r.get("window_launches", r["launches"])["mirror_select"]
                  for r in rows.values())
    if natural == 0:
        # the trials' windows never resolved a versioned read through the
        # mirror: pin Mode U (api/registry.py forced_mode) so they do
        one(lambda: longread_trial(torch, "longread_scan4096_forcedU", 4096,
                                   12, forced_mode="U", **win))
        natural = rows["longread_scan4096_forcedU"]["window_launches"][
            "mirror_select"]
    check(natural > 0, "no trial window resolved a versioned read through "
                       "mirror_select")
    return totals


def idle_shares(torch):
    """The card's idle share in four trials (2 s windows), each run again
    under a ``torch.profiler`` trace of its GPU activity (kernels, copies,
    memsets): idle share = 1 - busy time / window.  Kept apart from the
    main path, whose numbers stay untraced; its launches are not counted.
    (The model servers' traces are taken on the serving trials' own
    servers, after their counted requests: ``idle_trace``.)"""
    from torch.profiler import ProfilerActivity

    from repro_torch import kernels as K

    # 2 s windows after 0.5 s (3 s after 1 s before the serving phase
    # and the Mamba trainer joined the run)
    traced = {
        "longread_scan4096": lambda p: longread_trial(
            torch, "longread_scan4096", 4096, 12, TRACE_S, 0.5, probe=p),
        "rwmix_w1024": lambda p: rwmix_trial(
            torch, "rwmix_w1024", 1024, TRACE_S, 0.5, probe=p),
        "group_tl2_1M": lambda p: group_trial(
            torch, "group_tl2_1M", "tl2", TRACE_S, 0.5, probe=p),
        "mvstore_1M": lambda p: mvstore_trial(torch, "mvstore_1M", TRACE_S, 0.5,
                                              probe=p),
    }
    for name, trial in traced.items():
        prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        row = trial(prof)
        check(row["violations"] == 0, f"traced {name}: violations")
        n, busy_us, _ = gpu_activity(prof)
        window_ms = row["seconds"] * 1e3
        emit({"trace": name, "window_s": row["seconds"], "gpu_events": n,
              "device_busy_ms": busy_us / 1e3 if n else None,
              "device_idle_share": 1 - busy_us / 1e3 / window_ms if n
              else None})
    K.reset_launch_counts()


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _lib
        from repro_torch.launch.roofline import HBM_BW
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    t_run = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    check(smi, "nvidia-smi printed nothing")
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    laps, t_lap = {}, t_run

    def lap(name):
        """Records the seconds since the previous lap under ``name``."""
        nonlocal t_lap
        now = time.perf_counter()
        laps[name] = now - t_lap
        t_lap = now

    # the full-width train checks' CPU runs, beside the build and phase 3's
    # checks (no profiler trace and no timing there: the kernel checks,
    # which trace, wait until they are done)
    cpu_reference = CPUReference(torch, (ARCH, MAMBA))
    prefills = StructurePrefills()
    dryruns = DryRuns()
    t0 = time.perf_counter()
    _lib.library()
    emit({"build_seconds": time.perf_counter() - t0,
          "library": os.path.relpath(str(_lib.library_path()), HERE)})
    emit({"mma_build": mma_build_check()})
    lap("build")

    dev = torch.device("cuda")
    schedule_check(torch)
    lap("schedules")
    model_check(torch, dev)
    model_check(torch, dev, arch=MAMBA, prompt=(2, 512))
    lap("model_checks")
    train_check(torch, dev, cpu=cpu_reference)
    train_check(torch, dev, arch=MAMBA, cpu=cpu_reference)
    lap("train_checks")
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    timings = kernel_checks(torch, dev, rng)
    for name, row in timings.pop("host_paths").items():
        emit({"host_path": name, **row})
    for name, by_n in timings.items():
        for n, row in by_n.items():
            emit({"kernel": name, "n": n, "bound_by": "bytes", **row,
                  "hbm_bytes_per_s": HBM_BW})
    emit({"kernel_checks_seconds": time.perf_counter() - t0,
          "integer_kernels_bit_identical": True,
          "flash_attention_within_tolerance": True,
          "fused_adamw_within_tolerance": True,
          "ssd_scan_within_tolerance": True})
    lap("kernel_checks")
    launches = main_path(torch)
    lap("stm_trials")
    served, toks = serving_trial(torch, launches, idle_window_s=TRACE_S)
    snapshot_checks(torch, launches, toks)
    free_card(torch)
    _, toks = serving_trial(torch, launches, arch=MAMBA,
                            idle_window_s=TRACE_S)
    snapshot_checks(torch, launches, toks, arch=MAMBA, modes=("U",))
    free_card(torch)
    lap("servers")
    qwen_trainer = train_trial(torch, launches)
    train_trial(torch, launches, arch=MAMBA)
    supervisor_drill(torch)
    lap("trainers")
    t0 = time.perf_counter()
    for part in (eval_phase(torch), structures_phase(torch, prefills)):
        for k, v in part.items():
            launches[k] += v
    prefills.close()
    emit({"eval_and_structures_seconds": time.perf_counter() - t0})
    lap("phase5_eval_and_structures")
    for name, phase in (("phase6_shards", shard_phase),
                        ("phase7_reliability", reliability_phase),
                        ("phase8_serving", serving_phase),
                        ("phase9_families",
                         lambda torch: families_phase(torch, dev)),
                        ("phase9b_seamless",
                         lambda torch: seamless_phase(torch, dev)),
                        ("phase9c_family_trainers",
                         lambda torch: family_training_phase(torch, dev)),
                        ("phase12_drivers", drivers_phase)):
        for k, v in phase(torch).items():
            launches[k] += v
        lap(name)
    for k in KERNELS:
        check(launches[k] > 0, f"kernel {k} was never launched on the main "
                               "path")
    idle_shares(torch)
    lap("phase10_idle_shares")
    for k, v in sharding_phase(torch, dev, dryruns, qwen_trainer).items():
        launches[k] += v
    lap("phase11_sharding")
    emit({"phase_seconds": laps})
    from repro_torch.launch import roofline_report

    os.makedirs(os.path.dirname(ROOFLINE_JSONL), exist_ok=True)
    with open(ROOFLINE_JSONL, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in ROOFLINE_ROWS)
    print(roofline_report.to_markdown(roofline_report.render(ROOFLINE_JSONL)),
          flush=True)
    emit({"roofline_rows": len(ROOFLINE_ROWS),
          "mfu": {f"{r['shape']}_{r['arch']}": r["mfu"]
                  for r in ROOFLINE_ROWS}})
    check(len(ROOFLINE_ROWS) == 10, f"{len(ROOFLINE_ROWS)} roofline rows, "
                                    "not 5 trainers and 5 servers")

    summary = []
    for name, (src, replaces, n) in KERNELS.items():
        row = timings[name][n]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row.get("max_abs_err", 0),
            "tolerance": row.get("tolerance", 0), "n": n,
            "shape": row.get("shape"),
            "ms": row["ms"], "kernel_device_ms": row["kernel_device_ms"],
            "device_busy_ms": row["device_busy_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row.get("bound_by", "bytes"),
            "library_ms": row["library_ms"]})
    emit({"run_seconds": time.perf_counter() - t_run})
    print(smi[0], flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
