"""The port's training path against the JAX package's, on the CPU: train
steps, trainers, data, checkpoints and the supervisor (the gradients are
``test_torch_grad.py``'s).

The reduced qwen2.5-3b config (2 layers, width 64) at sequence 32 and
batch 2.  Weights come from the reference's ``init_params`` (or its
``Trainer``) and are carried across by ``params_from_numpy``; every other
input is made with numpy from a seed.  float32 runs are held within 2e-4
(moments 1e-5), bfloat16 within 2e-2: the tolerances of
``tests/test_kernels.py``.  The JAX trainer runs are shared through a
module-scoped fixture.  Each trainer scenario trains on one repeated
batch, so that its 6 steps show the loss falling.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import snapshotter as J_SNAP
from repro.configs import MVStoreConfig as JMVStoreConfig
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import smoke_config as j_smoke_config
from repro.core import mvstore as J_MVS
from repro.data import pipeline as J_DATA
from repro.launch.train import Trainer as JTrainer
from repro.models import model_zoo as J_ZOO
from repro.optim import adamw as J_ADAMW
from repro_torch.checkpoint import snapshotter as SNAP
from repro_torch.configs import MVStoreConfig, ParallelConfig, ShapeConfig, \
    smoke_config
from repro_torch.core import mvstore as MVS
from repro_torch.data import pipeline as DATA
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.train import Trainer
from repro_torch.models import model_zoo as ZOO
from repro_torch.optim import adamw as ADAMW
from repro_torch.runtime.fault_tolerance import FaultPlan, TrainSupervisor

ARCH = "qwen2.5-3b"
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")
STEPS_N = 6
OPT = dict(lr=3e-3, warmup_steps=5, total_steps=1000)
#: the trainer scenarios: name -> MVStoreConfig keywords
RUNS = {"Q": dict(mode="Q"), "U": dict(mode="U"),
        "U_fused": dict(mode="U", fused_commit=True),
        "off": dict(enabled=False)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: faster here,
    and it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype):
    jc = dataclasses.replace(j_smoke_config(ARCH), dtype=dtype)
    tc = dataclasses.replace(smoke_config(ARCH), dtype=dtype)
    return jc, tc


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _params(jc, seed=0):
    """Reference params with seeded biases, as (jax tree, numpy tree)."""
    jp = J_ZOO.init_params(jc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    flat, tdef = jax.tree_util.tree_flatten_with_path(jp)
    leaves = []
    for path, leaf in flat:
        if "b_" in jax.tree_util.keystr(path):
            leaf = jnp.asarray(rng.normal(0, 0.5, leaf.shape),
                               jnp.float32).astype(leaf.dtype)
        leaves.append(leaf)
    jp = jax.tree_util.tree_unflatten(tdef, leaves)
    return jp, jax.tree.map(np.asarray, jp)


def _batch(cfg, seed=0):
    b = DATA.SyntheticLM(cfg.vocab_size, 32, 2, seed=seed).global_batch_at(0)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# train steps and trainers against the reference's
# ---------------------------------------------------------------------------


def _shape():
    return ShapeConfig("t", 32, 2, "train")


def _state_np(mv, opt):
    """A train state's live blocks, moments, rings and clock as numpy,
    keyed by path (either package: the port's clock is a host int)."""
    if isinstance(mv.clock, int):
        def flat(tree):
            return {p: _np(t) for p, t in MVS._flatten(tree)}
        rings = {p: (_np(mv.ring[p]), mv.ring_ts[p].numpy().copy())
                 for p in mv.ring}
    else:
        def flat(tree):
            return {jax.tree_util.keystr(p): _np(x) for p, x in
                    jax.tree_util.tree_flatten_with_path(tree)[0]}
        rings = {p: (_np(mv.ring[p]), np.asarray(mv.ring_ts[p]))
                 for p in mv.ring}
    return {"live": flat(mv.live), "mu": flat(opt.mu), "nu": flat(opt.nu),
            "rings": rings, "clock": int(mv.clock)}


def _jax_run(name):
    jc, _ = _cfgs("float32")
    tr = JTrainer(jc, JShapeConfig("t", 32, 2, "train"),
                  mvcfg=JMVStoreConfig(**RUNS[name]),
                  opt_cfg=J_ADAMW.AdamWConfig(**OPT), seed=1)
    init = jax.tree.map(np.asarray, tr.state.mv.live)
    batch = tr.batch_at(0)
    state, out = tr.state, {"init": init, "losses": [], "views": []}
    for s in range(STEPS_N if name != "off" else 1):
        state, metrics = tr.train_step(state, batch)
        out["losses"].append(float(metrics["loss"]))
        if s == 0:
            out["first"] = _state_np(state.mv, state.opt)
        if name == "U":
            view, ok = J_MVS.mv_snapshot(state.mv, int(state.mv.clock) - 1)
            out["views"].append((bool(ok), _np(view["lm_head"])))
    tr.controller.stop()
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _jax_run(name) for name in RUNS}


def _port_run(name, init, dtype="float32", steps=STEPS_N):
    _, tc = _cfgs(dtype)
    tr = Trainer(tc, _shape(), mvcfg=MVStoreConfig(**RUNS[name]),
                 opt_cfg=ADAMW.AdamWConfig(**OPT), params=init,
                 device="cpu")
    batch = tr.batch_at(0)
    state, out = tr.state, {"losses": [], "views": [], "prev": []}
    for s in range(steps):
        prev = MVS._flatten(state.mv.live)
        state, metrics = tr.train_step(state, batch)
        out["losses"].append(float(metrics["loss"]))
        if s == 0:
            out["first"] = _state_np(state.mv, state.opt)
        if name in ("U", "U_fused"):
            view, ok = MVS.mv_snapshot(state.mv, state.mv.clock - 1)
            out["views"].append((bool(ok), _np(view["lm_head"])))
            out["prev"].append(all(
                torch.equal(v, p) for (_, v), (_, p) in
                zip(MVS._flatten(view), prev)))
    tr.controller.stop()
    out["state"] = state
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_train_step_matches_reference(name, jax_runs):
    """One ``make_train_step`` of each commit branch (fused; adamw.apply +
    mv_commit in Mode Q and Mode U; no MVStore) from the same weights and
    batch: loss, live blocks, moments, rings and clock."""
    ref = jax_runs[name]
    got = _port_run(name, ref["init"], steps=1)
    _close(got["losses"][0], ref["losses"][0], TOL["float32"])
    g, r = got["first"], ref["first"]
    assert g["clock"] == r["clock"] == 1
    assert sorted(g["live"]) == sorted(r["live"])
    for key, tol in (("live", TOL["float32"]), ("mu", 1e-5), ("nu", 1e-5)):
        for path in r[key]:
            _close(g[key][path], r[key][path], tol)
    assert sorted(g["rings"]) == sorted(r["rings"])
    assert bool(g["rings"]) == (name in ("U", "U_fused"))
    for path, (ring, ts) in r["rings"].items():
        _close(g["rings"][path][0], ring, TOL["float32"])
        np.testing.assert_array_equal(g["rings"][path][1], ts)


def test_trainer_loss_decreases(jax_runs):
    got = _port_run("Q", jax_runs["Q"]["init"])["losses"]
    _close(np.array(got), np.array(jax_runs["Q"]["losses"]), TOL["float32"])
    assert np.mean(got[-2:]) < np.mean(got[:2]) - 1.0, got


def test_trainer_mode_u_matches_mode_q(jax_runs):
    """The versioned commit does not change training math: Mode-U and
    Mode-Q runs from the same weights give the same losses."""
    lq = _port_run("Q", jax_runs["Q"]["init"])["losses"]
    lu = _port_run("U", jax_runs["U"]["init"])["losses"]
    np.testing.assert_allclose(lq, lu, rtol=1e-5, atol=1e-5)
    _close(np.array(lu), np.array(jax_runs["U"]["losses"]), TOL["float32"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_trainer_fused_matches_unfused(dtype, jax_runs):
    """The fused_adamw path equals adamw.apply + mv_commit (within the
    reference's 2e-3), and, at float32, the reference's fused run."""
    init = jax_runs["U"]["init"]
    if dtype == "bfloat16":
        init = jax.tree.map(lambda a: np.asarray(
            jnp.asarray(a).astype(jnp.bfloat16)), init)
    base = _port_run("U", init, dtype)["losses"]
    fused = _port_run("U_fused", init, dtype)["losses"]
    np.testing.assert_allclose(base, fused, rtol=2e-3, atol=2e-3)
    if dtype == "float32":
        _close(np.array(fused), np.array(jax_runs["U_fused"]["losses"]),
               TOL["float32"])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m"])
def test_cpu_runs_of_every_mode_equal_mode_q(arch):
    """On the CPU, Mode U's versioned commit and its fused commit leave
    Mode Q's losses, live blocks and moments bit for bit (float32, 2
    steps from one set of weights): ``chip_smoke.py``'s train check holds
    the card's runs of several modes against one CPU run of Mode Q."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    shape = ShapeConfig("modes", 32, 2, "train")
    init = SH.tree_map(lambda t: t.numpy(), ZOO.init_params(
        cfg, torch.Generator().manual_seed(0)))
    runs = {}
    for name in ("Q", "U", "U_fused"):
        tr = Trainer(cfg, shape, mvcfg=MVStoreConfig(**RUNS[name]),
                     params=init, device="cpu")
        state, tr.state = tr.state, None
        losses = []
        for step in range(2):
            state, metrics = tr.train_step(state, tr.batch_at(step))
            losses.append(float(metrics["loss"]))
        tr.controller.stop()
        runs[name] = losses, {
            f"{k}{p}": t for k, tree in (("live", state.mv.live),
                                         ("mu", state.opt.mu),
                                         ("nu", state.opt.nu))
            for p, t in MVS._flatten(tree)}
    want_losses, want = runs["Q"]
    for name in ("U", "U_fused"):
        losses, got = runs[name]
        assert losses == want_losses, name
        assert sorted(got) == sorted(want), name
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)


@pytest.mark.parametrize("name", ["U", "U_fused"])
def test_snapshot_during_training(name, jax_runs):
    """A reader one step behind gets a consistent view while commits keep
    landing: ok, bit for bit the previous step's live blocks, moving from
    step to step — and the reference's views."""
    run = _port_run(name, jax_runs["U"]["init"])
    assert all(ok for ok, _ in run["views"])
    assert all(run["prev"])
    views = [v for _, v in run["views"]]
    assert any(not np.array_equal(views[i], views[i + 1])
               for i in range(len(views) - 1))
    for (ok, got), (jok, want) in zip(run["views"], jax_runs["U"]["views"]):
        assert ok == jok
        _close(got, want, TOL["float32"])


def test_fused_commit_fences_the_ring_slot():
    """The fused commit's ring slot reads NO_TS while its kernel runs and
    the new clock after: ``mv_snapshot`` at the old clock inside that
    window gets the other slot, never the slot being rewritten."""
    _, tc = _cfgs("float32")
    tr = Trainer(tc, _shape(), mvcfg=MVStoreConfig(mode="U",
                                                   fused_commit=True),
                 device="cpu", seed=2)
    seen = []
    real = STEPS.FA.fused_adamw

    def spy(p, g, m, v, ring, slot, scalars, **kw):
        ts = [ts for path, ts in tr.state.mv.ring_ts.items()
              if tr.state.mv.ring[path] is ring][0]
        seen.append(int(ts[slot]))
        return real(p, g, m, v, ring, slot, scalars, **kw)

    STEPS.FA.fused_adamw, saved = spy, STEPS.FA.fused_adamw
    try:
        state, _ = tr.train_step(tr.state, tr.batch_at(0))
    finally:
        STEPS.FA.fused_adamw = saved
        tr.controller.stop()
    assert seen and set(seen) == {MVS.NO_TS}
    assert all(int(ts[1]) == 1 and int(ts[0]) == 0
               for ts in state.mv.ring_ts.values())


def test_microbatches_match_the_whole_batch():
    """Gradient accumulation over 2 microbatches (f32 accumulators / M)
    gives the whole batch's step: the loss is the mean of the two, and
    the updated blocks agree within float32 rounding."""
    jc, tc = _cfgs("float32")
    _, npp = _params(jc, seed=8)
    _, tb = _batch(tc, seed=9)
    out = {}
    for m in (1, 2):
        pcfg = ParallelConfig(microbatches=m, attn_block_q=16,
                              attn_block_k=16)
        params = ZOO.params_from_numpy(npp)
        mvcfg = MVStoreConfig(mode="Q")
        state = STEPS.TrainState(MVS.mv_init(params, mvcfg),
                                 ADAMW.init(params, ADAMW.AdamWConfig()))
        step = STEPS.make_train_step(tc, pcfg, mvcfg, ADAMW.AdamWConfig())
        out[m] = step(state, tb)
    _close(out[2][1]["loss"], out[1][1]["loss"], 1e-5)
    for (_, a), (_, b) in zip(MVS._flatten(out[2][0].mv.live),
                              MVS._flatten(out[1][0].mv.live)):
        _close(a, b, TOL["float32"])


# ---------------------------------------------------------------------------
# data, checkpoints, supervisor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (7, 1, 2),
                                                 (123, 3, 4)])
def test_synthetic_batches_are_the_references(step, shard, n_shards):
    for seed in (0, 5):
        want = J_DATA.SyntheticLM(512, 32, 8, seed=seed).shard_batch(
            step, shard, n_shards)
        got = DATA.SyntheticLM(512, 32, 8, seed=seed).shard_batch(
            step, shard, n_shards)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    jc, tc = _cfgs("bfloat16")
    jit = J_DATA.make_batch_iterator(jc, JShapeConfig("t", 32, 2, "train"),
                                     start_step=step)
    it = DATA.make_batch_iterator(tc, _shape(), start_step=step)
    for _ in range(2):
        want, got = next(jit), next(it)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def _to_numpy(tree):
    """A tree of tensors as numpy (bfloat16 through ``ml_dtypes``)."""
    def one(t):
        if t.dtype == torch.bfloat16:
            return np.asarray(jnp.asarray(t.float().numpy())
                              .astype(jnp.bfloat16))
        return t.detach().numpy().copy()
    return SH.tree_map(one, tree)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_across_packages(writer, tmp_path):
    """A checkpoint written by either package restores in the other
    (bfloat16 leaves as float32 ``.npy``, the manifest's paths), every
    leaf bit for bit and of its logical dtype."""
    jc, tc = _cfgs("bfloat16")
    tr = Trainer(tc, _shape(), mvcfg=MVStoreConfig(mode="U"), device="cpu",
                 seed=4)
    state, _ = tr.train_step(tr.state, tr.batch_at(0))
    tr.controller.stop()
    tree = {"params": state.mv.live, "opt": state.opt}
    jtree = {"params": jax.tree.map(jnp.asarray, _to_numpy(state.mv.live)),
             "opt": J_ADAMW.AdamWState(
                 jax.tree.map(jnp.asarray, _to_numpy(state.opt.mu)),
                 jax.tree.map(jnp.asarray, _to_numpy(state.opt.nu)),
                 jnp.asarray(int(state.opt.count), jnp.int32))}
    if writer == "port":
        SNAP.save_checkpoint(str(tmp_path), 1, tree, extra={"k": 1})
        jtmpl = {"params": J_ZOO.init_params(jc, jax.random.PRNGKey(0)),
                 "opt": J_ADAMW.init(jtree["params"], J_ADAMW.AdamWConfig())}
        step, got, extra = J_SNAP.restore_checkpoint(str(tmp_path), jtmpl)
        flat_got = {jax.tree_util.keystr(p): x for p, x in
                    jax.tree_util.tree_flatten_with_path(got)[0]}
    else:
        J_SNAP.save_checkpoint(str(tmp_path), 1, jtree, extra={"k": 1})
        tmpl = {"params": SH.tree_map(torch.zeros_like, state.mv.live),
                "opt": ADAMW.init(state.mv.live, ADAMW.AdamWConfig())}
        step, got, extra = SNAP.restore_checkpoint(str(tmp_path), tmpl)
        assert isinstance(got["opt"], ADAMW.AdamWState)
        flat_got = dict(SNAP._flatten(got))
    assert step == 1 and extra == {"k": 1}
    assert os.path.isfile(tmp_path / "step_00000001" / "manifest.json")
    flat_want = dict(SNAP._flatten(tree))
    assert sorted(flat_got) == sorted(flat_want) == sorted(
        jax.tree_util.keystr(p) for p, _ in
        jax.tree_util.tree_flatten_with_path(jtree)[0])
    for path, x in flat_got.items():
        assert str(x.dtype).replace("torch.", "") == \
            str(flat_want[path].dtype).replace("torch.", "")
        np.testing.assert_array_equal(_np(x), _np(flat_want[path]))


def test_supervisor_restart_gives_the_uninterrupted_losses(tmp_path):
    """An injected failure at step 3 with checkpoints every 2 steps:
    the supervisor restores step 2 and replays; every step's loss equals
    the uninterrupted run's."""
    _, tc = _cfgs("float32")

    def run(fault, ckpt_dir):
        tr = Trainer(tc, _shape(), mvcfg=MVStoreConfig(mode="U",
                                                       fused_commit=True),
                     device="cpu", seed=6)
        sup = TrainSupervisor(ckpt_dir=str(ckpt_dir), ckpt_every=2,
                              reader=tr.snapshot_reader())
        losses = {}
        try:
            step, _ = sup.run(
                state=tr.state, train_step=tr.train_step,
                batch_at=tr.batch_at, n_steps=STEPS_N, fault_plan=fault,
                on_step=lambda s, st, m: losses.__setitem__(
                    s, float(m["loss"])))
        finally:
            tr.controller.stop()
            sup.manager.close()
        return step, sup, losses

    step0, sup0, base = run(None, tmp_path / "a")
    step1, sup1, got = run(FaultPlan(fail_at_steps=(3,)), tmp_path / "b")
    assert step0 == step1 == STEPS_N
    assert sup0.restarts == 0 and sup1.restarts == 1
    assert ("restored", 2, "") in sup1.events
    assert sup1.manager.stats()["errors"] == 0
    assert got == base


def test_supervisor_write_ahead_log_is_not_ported(tmp_path):
    """(Named for the refusal it replaced.)  ``TrainSupervisor(wal=...)``:
    a failure at step 3 with checkpoints every 2 steps finishes with the
    uninterrupted losses; every checkpoint writes the log's base image —
    the first live block at the step's clock, cast to int64 as the
    reference casts it, which the reference's scan reads back — and the
    restore scans the log."""
    from repro.reliability import wal as J_WAL
    from repro_torch.reliability import wal as T_WAL

    _, tc = _cfgs("float32")

    def run(fault, name, wal=None):
        tr = Trainer(tc, _shape(), mvcfg=MVStoreConfig(mode="U",
                                                       fused_commit=True),
                     device="cpu", seed=6)
        sup = TrainSupervisor(ckpt_dir=str(tmp_path / name), ckpt_every=2,
                              reader=tr.snapshot_reader(), wal=wal)
        losses, lives = {}, {}

        def on_step(s, st, m):
            losses[s] = float(m["loss"])
            key = next(iter(st.mv.live))
            lives[s] = (st.mv.live[key].to(torch.int64).numpy().copy(),
                        int(st.mv.clock))
        try:
            step, _ = sup.run(state=tr.state, train_step=tr.train_step,
                              batch_at=tr.batch_at, n_steps=STEPS_N,
                              fault_plan=fault, on_step=on_step)
        finally:
            tr.controller.stop()
            sup.manager.close()
        return step, sup, losses, lives

    _, _, base, _ = run(None, "a")
    wal = T_WAL.WriteAheadLog(str(tmp_path / "wal"))
    step, sup, got, lives = run(FaultPlan(fail_at_steps=(3,)), "b", wal)
    assert step == STEPS_N and sup.restarts == 1 and got == base
    assert [e for e in sup.events if e[0] == "wal_scan"] == [
        ("wal_scan", 2, "records=0 undrained=0 torn=0")]
    wal.close()
    for scan in (T_WAL.scan_dir, J_WAL.scan_dir):
        recs, torn, (floor, heap, clock) = scan(str(tmp_path / "wal"))
        assert recs == [] and torn == 0 and floor == 0
        assert clock == lives[STEPS_N][1]
        np.testing.assert_array_equal(heap, lives[STEPS_N][0])


def test_cli_trains_on_the_cpu_when_asked(capsys, tmp_path):
    from repro_torch.launch import train

    assert train.main(["--smoke", "--device", "cpu", "--steps", "3",
                       "--seq", "16", "--batch", "2", "--ckpt-every", "2",
                       "--mv-mode", "U", "--ckpt-dir",
                       str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "done on cpu: 3 steps, restarts=0" in out
    assert os.path.isdir(tmp_path / "step_00000002")
