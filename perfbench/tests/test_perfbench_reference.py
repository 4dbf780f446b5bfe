"""The plain references against the program at reduced widths on the CPU,
in float32: prefill and decode logits, the first training steps, and the
versions a Mode-U ring holds."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench.harness import model, weights
from perfbench.reference import dense, mamba2
from perfbench.tests import smoke

SEED = 2**31 + 101


def _program(arch: str, dtype: str = "float32"):
    from repro_torch.configs import smoke_config
    pcfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    cfg = smoke.config_file(arch, pcfg)
    w = weights.make(model.leaves(pcfg), SEED, "cpu",
                     cfg["init"]["embed_std"])
    return pcfg, cfg, w


def _program_logits(pcfg, w, prompt, tokens):
    """The program's prefill then one decode step a token (batch 1)."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.models import model_zoo as zoo
    par = ParallelConfig(remat="none")
    with torch.no_grad():
        lg, cache, clen = zoo.prefill_fn(w, {"tokens": prompt[None]}, pcfg,
                                         par)
        if pcfg.family != "ssm":      # room for the decoded positions
            full = zoo.init_cache(pcfg, 1, len(prompt) + len(tokens),
                                  torch.float32)

            def put(f, c):
                f[:, :, :c.shape[2]] = c
                return f
            cache = {k: {n: put(full[k][n], c) for n, c in v.items()}
                     for k, v in cache.items()}
        rows = [lg[0]]
        for t in tokens[:-1]:
            lg, cache, clen = zoo.decode_fn(
                w, cache, clen, t.reshape(1).to(torch.int32), pcfg, par)
            rows.append(lg[0])
    return torch.stack(rows)


def test_dense_reference_matches_program():
    pcfg, cfg, w = _program("deepseek-7b")
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg["vocab_size"], (24,), generator=g)
    toks = torch.randint(0, cfg["vocab_size"], (5,), generator=g)
    prog = _program_logits(pcfg, w, prompt, toks)
    ref = dense.logits(w, torch.cat([prompt, toks[:-1]]), cfg,
                       len(prompt) - 1)
    torch.testing.assert_close(prog, ref, atol=2e-4, rtol=2e-4)


def test_mamba2_reference_matches_program():
    pcfg, cfg, w = _program("mamba2-780m")
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg["vocab_size"], (64,), generator=g)
    toks = torch.randint(0, cfg["vocab_size"], (5,), generator=g)
    prog = _program_logits(pcfg, w, prompt, toks)
    lg, st = mamba2.prefill(w, prompt[None], cfg)
    rows = [lg[0]]
    for t in toks[:-1]:
        lg, st = mamba2.decode(w, t.reshape(1), st, cfg)
        rows.append(lg[0])
    torch.testing.assert_close(prog, torch.stack(rows), atol=2e-4,
                               rtol=2e-4)


def test_mamba2_loss_matches_program():
    from repro_torch.configs import ParallelConfig
    from repro_torch.models import model_zoo as zoo
    pcfg, cfg, w = _program("mamba2-780m")
    g = torch.Generator().manual_seed(3)
    tok = torch.randint(0, cfg["vocab_size"], (2, 33), generator=g)
    batch = {"tokens": tok[:, :-1].to(torch.int32),
             "labels": tok[:, 1:].to(torch.int32)}
    with torch.no_grad():
        prog = zoo.loss_fn(w, batch, pcfg, ParallelConfig(remat="none"))
        ref = mamba2.loss(w, batch["tokens"], batch["labels"], cfg)
    assert float(prog) == pytest.approx(float(ref), abs=1e-5)


def test_first_steps_and_ring_versions_match():
    """The training driver's own comparison at reduced width: the
    program's first steps against the reference's, and the ring's versions
    against the parameters the trainer published."""
    from perfbench.drivers import train
    from perfbench.harness.traffic import Batches
    from repro_torch.core import mvstore
    ctx = smoke.context("mamba2-780m.train_U", mix=smoke.TRAIN_MIX,
                        seed=SEED)
    pcfg = model.program_config(ctx)
    w0 = weights.make(model.leaves(pcfg), ctx.seed, "cpu",
                      ctx.config["init"]["embed_std"])
    trainer, ctl = train.make_trainer(ctx, pcfg, w0, torch.device("cpu"))
    batches = Batches(ctx.traffic, ctx.seed, ctx.config["vocab_size"])
    prog = train.first_steps(ctx, trainer, ctl, batches, w0)
    ref = train.reference_steps(ctx, torch.device("cpu"), batches)
    cmp = train.compare_steps(prog, ref)
    assert cmp["loss_gap"] < 1e-3
    assert cmp["grad1_gap"] < 2e-2 and cmp["change_gap"] < 2e-2
    # each version the step before it stands apart from the step's own
    assert train.compare_steps(prog, ref, "stale_change")["change_gap"] > 0.2
    mv = trainer.state.mv
    assert int(mv.clock) == ctx.traffic["checked_steps"]
    versions = train.ring_versions(mv)
    assert sorted(versions) == list(range(int(mv.clock) + 1))
    for c, v in versions.items():
        view, ok = mvstore.mv_snapshot(mv, c, assume_versioned=True)
        assert bool(ok)
        for path, leaf in mvstore._flatten(view):
            assert torch.equal(leaf, v[weights.parse_path(path)]), (c, path)
    first = train.flat(w0)
    for path, t in versions[0].items():
        assert torch.equal(t, first[path])
    assert all(c.ok for c in train.ring_checks(
        mv, ctx.config["mvstore"]["ring_slots"]))
