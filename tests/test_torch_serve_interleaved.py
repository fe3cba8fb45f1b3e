"""The port's interleaved (V > 1) serving and the restack handoff against
the JAX package, on the CPU.

``llama3.2-1b`` (2 kv heads) and ``mamba2-2.7b`` reduced to 4 layers,
d_model 64, on 2 stages of 2 chunks; weights made by the JAX package and
carried over by ``repro_torch.convert``; tokens from numpy seeds.  The
port's interleaved prefill in two segments (the JAX
``prefill_equivalence`` case), then 4 teacher-forced decode steps on the
same interleaved plan (``interleaved_decode``), against the JAX
single-device ``M.decode_step``: logits within atol/rtol 2e-4, the serve
slice's tolerance.
"""
import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import schedplan as SP
from repro_torch.launch import serve as tserve
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

TOL = 2e-4
B, P1, P2, STEPS, MAX_LEN = 4, 8, 8, 4, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, leaving the other cores to the
    test files that run beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    over = dict(stages=2, tensor=1, virtual=2)
    if arch == "llama3.2-1b":
        over["n_kv_heads"] = 2
    kw = dict(n_layers=4, d_model=64)
    return (dataclasses.replace(get_config(arch).reduced(**kw), **over),
            dataclasses.replace(jax_get_config(arch).reduced(**kw), **over))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """JAX-made stacked weights (numpy), the tokens, and the JAX
    single-device logits of both prefill segments and each decode step."""
    _, jcfg = _cfgs(arch)
    jplan = JST.plan_stages(jcfg)
    pnp = jax.tree.map(np.asarray, JST.init_stacked_params(
        jcfg, jax.random.PRNGKey(0), jplan))
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab, (B, P1 + P2 + STEPS)).astype(np.int32)
    rp = dict(pnp, layers=jax.tree.map(
        lambda a: JST.unstack_chunks(a, jplan)[:jcfg.n_layers],
        pnp["layers"]))
    step = jax.jit(lambda p, b, c: JM.decode_step(jcfg, p, b, c))
    cache = JM.init_cache(jcfg, B, max_len=MAX_LEN)
    want = []
    for lo, hi in [(0, P1), (P1, P1 + P2)] + [
            (t, t + 1) for t in range(P1 + P2, P1 + P2 + STEPS)]:
        lg, cache = step(rp, dict(tokens=jnp.asarray(toks[:, lo:hi])), cache)
        want.append(np.asarray(lg[:, -1]))
    return pnp, toks, want


@pytest.mark.parametrize("arch,microbatches", [
    ("llama3.2-1b", 2), ("llama3.2-1b", 4), ("mamba2-2.7b", 2)])
def test_interleaved_serve_matches_jax(arch, microbatches):
    """Prefill in two segments (the second reads the [S, V, Lc, ...] cache
    the first wrote) and 4 decode steps on the V = 2 plan.  At M 2 every
    ring return is consumed as it arrives (``direct``); at M 4 each is
    parked in stage 0's return slot for its next pass (``park``)."""
    cfg, _ = _cfgs(arch)
    pnp, toks, want = _reference(arch)
    plan = ST.plan_stages(cfg)
    pcfg = RT.PipelineConfig(n_microbatches=microbatches)
    lo = SP.lower_to_ring(SP.build_schedule("1f1b-interleaved",
                                            microbatches, 2, 2))
    assert any(lo.park) == (microbatches == 4)
    steps = {q: RT.make_serve_step(cfg, plan, pcfg, q_len=q)
             for q in (P1, 1)}
    params = convert.from_jax(pnp, device="cpu")
    cache = RT.init_pipeline_cache(cfg, plan, B, MAX_LEN, device="cpu")
    got = []
    for lo_, hi in [(0, P1), (P1, P1 + P2)] + [
            (t, t + 1) for t in range(P1 + P2, P1 + P2 + STEPS)]:
        lg, cache = steps[hi - lo_](
            params, cache, dict(tokens=torch.from_numpy(toks[:, lo_:hi])))
        got.append(lg[:, 0].numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    if "kv" in cache:
        assert cache["kv"]["len"].shape == (2, 2, 1, B)
        assert (cache["kv"]["len"] == P1 + P2 + STEPS).all()


@pytest.mark.parametrize("frm,to", [
    ((2, 2), (2, 1)), ((3, 2), (2, 1)), ((4, 2), (4, 1)), ((2, 1), (2, 2)),
    ((2, 2), (4, 2))])
def test_restack_equals_jax(frm, to):
    """``restack_layers`` / ``restack_params`` on numpy leaves equal the
    JAX package's, 5 layers (padded in every plan here), and the in-place
    ``restack_tree_`` on tensors gives the same leaves."""
    jcfg = jax_get_config("llama3.2-1b").reduced(n_layers=5, d_model=64)
    pf, pt = (JST.plan_stages(jcfg, n_stages=s, virtual=v, tensor=1)
              for s, v in (frm, to))
    tf, tt = (ST.plan_stages(jcfg, n_stages=s, virtual=v, tensor=1)
              for s, v in (frm, to))
    rng = np.random.default_rng(0)
    lead = (pf.n_stages, pf.layers_per_stage) if pf.virtual == 1 else (
        pf.n_stages, pf.virtual, pf.layers_per_stage)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    pnp = dict(embed=f32(8, 4), final_norm=f32(4),
               layers=dict(ln1=f32(*lead, 4), attn=dict(wq=f32(*lead, 4, 6)),
                           len=rng.integers(0, 9, lead + (3,)).astype(
                               np.int32)))
    want = jax.tree.map(np.asarray, JST.restack_params(pnp, pf, pt, 5))
    got = ST.restack_params(pnp, tf, tt, 5)
    assert got["layers"]["ln1"].shape == want["layers"]["ln1"].shape
    for g, w in zip(ST.tree_leaves(got), ST.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)
    tree = convert.from_jax(pnp["layers"], device="cpu")
    ST.restack_tree_(tree, tf, tt, 5)
    for g, w in zip(ST.tree_leaves(tree), ST.tree_leaves(want["layers"])):
        np.testing.assert_array_equal(g.numpy(), w)


def test_handoff_drops_each_old_leaf():
    """The handoff re-folds leaf by leaf in place: once it returns, no
    prefill-layout leaf of the parameters or the cache is alive."""
    cfg, _ = _cfgs("llama3.2-1b")
    plan_p, plan = ST.plan_stages(cfg), ST.plan_stages(cfg, virtual=1)
    params = ST.init_stacked_params(cfg, 0, plan_p, device="cpu")
    cache = RT.init_pipeline_cache(cfg, plan_p, B, MAX_LEN, device="cpu")
    old = [weakref.ref(a) for a in ST.tree_leaves(params["layers"])
           + ST.tree_leaves(cache)]
    ref = ST.restack_params(params, plan_p, plan, cfg.n_layers)
    ST.restack_tree_(params["layers"], plan_p, plan, cfg.n_layers)
    ST.restack_tree_(cache, plan_p, plan, cfg.n_layers)
    gc.collect()
    assert all(r() is None for r in old)
    for g, w in zip(ST.tree_leaves(params), ST.tree_leaves(ref)):
        assert torch.equal(g, w)
    assert cache["kv"]["k"].shape[:3] == (2, 2, B)


def test_decode_takes_the_default_ring_whatever_the_prefill_schedule():
    """The serve CLI's decode runs the V = 1 plan under the default ring
    schedule; ``--schedule`` orders the prefill only."""
    base = ["--arch", "llama3.2-1b", "--reduced", "--stages", "2",
            "--microbatches", "2", "--batch", "2", "--prompt-len", "4",
            "--gen", "2", "--device", "cpu"]
    default = SP.lower_to_ring(SP.build_schedule("1f1b", 2, 2))
    for extra, prefill in (
            (["--schedule", "gpipe"], SP.build_schedule("gpipe", 2, 2)),
            (["--virtual", "2", "--schedule", "1f1b-interleaved-memlean"],
             SP.build_schedule("1f1b-interleaved-memlean", 2, 2, 2))):
        out = tserve.main(base + extra)
        assert out["lowerings"]["prefill"] == SP.lower_to_ring(prefill)
        assert out["lowerings"]["decode"] == default
