"""The port's configs, schedule-plan share, layers, model block, stage
stacking and numpy bridge against their JAX counterparts, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
packages.  f32 tolerance 2e-5 for single ops (the same math, summed in
another order by XLA and by PyTorch's CPU kernels), 1e-4 for a whole
block (two matmul chains and an MLP).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import schedplan as JSP
from repro.models import layers as L
from repro.models import model as M
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import schedplan as SP
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.pipeline import stage as ST


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, leaving the other cores to the
    test files that run beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j, tol=2e-5):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _tiny_cfg(qk_norm=False):
    cfg = dataclasses.replace(
        get_config("llama3.2-1b").reduced(n_layers=4, d_model=128),
        n_kv_heads=2, qk_norm=qk_norm)
    jcfg = dataclasses.replace(
        jax_get_config("llama3.2-1b").reduced(n_layers=4, d_model=128),
        n_kv_heads=2, qk_norm=qk_norm)
    return cfg, jcfg


# ---------------------------------------------------------------------------
# configs and schedule plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,reduce", [
    pytest.param("llama3.2-1b", False, id="False"),
    pytest.param("llama3.2-1b", True, id="True"),
    pytest.param("mamba2-2.7b", False, id="mamba2-False"),
    pytest.param("mamba2-2.7b", True, id="mamba2-True")])
def test_config_matches_jax(arch, reduce):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if reduce:
        cfg, jcfg = cfg.reduced(n_layers=3), jcfg.reduced(n_layers=3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim
    assert cfg.padded_vocab(1) == jcfg.padded_vocab(1)
    assert cfg.padded_vocab(3) == jcfg.padded_vocab(3)
    assert [cfg.is_global_layer(i) for i in range(cfg.n_layers)] == \
        [jcfg.is_global_layer(i) for i in range(jcfg.n_layers)]
    if cfg.ssm is not None:
        assert cfg.ssm.n_heads(cfg.d_model) == jcfg.ssm.n_heads(jcfg.d_model)
    with pytest.raises(KeyError):
        get_config("hymba-1.5b")


@pytest.mark.parametrize("name", ["gpipe", "1f1b", "1f1b-2x", "1F1B-AS",
                                  "FBP-AS"])
@pytest.mark.parametrize("M_,N", [(1, 1), (2, 8), (4, 2), (3, 5)])
def test_ring_lowering_matches_jax(name, M_, N):
    mine = SP.lower_to_ring(SP.build_schedule(name, M_, N))
    ref = JSP.lower_to_ring(JSP.build_schedule(name, M_, N))
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.n_ticks == ref.n_ticks
    plan, jplan = SP.build_schedule(name, M_, N), JSP.build_schedule(name, M_, N)
    assert [[dataclasses.astuple(o) for o in ops] for ops in plan.device_ops] \
        == [[dataclasses.astuple(o) for o in ops] for ops in jplan.device_ops]


def test_schedule_names_match_jax():
    for name in JSP._ALIASES:
        assert SP.canonical_name(name) == JSP.canonical_name(name)
    for V in (1, 2):
        assert SP.resolve_ring_schedule("auto", V) == \
            JSP.resolve_ring_schedule("auto", V)
    assert [[dataclasses.astuple(o) for o in ops]
            for ops in SP.build_schedule("zb-h2", 2, 2).device_ops] == \
        [[dataclasses.astuple(o) for o in ops]
         for ops in JSP.build_schedule("zb-h2", 2, 2).device_ops]
    with pytest.raises(ValueError):
        SP.canonical_name("nope")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, s = _rand(rng, (2, 5, 48)), _rand(rng, (48,), 0.1)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           L.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))
    assert TL.init_rms_norm(7, torch.float32, "cpu").eq(0).all()


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 6, 3, 32))
    pos = rng.integers(0, 600, (2, 6)).astype(np.int32)
    _close(TL.rope_freqs(32, theta), L.rope_freqs(32, theta))
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           L.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-4)


@pytest.mark.parametrize("idx", [3, [0, 5, 10], [1, 12, 2]])
def test_cache_write_matches_jax(idx):
    """Scalar and per-row offsets; offset 12 + T=4 > S=14 is clamped the
    way lax.dynamic_update_slice clamps it."""
    rng = np.random.default_rng(2)
    buf = _rand(rng, (3, 14, 2, 8))
    new = _rand(rng, (3, 4, 2, 8))
    tb = torch.from_numpy(buf.copy())
    got = TL._cache_write(tb, torch.from_numpy(new),
                          torch.tensor(idx, dtype=torch.int32))
    want = L._cache_write(jnp.asarray(buf), jnp.asarray(new),
                          jnp.asarray(idx, jnp.int32))
    assert got.data_ptr() == tb.data_ptr()      # written in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gqa_params(rng, cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = dict(wq=_rand(rng, (d, cfg.n_heads * hd), d ** -0.5),
             wk=_rand(rng, (d, cfg.n_kv_heads * hd), d ** -0.5),
             wv=_rand(rng, (d, cfg.n_kv_heads * hd), d ** -0.5),
             wo=_rand(rng, (cfg.n_heads * hd, d), d ** -0.5))
    if cfg.qk_norm:
        p["q_norm"] = _rand(rng, (hd,), 0.1)
        p["k_norm"] = _rand(rng, (hd,), 0.1)
    return p


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_gqa_attention_matches_jax(qk_norm, cached):
    cfg, jcfg = _tiny_cfg(qk_norm)
    rng = np.random.default_rng(3)
    p = _gqa_params(rng, cfg)
    B, T, S = 2, 5, 12
    x = _rand(rng, (B, T, cfg.d_model))
    length = np.array([0, 4], np.int32)
    pos = (length[:, None] + np.arange(T)[None]).astype(np.int32)
    tp = convert.from_jax(p)
    jc = tc = None
    if cached:
        hd = cfg.resolved_head_dim
        ck, cv = (_rand(rng, (B, S, cfg.n_kv_heads, hd)) for _ in range(2))
        jc = dict(k=jnp.asarray(ck), v=jnp.asarray(cv),
                  len=jnp.asarray(length))
        tc = dict(k=torch.from_numpy(ck.copy()), v=torch.from_numpy(cv.copy()),
                  len=torch.from_numpy(length))
    want, jnew = L.gqa_attention(p, jnp.asarray(x), jcfg, pos=jnp.asarray(pos),
                                 is_global=True, rope_theta=jcfg.rope_theta,
                                 cache=jc)
    got, tnew = TL.gqa_attention(tp, torch.from_numpy(x), cfg,
                                 pos=torch.from_numpy(pos),
                                 rope_theta=cfg.rope_theta, cache=tc)
    _close(got, want, 1e-4)
    if cached:
        for key in ("k", "v"):
            _close(tnew[key], jnew[key], 1e-5)
        np.testing.assert_array_equal(tnew["len"].numpy(),
                                      np.asarray(jnew["len"]))


def test_block_apply_and_decode_step_match_jax():
    """One dense block (norms, attention, MLP) and a two-step cached
    decode of the whole tiny model, with weights carried over by
    repro_torch.convert."""
    cfg, jcfg = _tiny_cfg()
    init = jax.jit(lambda k: M.init_params(jcfg, k))
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    tp = convert.from_jax(jp)
    rng = np.random.default_rng(4)
    B, T = 2, 6
    x = _rand(rng, (B, T, cfg.d_model))
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    jmeta = jax.tree.map(lambda a: a[1], M.layer_meta(jcfg))
    want, _, _ = jax.jit(lambda p, x_, m, ps: M.block_apply(
        jcfg, p, x_, m, pos=ps))(jl, jnp.asarray(x), jmeta, jnp.asarray(pos))
    tmeta = {k: v[1] for k, v in TM.layer_meta(cfg).items()}
    got, _, aux = TM.block_apply(cfg, TM.layer_slice(tp["layers"], 1),
                                 torch.from_numpy(x), tmeta,
                                 pos=torch.from_numpy(pos))
    _close(got, want, 1e-4)
    assert float(aux) == 0.0

    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    jcache = M.init_cache(jcfg, B, max_len=T + 2)
    tcache = TM.init_cache(cfg, B, T + 2, device="cpu")
    jstep = jax.jit(lambda p, b, c: M.decode_step(jcfg, p, b, c))
    for chunk in (toks[:, :4], toks[:, 4:5]):
        want, jcache = jstep(jp, dict(tokens=jnp.asarray(chunk)), jcache)
        got, tcache = TM.decode_step(cfg, tp, dict(tokens=torch.from_numpy(chunk)),
                                     tcache)
        _close(got, want, 2e-4)
    np.testing.assert_array_equal(tcache["kv"]["len"].numpy(),
                                  np.asarray(jcache["kv"]["len"]))


def test_port_init_params_decode_matches_jax():
    """Weights made by the port (torch.Generator) and handed to the JAX
    package through convert.to_jax: the same cached decode."""
    cfg, jcfg = _tiny_cfg()
    tp = TM.init_params(cfg, 3, device="cpu")
    jp = jax.tree.map(jnp.asarray, convert.to_jax(tp))
    assert jp["layers"]["attn"]["wq"].shape == (4, 128, 128)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 5))
    toks = toks.astype(np.int32)
    jcache = M.init_cache(jcfg, 2, max_len=5)
    tcache = TM.init_cache(cfg, 2, 5, device="cpu")
    want, _ = jax.jit(lambda p, b, c: M.decode_step(jcfg, p, b, c))(
        jp, dict(tokens=jnp.asarray(toks)), jcache)
    got, _ = TM.decode_step(cfg, tp, dict(tokens=torch.from_numpy(toks)),
                            tcache)
    _close(got, want, 2e-4)


def test_mlp_matches_jax():
    rng = np.random.default_rng(5)
    p = dict(w1=_rand(rng, (16, 40), 0.25), w3=_rand(rng, (16, 40), 0.25),
             w2=_rand(rng, (40, 16), 0.15))
    x = _rand(rng, (2, 3, 16))
    for act in ("silu", "gelu"):
        _close(TL.mlp(convert.from_jax(p), torch.from_numpy(x), act),
               L.mlp(p, jnp.asarray(x), act), 1e-5)


# ---------------------------------------------------------------------------
# stage stacking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stages", [1, 2, 3])
def test_stacking_matches_jax(stages):
    """[S, Lps] stacking, its inverse and the per-slot metadata (3 stages
    pad 4 layers to 6: two inactive slots); at V = 2 the [S][V][Lc]
    ``active`` mask (tests/test_torch_schedules.py holds the rest)."""
    cfg, jcfg = _tiny_cfg()
    plan = ST.plan_stages(cfg, n_stages=stages)
    jplan = JST.plan_stages(jcfg, n_stages=stages)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    a = np.arange(plan.n_layers_padded * 6, dtype=np.float32).reshape(-1, 2, 3)
    st = ST._stack_chunks(torch.from_numpy(a), plan)
    np.testing.assert_array_equal(st.numpy(),
                                  np.asarray(JST._stack_chunks(a, jplan)))
    np.testing.assert_array_equal(ST.unstack_chunks(st, plan).numpy(), a)
    jm = jax.tree.map(np.asarray, JST.stacked_meta(jcfg, jplan))
    tm = ST.stacked_meta(cfg, plan)
    for key in ("active", "rope_theta", "is_global"):
        np.testing.assert_array_equal(
            np.array([[ml[key] for ml in row] for row in tm]), jm[key])
    iplan = ST.plan_stages(cfg, n_stages=stages, virtual=2)
    jm = jax.tree.map(np.asarray, JST.stacked_meta(
        jcfg, JST.plan_stages(jcfg, n_stages=stages, virtual=2)))
    np.testing.assert_array_equal(
        np.array([[[ml["active"] for ml in chunk] for chunk in row]
                  for row in ST.stacked_meta(cfg, iplan)]), jm["active"])


def test_init_stacked_params_shapes_match_jax():
    cfg, jcfg = _tiny_cfg()
    cfg = dataclasses.replace(cfg, vocab=1000)
    jcfg = dataclasses.replace(jcfg, vocab=1000)
    plan = ST.plan_stages(cfg, n_stages=3)
    jp = jax.eval_shape(lambda k: JST.init_stacked_params(
        jcfg, k, JST.plan_stages(jcfg, n_stages=3)), jax.random.PRNGKey(0))
    tp = ST.init_stacked_params(cfg, 0, plan, device="cpu")
    shapes = lambda tree: {k: shapes(v) if isinstance(v, dict)
                           else tuple(v.shape) for k, v in tree.items()}
    assert shapes(tp) == shapes(jp)
    assert tp["embed"].shape[0] == 1024           # padded to 128
    again = ST.init_stacked_params(cfg, 0, plan, device="cpu")
    assert torch.equal(tp["layers"]["attn"]["wq"], again["layers"]["attn"]["wq"])


# ---------------------------------------------------------------------------
# numpy bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip(dtype):
    cfg, jcfg = _tiny_cfg()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jplan = JST.plan_stages(jcfg, n_stages=2)
    init = jax.jit(lambda k: JST.init_stacked_params(jcfg, k, jplan,
                                                     dtype=jdt))
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1)))
    tp = convert.from_jax(jp)
    assert tp["layers"]["attn"]["wq"].dtype == getattr(torch, dtype)
    back = convert.to_jax(tp)
    flat = lambda t: jax.tree_util.tree_leaves_with_path(t)
    for (pa, a), (pb, b) in zip(flat(jp), flat(back)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    if dtype == "bfloat16":
        assert back["embed"].dtype == ml_dtypes.bfloat16
