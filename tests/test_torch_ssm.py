"""The port's Mamba-2 slice against the JAX package, on the CPU: the SSD
scan's plain versions, the SSM block, the model, the pipelined serve step
and the numpy bridge.

On the CPU the port's SSD wrappers take their plain versions (the CUDA
kernel runs only on the card: see tests/test_torch_cuda.py and
chip_smoke.py).  Inputs are made with numpy from a seed and handed to both
packages; weights are made by the JAX package and carried over by
``repro_torch.convert``.  Tolerances:

* the SSD scan: the JAX kernel tests' own measure and bounds,
  max |y - y_ref| / max |y_ref| below 2e-5 (f32) or 3e-2 (bf16);
* an SSM block: 1e-4 (three matmuls, a gated norm and the scan, summed in
  another order by XLA and by PyTorch);
* logits of the reduced model through prefill and 4 decode steps: 2e-4,
  as the dense slice (the error grows through 4 layers and the head).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ref import ssd_scan_ref as jax_ssd_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.launch.mesh import make_mesh
from repro.models import layers as L
from repro.models import model as M
from repro.pipeline import runtime as JRT
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BLOCK_TOL, PATH_TOL = 1e-4, 2e-4
B, PROMPT, GEN = 4, 32, 4          # prompt 32 = two chunks of 16 (reduced)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, leaving the other cores to the
    test files that run beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ssd_inputs(seed, B_, T, H, P, N):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, dt, a, Bm, Cm = f(B_, T, H, P), f(B_, T, H), f(H), f(B_, T, N), \
        f(B_, T, N)
    return x, np.log1p(np.exp(dt)), -np.exp(a * 0.5), Bm, Cm


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _cfgs(stages=1, n_layers=4):
    kw = dict(n_layers=n_layers, d_model=128)
    base = dict(stages=stages, tensor=1)
    return (dataclasses.replace(get_config("mamba2-2.7b").reduced(**kw),
                                **base),
            dataclasses.replace(jax_get_config("mamba2-2.7b").reduced(**kw),
                                **base))


# ---------------------------------------------------------------------------
# the SSD scan's plain versions
# ---------------------------------------------------------------------------

# the shapes of tests/test_kernels.py::test_ssd_scan_matches_sequential_ref
SSD_SHAPES = [(2, 64, 8, 32, 16, 16), (1, 128, 4, 64, 32, 32),
              (2, 256, 8, 32, 128, 64), (2, 32, 6, 16, 8, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B_,T,H,P,N,chunk", SSD_SHAPES)
def test_ssd_plain_versions_match_jax(B_, T, H, P, N, chunk, dtype):
    """``ssd_scan`` (the chunked plain version on a CPU tensor) against the
    Pallas kernel in interpret mode, and the sequential ``ssd_scan_ref``
    against its JAX twin; dt in the input dtype, as the JAX tests give it."""
    x, dt, A, Bm, Cm = _ssd_inputs(T + H + N, B_, T, H, P, N)
    jin = [jnp.asarray(a, JDT[dtype]) for a in (x, dt)] + [jnp.asarray(A)] \
        + [jnp.asarray(a, JDT[dtype]) for a in (Bm, Cm)]
    tin = [torch.from_numpy(a).to(TDT[dtype]) for a in (x, dt)] \
        + [torch.from_numpy(A)] \
        + [torch.from_numpy(a).to(TDT[dtype]) for a in (Bm, Cm)]
    want = jax_ssd_scan(*jin, chunk=chunk, interpret=True)
    got = SSD.ssd_scan(*tin, chunk=chunk)
    assert got.dtype == TDT[dtype] and got.shape == (B_, T, H, P)
    assert _rel_err(got, want) < TOL[dtype]
    want, _ = jax_ssd_ref(*jin)
    got, fin = SSD.ssd_scan_ref(*tin)
    assert fin.dtype == torch.float32 and fin.shape == (B_, H, P, N)
    assert _rel_err(got, want) < TOL[dtype]


def test_ssd_chunked_with_init_state_matches_jax():
    """A nonzero initial state: ``ssd_chunked`` against the model's
    ``L._ssd_chunked`` and the sequential recurrences, y and final state."""
    B_, T, H, P, N, chunk = 2, 48, 4, 16, 8, 16
    x, dt, A, Bm, Cm = _ssd_inputs(5, B_, T, H, P, N)
    s0 = np.random.default_rng(6).standard_normal((B_, H, P, N))
    s0 = s0.astype(np.float32)
    tin = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    jin = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    s0_t = torch.from_numpy(s0.copy())
    y, fin = SSD.ssd_chunked(*tin, chunk=chunk, init_state=s0_t)
    # the final state is a new tensor: the caller copies it into the
    # cache, whose rows may be the initial state
    assert fin.data_ptr() != s0_t.data_ptr()
    np.testing.assert_array_equal(s0_t.numpy(), s0)
    jy, jfin = L._ssd_chunked(*jin, chunk, init_state=jnp.asarray(s0))
    assert _rel_err(y, jy) < TOL["float32"]
    assert _rel_err(fin, jfin) < TOL["float32"]
    ry, rfin = SSD.ssd_scan_ref(*tin, init_state=torch.from_numpy(s0))
    jry, jrfin = jax_ssd_ref(*jin, init_state=jnp.asarray(s0))
    assert _rel_err(ry, jry) < TOL["float32"]
    assert _rel_err(rfin, jrfin) < TOL["float32"]
    assert _rel_err(y, ry.numpy()) < TOL["float32"]


def test_ssd_rejects_partial_chunk():
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _ssd_inputs(7, 1, 24, 2, 16, 8))
    with pytest.raises(ValueError, match="multiple"):
        SSD.ssd_chunked(x, dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="init_state"):
        SSD.ssd_chunked(x, dt, A, Bm, Cm, chunk=8,
                        init_state=torch.zeros(1, 2, 16, 4))


# ---------------------------------------------------------------------------
# the SSM block and the model
# ---------------------------------------------------------------------------

def _block_params(jcfg):
    jp = L.init_ssm(jax.random.PRNGKey(2), jcfg, 1, jnp.float32)
    jp = jax.tree.map(np.asarray, jp)
    # nonzero biases and norm scale so every term is exercised
    rng = np.random.default_rng(3)
    for name in ("conv_b", "dt_bias", "gate_norm"):
        jp[name] = (rng.standard_normal(jp[name].shape) * 0.1).astype(
            np.float32)
    return jp


@pytest.mark.parametrize("branch", ["no_cache", "cached_prefill", "decode"])
def test_ssm_block_matches_jax(branch):
    """``ssm_block``'s three branches against ``L.ssm_block``: output, and
    the conv window and state written into the cache in place."""
    cfg, jcfg = _cfgs()
    s = cfg.ssm
    jp = _block_params(jcfg)
    tp = convert.from_jax(jp)
    rng = np.random.default_rng(4)
    Bsz, T = 2, (1 if branch == "decode" else 32)
    x = rng.standard_normal((Bsz, T, cfg.d_model)).astype(np.float32)
    jc = tc = None
    if branch != "no_cache":
        nh, conv_ch = s.n_heads(cfg.d_model), 2 * cfg.d_model + 2 * s.d_state
        conv = rng.standard_normal((Bsz, s.d_conv - 1, conv_ch))
        state = rng.standard_normal((Bsz, nh, s.head_dim, s.d_state))
        conv, state = conv.astype(np.float32), state.astype(np.float32)
        jc = dict(conv=jnp.asarray(conv), state=jnp.asarray(state))
        tc = dict(conv=torch.from_numpy(conv.copy()),
                  state=torch.from_numpy(state.copy()))
        ptrs = (tc["conv"].data_ptr(), tc["state"].data_ptr())
    want, jnew = L.ssm_block(jp, jnp.asarray(x), jcfg, cache=jc)
    got, tnew = TL.ssm_block(tp, torch.from_numpy(x), cfg, cache=tc)
    assert _rel_err(got, want) < BLOCK_TOL
    if branch == "no_cache":
        assert tnew is None
        return
    assert (tnew["conv"].data_ptr(), tnew["state"].data_ptr()) == ptrs
    np.testing.assert_allclose(tnew["conv"].numpy(), np.asarray(jnew["conv"]),
                               atol=BLOCK_TOL, rtol=BLOCK_TOL)
    assert _rel_err(tnew["state"], jnew["state"]) < BLOCK_TOL


def test_decode_step_matches_jax(ref):
    """The reduced model, weights from the JAX package: one block, then a
    cached prefill of 32 tokens (two chunks of 16) and 4 decode steps
    against the JAX M.decode_step."""
    cfg, jcfg = ref["cfg"], ref["jcfg"]
    jp = dict(ref["pnp"], layers=ref["flat"])
    tp = convert.from_jax(jp)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, PROMPT, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(PROMPT), (B, PROMPT)).astype(np.int32)
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    jmeta = jax.tree.map(lambda a: a[1], M.layer_meta(jcfg))
    want, _, _ = jax.jit(lambda p, x_, m, ps: M.block_apply(
        jcfg, p, x_, m, pos=ps))(jl, jnp.asarray(x), jmeta, jnp.asarray(pos))
    tmeta = {k: v[1] for k, v in TM.layer_meta(cfg).items()}
    got, _, aux = TM.block_apply(cfg, TM.layer_slice(tp["layers"], 1),
                                 torch.from_numpy(x), tmeta,
                                 pos=torch.from_numpy(pos))
    assert _rel_err(got, want) < BLOCK_TOL and aux == 0.0

    cache = TM.init_cache(cfg, B, PROMPT + GEN, device="cpu")
    assert set(cache) == {"ssm"} and TM._cache_len(cache) == 0
    toks = [ref["prompt"]] + [ref["forced"][:, t:t + 1] for t in range(GEN)]
    for tok, want in zip(toks, ref["logits"]):
        got, cache = TM.decode_step(cfg, tp,
                                    dict(tokens=torch.from_numpy(tok)), cache)
        np.testing.assert_allclose(got.numpy(), want, atol=PATH_TOL,
                                   rtol=PATH_TOL)
    assert _rel_err(cache["ssm"]["state"], ref["state"]) < BLOCK_TOL


@pytest.mark.parametrize("family", ["moe", "mla", "hybrid", "audio", "vlm"])
def test_unported_families_raise(family):
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              family=family,
                              attn_kind="mla" if family == "mla" else "gqa")
    with pytest.raises(NotImplementedError):
        TM.check_ported(cfg)
    with pytest.raises(NotImplementedError):
        TM.init_cache(cfg, 1, 4, device="cpu")


# ---------------------------------------------------------------------------
# the pipelined serve step
# ---------------------------------------------------------------------------

def _port_serve(cfg, params_np, prompt, forced):
    """Prefill, then GEN teacher-forced decode steps through the port's
    pipelined serve step; the logits of every step, and the cache."""
    plan = ST.plan_stages(cfg)
    pcfg = RT.PipelineConfig(n_microbatches=2)
    prefill = RT.make_serve_step(cfg, plan, pcfg, q_len=PROMPT)
    decode = RT.make_serve_step(cfg, plan, pcfg, q_len=1)
    params = convert.from_jax(params_np)
    cache = RT.init_pipeline_cache(cfg, plan, B, PROMPT + GEN, device="cpu")
    lg, cache = prefill(params, cache, dict(tokens=torch.from_numpy(prompt)))
    out = [lg[:, 0]]
    for t in range(GEN):
        lg, cache = decode(params, cache,
                           dict(tokens=torch.from_numpy(forced[:, t:t + 1])))
        out.append(lg[:, 0])
    assert lg.shape == (B, 1, cfg.padded_vocab(1)) and lg.dtype == torch.float32
    return [o.numpy() for o in out], cache


@pytest.fixture(scope="module")
def ref():
    """The reduced model's weights, made by the JAX package at stages = 1,
    numpy-made prompt and teacher-forced tokens, and the JAX single-device
    M.decode_step logits of the prefill (every position) and of 4 decode
    steps, with the final SSM state."""
    cfg, jcfg = _cfgs(stages=1)
    jplan = JST.plan_stages(jcfg)
    pnp = jax.tree.map(np.asarray, jax.jit(lambda k: JST.init_stacked_params(
        jcfg, k, jplan))(jax.random.PRNGKey(0)))
    flat = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]),
                        pnp["layers"])                      # [L, ...]
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, (B, GEN)).astype(np.int32)
    step = jax.jit(lambda p, b, c: M.decode_step(jcfg, p, b, c))
    cache = M.init_cache(jcfg, B, max_len=PROMPT + GEN)
    logits = []
    for tok in [prompt] + [forced[:, t:t + 1] for t in range(GEN)]:
        lg, cache = step(dict(pnp, layers=flat),
                         dict(tokens=jnp.asarray(tok)), cache)
        logits.append(np.asarray(lg))
    return dict(cfg=cfg, jcfg=jcfg, jplan=jplan, pnp=pnp, flat=flat,
                prompt=prompt, forced=forced, logits=logits,
                state=np.asarray(cache["ssm"]["state"]))


@pytest.mark.parametrize("stages", [2, 3])
def test_pipelined_serve_matches_jax_decode_step(ref, stages):
    """Port at stages = 2, and at stages = 3 (4 layers padded to 6: the
    two inactive slots keep their zero conv window and state), against the
    JAX single-device M.decode_step: prefill + 4 decode steps."""
    cfg = dataclasses.replace(ref["cfg"], stages=stages)
    plan = ST.plan_stages(cfg)
    pad = plan.n_layers_padded - cfg.n_layers
    layers = jax.tree.map(lambda a: ST._stack_chunks(np.concatenate(
        [a, np.repeat(a[-1:], pad, axis=0)]), plan), ref["flat"])
    got, cache = _port_serve(cfg, dict(ref["pnp"], layers=layers),
                             ref["prompt"], ref["forced"])
    want = [ref["logits"][0][:, -1]] + [w[:, 0] for w in ref["logits"][1:]]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=PATH_TOL, rtol=PATH_TOL)
    assert set(cache) == {"ssm"}
    active = torch.tensor([[ml["active"] for ml in row]
                           for row in ST.stacked_meta(cfg, plan)])
    assert (~active).sum() == pad == (2 if stages == 3 else 0)
    for leaf in cache["ssm"].values():
        assert (leaf[~active] == 0).all()
        assert (leaf[active] != 0).any(dim=-1).all()


def test_serve_step_matches_jax_serve_step(ref):
    """Port at stages = 1 vs JAX RT.make_serve_step on a 1x1x1 mesh."""
    jcfg, jplan, pnp = ref["jcfg"], ref["jplan"], ref["pnp"]
    prompt, forced = ref["prompt"], ref["forced"]
    got, _ = _port_serve(ref["cfg"], pnp, prompt, forced)

    mesh = make_mesh((1, 1, 1), ("data", "stage", "tensor"))
    pcfg = JRT.PipelineConfig(n_microbatches=2)
    kw = dict(max_len=PROMPT + GEN, global_batch=B)
    prefill, _, _, _ = JRT.make_serve_step(jcfg, mesh, jplan, pcfg,
                                           q_len=PROMPT, **kw)
    decode, _, _, _ = JRT.make_serve_step(jcfg, mesh, jplan, pcfg, **kw)
    params = jax.tree.map(jnp.asarray, pnp)
    cache = JRT.init_pipeline_cache(jcfg, jplan, B, PROMPT + GEN)
    lg, cache = prefill(params, cache, dict(tokens=jnp.asarray(prompt)))
    want = [np.asarray(lg[:, 0])]
    for t in range(GEN):
        lg, cache = decode(params, cache,
                           dict(tokens=jnp.asarray(forced[:, t:t + 1])))
        want.append(np.asarray(lg[:, 0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=PATH_TOL, rtol=PATH_TOL)


def test_serve_refuses_partial_chunk_and_n_valid():
    """A prompt that is not a chunk multiple raises ValueError (the JAX
    reshape fails too); ``n_valid`` is refused with the SSM reason."""
    cfg, _ = _cfgs(stages=2, n_layers=2)
    plan = ST.plan_stages(cfg)
    pcfg = RT.PipelineConfig(n_microbatches=2)
    params = ST.init_stacked_params(cfg, 0, plan, device="cpu")
    cache = RT.init_pipeline_cache(cfg, plan, 2, 32, device="cpu")
    step = RT.make_serve_step(cfg, plan, pcfg, q_len=24)
    with pytest.raises(ValueError, match="multiple"):
        step(params, cache, dict(tokens=torch.zeros(2, 24, dtype=torch.long)))
    with pytest.raises(ValueError, match="n_valid"):
        step(params, cache, dict(tokens=torch.zeros(2, 24, dtype=torch.long),
                                 n_valid=torch.ones(2, dtype=torch.int32)))


def test_serve_cli_leaves_kernel_count():
    """The CLI on the CPU: tokens of the right shape, and the SSD
    wrapper's kernel counter untouched (a CPU tensor takes the plain
    version, never the kernel)."""
    before = SSD.ssd_chunked.launches
    out = tserve.main(["--arch", "mamba2-2.7b", "--reduced", "--stages", "2",
                       "--batch", "4", "--prompt-len", "32", "--gen", "3",
                       "--device", "cpu"])
    assert out["tokens"].shape == (4, 3)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 1024)).all()
    assert torch.isfinite(out["last_logits"]).all()
    assert SSD.ssd_chunked.launches == before


# ---------------------------------------------------------------------------
# numpy bridge
# ---------------------------------------------------------------------------

def test_convert_round_trip_bf16_keeps_f32_leaves():
    """A bf16 mamba2 tree: the matrices come over as bf16, ``a_log``,
    ``d_skip`` and ``dt_bias`` stay f32, and the round trip is bit-exact;
    the port's own init keeps the same dtypes."""
    cfg, jcfg = _cfgs(stages=2, n_layers=2)
    jplan = JST.plan_stages(jcfg)
    jp = jax.tree.map(np.asarray, jax.jit(lambda k: JST.init_stacked_params(
        jcfg, k, jplan, dtype=jnp.bfloat16))(jax.random.PRNGKey(1)))
    tp = convert.from_jax(jp)
    ssm = tp["layers"]["ssm"]
    assert ssm["in_proj"].dtype == torch.bfloat16
    for name in ("a_log", "d_skip", "dt_bias"):
        assert ssm[name].dtype == torch.float32
    back = convert.to_jax(tp)
    flat = jax.tree_util.tree_leaves_with_path
    for (pa, a), (pb, b) in zip(flat(jp), flat(back)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert back["layers"]["ssm"]["conv_w"].dtype == ml_dtypes.bfloat16
    mine = ST.init_stacked_params(cfg, 0, ST.plan_stages(cfg),
                                  dtype=torch.bfloat16, device="cpu")
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict)
                        else (tuple(v.shape), str(v.dtype).split(".")[-1])
                        for k, v in t.items()}
    assert shapes(mine) == shapes(tp)
