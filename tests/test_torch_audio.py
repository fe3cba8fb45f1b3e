"""The audio family in the port (whisper-base: an encoder-decoder whose
blocks carry ``{h_enc, h_dec}``, the decoder cross-attending the
encoder's output, sinusoidal positions) against the JAX package, on the
CPU.

whisper-base reduced to d 128 and 6 layers, 3 encoder and 3 decoder
(``tests/_torch_audio_worker.py``'s :func:`config`: 4/4 heads of 32),
its weights drawn once (the port's generator, seed 0) and handed to both
packages as numpy (``repro_torch.convert``); training batches of 12 rows
of 16 tokens beside 12 seeded frames a row.  Held to the JAX model on
the same inputs:

* the trees and the config, leaf for leaf;
* an encoder and a decoder block without a cache, and the decoder block
  with one (a prefill, then one-token steps): within 2e-4; the forward's
  logits, the loss and its gradients within 2e-4;
* ``prefill_audio_cache`` and ``decode_step`` against JAX's (2e-4) and
  against the port's own full forward (5e-5, as
  ``tests/test_decode.py``), and attention over no encoder key
  (``enc_len`` 0) against JAX's decode (zeros, no launch);
* the pipelined serve at 2 and 3 stages, V 1 and V 2, its cross cache
  laid by ``runtime.lay_cross_cache``: every step's logits within 2e-4
  of the JAX serve step (a 1x1x1 mesh: this process has one JAX device)
  with its cache filled by ``prefill_audio_cache`` and stacked by
  ``stage._stack_chunks``, and of JAX's ``decode_step``;
* one train step under every builder of ``BUILDER_NAMES``, ticks and
  stream, at 2 and 3 stages (3 stages of 2 layers: enc,enc | enc,dec |
  dec,dec), and under ``remat='full'``: the harness's bar (loss 1e-4,
  layer gradients 1e-4 relative; ``tests/harness_pipe.py:96-109``);
* on one world of 4 gloo ranks, spawned once while this process
  computes the references: 2 ranks bit for bit the in-process step and
  serve; data 2 x stages 2 and stages 2 x tensor 2 at the harness's bar;
  the data-2 and tensor-2 serves against the JAX logits; the train CLI
  at data 2 against the in-process CLI;
* checkpoints crossing both ways bit for bit, a reshard byte-equal to
  the JAX package's, the planner's plans the JAX package's, both CLIs
  (the serve CLI refuses whisper, as the JAX one fails on it).
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JC
from repro.configs import get_config as jax_get_config
from repro.core import autoplan as JA
from repro.core import hardware as JH
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.pipeline import runtime as JRT
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.checkpoint import (layout_dict, reshard_checkpoint,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core import autoplan as TA
from repro_torch.core import hardware as TH
from repro_torch.core.schedplan import BUILDER_NAMES
from repro_torch.kernels.flash_attention import flash_attend
from repro_torch.launch import mesh as MESH
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

import _torch_audio_worker as W

TOL = 2e-4              # block, forward, loss, logits
DECODE_TOL = 5e-5       # decode against the full forward (test_decode.py)
JH100 = JH.DeviceSpec(**dataclasses.asdict(TH.H100))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _jcfg(S: int = 1, V: int = 1):
    return dataclasses.replace(
        jax_get_config("whisper-base").reduced(n_layers=W.L,
                                               d_model=W.D_MODEL),
        stages=S, tensor=1, virtual=V)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The in-process steps on one torch thread, as the ranks run: their
    results are compared bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights() -> dict:
    """Numpy weights of the reduced model, layers unstaged [L, ...]."""
    cfg = W.config()
    p = convert.to_jax(ST.init_stacked_params(cfg, 0, ST.plan_stages(cfg),
                                              device="cpu"))
    return dict(p, layers=jax.tree.map(lambda a: a[0], p["layers"]))


@pytest.fixture(scope="module")
def serve_frames() -> np.ndarray:
    return W.frames(W.SB, seed=7)


@pytest.fixture(scope="module")
def cross(weights, serve_frames) -> dict:
    """The port's ``prefill_audio_cache`` of the serve frames: xk/xv
    [L, SB, SF, H, D] as numpy (what every serve case lays)."""
    cfg = W.config()
    c = TM.prefill_audio_cache(
        cfg, convert.from_jax(weights, device="cpu"),
        torch.from_numpy(serve_frames),
        TM.init_cache(cfg, W.SB, 1, enc_len=W.SF, device="cpu"))
    return {k: c[k].numpy() for k in ("xk", "xv")}


def _jax_decode(weights, frames_np, toks, enc_len=None) -> list:
    """JAX's ``prefill_audio_cache`` and ``decode_step`` over the prompt,
    then each forced token: every step's last logits (vocab columns)."""
    jcfg, jw = _jcfg(), jax.tree.map(jnp.asarray, weights)
    n = toks.shape[1]
    if enc_len == 0:
        cache = JM.init_cache(jcfg, toks.shape[0], n)
    else:
        cache = JM.prefill_audio_cache(jcfg, jw, jnp.asarray(frames_np),
                                       JM.init_cache(jcfg, toks.shape[0], n,
                                                     enc_len=W.SF))
    feeds = [toks[:, :W.PROMPT]] + [toks[:, t:t + 1]
                                    for t in range(W.PROMPT, n)]
    step = jax.jit(lambda f, c: JM.decode_step(jcfg, jw, dict(tokens=f), c))
    out = []
    for f in feeds:
        lg, cache = step(jnp.asarray(f), cache)
        out.append(np.asarray(lg[:, -1]))
    return out


def _jax_serve_step(weights, serve_frames, toks) -> list:
    """The JAX pipelined serve step on a 1x1x1 mesh (stages 1, M 2), its
    cache's xk/xv filled by ``prefill_audio_cache`` and stacked by
    ``_stack_chunks``: every step's logits."""
    jcfg, jw = _jcfg(), jax.tree.map(jnp.asarray, weights)
    plan = JST.plan_stages(jcfg)
    mesh = make_mesh((1, 1, 1), ("data", "stage", "tensor"))
    pcfg = JRT.PipelineConfig(n_microbatches=2)
    kw = dict(max_len=W.PROMPT + W.GEN, global_batch=W.SB)
    prefill, _, _, _ = JRT.make_serve_step(jcfg, mesh, plan, pcfg,
                                           q_len=W.PROMPT, **kw)
    decode, _, _, _ = JRT.make_serve_step(jcfg, mesh, plan, pcfg, **kw)
    params = dict(jw, layers=jax.tree.map(
        lambda a: JST._stack_chunks(a, plan), jw["layers"]))
    filled = JM.prefill_audio_cache(jcfg, jw, jnp.asarray(serve_frames),
                                    JM.init_cache(jcfg, W.SB, 1,
                                                  enc_len=W.SF))
    cache = dict(JRT.init_pipeline_cache(jcfg, plan, W.SB,
                                         W.PROMPT + W.GEN, enc_len=W.SF),
                 **{k: JST._stack_chunks(filled[k], plan)
                    for k in ("xk", "xv")})
    lg, cache = prefill(params, cache,
                        dict(tokens=jnp.asarray(toks[:, :W.PROMPT])))
    out = [np.asarray(lg[:, 0])]
    for t in range(W.PROMPT, W.PROMPT + W.GEN):
        lg, cache = decode(params, cache,
                           dict(tokens=jnp.asarray(toks[:, t:t + 1])))
        out.append(np.asarray(lg[:, 0]))
    return out


def _jax_grads(weights: dict) -> dict:
    """The JAX loss and gradients on the training batch."""
    b = W.batch(W.config())
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    vg = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(_jcfg(), p, jb)))
    loss, grads = vg(jax.tree.map(jnp.asarray, weights))
    return dict(loss=float(loss), grads=jax.tree.map(np.asarray, grads))


#: the in-process train steps: (builder, runtime, stages, remat)
TRAIN_CASES = [(b, r, S, "stage") for S in (2, 3) for b in BUILDER_NAMES
               for r in ("ticks", "stream")] + [
    ("1f1b", "ticks", 2, "full"), ("zb-h1", "stream", 3, "full")]


def _case_id(c) -> str:
    b, r, S, remat = c
    return f"S{S} {b} {r}" + (" remat=full" if remat == "full" else "")


@pytest.fixture(scope="module")
def runs(weights, cross, serve_frames):
    """The world-4 spawn's per-rank results, and, computed here while
    the ranks run, the JAX references and the in-process runs."""
    cfg = W.config()
    toks = W.tokens(cfg)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(MESH.spawn_ranks, W.run_cases, 4, "gloo", weights,
                          cross, tensor=2)
        ref = dict(jax=_jax_grads(weights),
                   decode=_jax_decode(weights, serve_frames, toks),
                   serve_step=_jax_serve_step(weights, serve_frames, toks))
        local = {_case_id(c): W.train_case(weights, c[0], c[1], S=c[2],
                                           remat=c[3])
                 for c in TRAIN_CASES}
        for S in (2, 3):
            for V in (1, 2):
                local[f"serve S{S} V{V}"] = W.serve_case(
                    weights, cross, S=S, V=V, M=4 if S * V == 6 else 2)
        local["train cli"] = W._cli(ttrain.main(
            W.TRAIN_CLI + ["--microbatches", "4"]))
        ranks = fut.result()
    return dict(ranks=ranks, local=local, **ref)


def _check_grads(loss, full: dict, ref: dict, what: str):
    """The harness's bar: loss 1e-4, layer gradients 1e-4 relative, the
    embedding 1e-4 of (max |g| + 1), ``final_norm`` 1e-4 relative;
    ``full`` the port's whole tree (numpy, layers unstaged), ``ref``
    JAX's."""
    assert abs(float(loss) - ref["loss"]) < 1e-4, what
    errs = jax.tree.map(_rel, full["layers"], ref["grads"]["layers"])
    assert max(jax.tree.leaves(errs)) < 1e-4, (what, errs)
    assert set(full["layers"]) == set(ref["grads"]["layers"]) >= {
        "xattn", "ln_x"}
    want = ref["grads"]["embed"]
    assert np.abs(full["embed"] - want).max() < 1e-4 * (np.abs(want).max()
                                                        + 1), what
    assert _rel(full["final_norm"], ref["grads"]["final_norm"]) < 1e-4


def _unstacked(grads: dict, cfg) -> dict:
    """The port's stacked gradients (tensors) as JAX's unstaged tree."""
    plan = ST.plan_stages(cfg)
    g = convert.to_jax(grads)
    return dict(g, layers=jax.tree.map(
        lambda a: np.asarray(ST.unstack_chunks(a, plan))[:W.L], g["layers"]))


# ---------------------------------------------------------------------------
# the config, the trees, the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True])
def test_config_matches_jax(reduce):
    """``get_config("whisper-base")`` is the JAX package's field for
    field, and so is its reduced model (3 encoder + 3 decoder layers)."""
    cfg, jcfg = get_config("whisper-base"), jax_get_config("whisper-base")
    if reduce:
        cfg, jcfg = (c.reduced(n_layers=W.L, d_model=W.D_MODEL)
                     for c in (cfg, jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_enc_layers, cfg.n_layers) == (3, 6)
    assert TM.layer_meta(cfg)["is_decoder"] == [False] * 3 + [True] * 3


def test_trees_are_the_jax_packages(weights):
    """The port's parameter tree is the JAX package's leaf for leaf
    (``ln_x`` and ``xattn`` on every layer, encoder layers too), and
    crosses ``repro_torch.convert`` both ways bit for bit."""
    jcfg = _jcfg()
    want = jax.eval_shape(lambda: JST.init_stacked_params(
        jcfg, jax.random.PRNGKey(0), JST.plan_stages(jcfg)))
    want = dict(want, layers=jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
        want["layers"]))
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert [(k, a.shape, a.dtype) for k, a in flat(weights)] == \
        [(k, a.shape, a.dtype) for k, a in flat(want)]
    assert set(weights["layers"]) == {"attn", "xattn", "ln1", "ln_x", "ln2",
                                      "mlp"}
    back = convert.to_jax(convert.from_jax(weights, device="cpu"))
    for (k, a), (_, b) in zip(flat(back), flat(weights)):
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.fixture(scope="module")
def block_runs(weights):
    """Layer 1 (encoder) and layer 4 (decoder) through the JAX block and
    the port's on the same inputs: no cache; then the decoder layer (and
    the encoder layer, the identity in decode) with a cache: a prefill of
    PROMPT tokens and GEN one-token steps."""
    jcfg, cfg = _jcfg(), W.config()
    rng = np.random.default_rng(11)
    n = W.PROMPT + W.GEN
    h_enc = rng.standard_normal((W.SB, W.SF, W.D_MODEL)).astype(np.float32)
    h_dec = rng.standard_normal((W.SB, n, W.D_MODEL)).astype(np.float32)
    xk = rng.standard_normal((W.SB, W.SF, 4, 32)).astype(np.float32)
    xv = rng.standard_normal((W.SB, W.SF, 4, 32)).astype(np.float32)
    out = {}
    for layer in (1, 4):
        jp = jax.tree.map(lambda a: jnp.asarray(a[layer]), weights["layers"])
        tp = convert.from_jax(jax.tree.map(lambda a: a[layer],
                                           weights["layers"]), device="cpu")
        jmeta = {k: v[layer] for k, v in JM.layer_meta(jcfg).items()}
        meta = {k: v[layer] for k, v in TM.layer_meta(cfg).items()}
        pos = np.broadcast_to(np.arange(W.PROMPT), (W.SB, W.PROMPT)).copy()
        jx = dict(h_enc=jnp.asarray(h_enc),
                  h_dec=jnp.asarray(h_dec[:, :W.PROMPT]))
        tx = dict(h_enc=torch.from_numpy(h_enc),
                  h_dec=torch.from_numpy(h_dec[:, :W.PROMPT].copy()))
        want, _, _ = JM.block_apply(jcfg, jp, jx, jmeta, pos=jnp.asarray(pos))
        got, _, _ = TM.block_apply(cfg, tp, tx, meta,
                                   pos=torch.from_numpy(pos))
        out[f"nocache {layer}"] = [
            (got[k].numpy(), np.asarray(want[k])) for k in ("h_enc",
                                                            "h_dec")]
        jc = dict(jax.tree.map(lambda a: a[layer],
                               JM.init_cache(jcfg, W.SB, n, enc_len=W.SF)),
                  xk=jnp.asarray(xk), xv=jnp.asarray(xv))
        tc = dict(TM.layer_slice(TM.init_cache(cfg, W.SB, n, enc_len=W.SF,
                                               device="cpu"), layer),
                  xk=torch.from_numpy(xk), xv=torch.from_numpy(xv))
        pairs = []
        apply = jax.jit(lambda x, pos, c: JM.block_apply(
            jcfg, jp, x, jmeta, pos=pos, cache_l=c)[:2])
        for a, b in [(0, W.PROMPT)] + [(t, t + 1)
                                       for t in range(W.PROMPT, n)]:
            pos = np.broadcast_to(np.arange(a, b), (W.SB, b - a)).copy()
            vest = np.zeros((W.SB, 1, W.D_MODEL), np.float32)
            y, jc = apply(dict(h_enc=jnp.asarray(vest),
                               h_dec=jnp.asarray(h_dec[:, a:b])),
                          jnp.asarray(pos), jc)
            got, new, _ = TM.block_apply(
                cfg, tp, dict(h_enc=torch.from_numpy(vest),
                              h_dec=torch.from_numpy(h_dec[:, a:b].copy())),
                meta, pos=torch.from_numpy(pos), cache_l=tc)
            tc = dict(new, kv=dict(new["kv"]))
            pairs.append((got["h_dec"].numpy(), np.asarray(y["h_dec"])))
        out[f"cache {layer}"] = pairs
        out[f"len {layer}"] = (tc["kv"]["len"].numpy(),
                               np.asarray(jc["kv"]["len"]))
    return out


@pytest.mark.parametrize("case", ["nocache 1", "nocache 4", "cache 1",
                                  "cache 4"])
def test_block_matches_jax(block_runs, case):
    """An encoder block (layer 1) and a decoder block (layer 4) within
    2e-4 of the JAX block, both hidden states; with a cache (a prefill,
    then one-token steps over cached cross keys and values) the decoder
    block's output within 2e-4 and its offsets JAX's, the encoder block
    the identity with its offsets left at 0, as JAX leaves them."""
    for got, want in block_runs[case]:
        assert got.shape == want.shape
        assert _rel(got, want) < TOL, case
    if case.startswith("cache"):
        got, want = block_runs[f"len {case.split()[1]}"]
        assert np.array_equal(got, want)
        assert np.all(got == (0 if case == "cache 1"
                              else W.PROMPT + W.GEN))


def test_forward_loss_and_grads_match_jax(weights, runs):
    """The port's non-pipelined forward logits, loss and every gradient
    (through autograd) within 2e-4 of JAX's on the training batch."""
    cfg = W.config()
    b = W.batch(cfg)
    params = convert.from_jax(weights, device="cpu")
    leaves = ST._map_layers(lambda a: a.detach().requires_grad_(), params)
    loss = TM.loss_fn(cfg, leaves, b)
    grads = torch.autograd.grad(loss, ST.tree_leaves(leaves))
    ref = runs["jax"]
    assert abs(loss.item() - ref["loss"]) < TOL
    for g, w in zip(grads, jax.tree.leaves(ref["grads"])):
        assert _rel(g.numpy(), w) < TOL
    with torch.no_grad():
        x, _, _ = TM.forward(cfg, params, b)
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    jx, _, _ = JM.forward(_jcfg(), jax.tree.map(jnp.asarray, weights), jb)
    np.testing.assert_allclose((x @ params["embed"].T).numpy(),
                               np.asarray(jx @ weights["embed"].T),
                               atol=TOL, rtol=TOL)


def test_decode_matches_jax_and_full_forward(weights, cross, runs,
                                             serve_frames):
    """``prefill_audio_cache`` fills every layer's xk/xv as JAX's does
    (2e-4); ``decode_step`` over the prompt and the forced tokens gives
    JAX's logits (2e-4) and the port's own full forward's at every
    position (5e-5), and the decoder layers' offsets end at the tokens
    fed, the encoder layers' at 0."""
    cfg = W.config()
    params = convert.from_jax(weights, device="cpu")
    jc = JM.prefill_audio_cache(
        _jcfg(), jax.tree.map(jnp.asarray, weights),
        jnp.asarray(serve_frames), JM.init_cache(_jcfg(), W.SB, 1,
                                                 enc_len=W.SF))
    for k in ("xk", "xv"):
        assert cross[k].shape == (W.L, W.SB, W.SF, 4, 32)
        assert _rel(cross[k], np.asarray(jc[k])) < TOL
    toks = torch.from_numpy(W.tokens(cfg))
    n = toks.shape[1]
    cache = TM.init_cache(cfg, W.SB, n, enc_len=W.SF, device="cpu")
    cache = TM.prefill_audio_cache(cfg, params,
                                   torch.from_numpy(serve_frames), cache)
    feeds = [toks[:, :W.PROMPT]] + [toks[:, t:t + 1]
                                    for t in range(W.PROMPT, n)]
    steps = []
    with torch.no_grad():
        for f in feeds:
            lg, cache = TM.decode_step(cfg, params, dict(tokens=f), cache)
            steps.append(lg)
        x, _, _ = TM.forward(cfg, params, dict(
            tokens=toks, frames=torch.from_numpy(serve_frames)))
        full = (x @ params["embed"].T).numpy()
    for got, want in zip(steps, runs["decode"]):
        np.testing.assert_allclose(got[:, -1].numpy(), want, atol=TOL,
                                   rtol=TOL)
    dec = torch.cat(steps, dim=1).numpy()
    assert np.abs(dec - full).max() < DECODE_TOL
    assert cache["kv"]["len"].tolist() == [[0] * W.SB] * 3 + [[n] * W.SB] * 3


def test_attention_over_no_key_is_zero(weights):
    """At ``enc_len`` 0 the cross-attention sees no key: ``attend`` gives
    zeros without a launch (the kernel would refuse S = 0) and
    ``decode_step`` gives JAX's logits at ``enc_len`` 0 (finite)."""
    q = torch.randn(2, 3, 4, 32)
    kv = torch.zeros(2, 0, 4, 32)
    before = flash_attend.launches
    out = TL.attend(q, kv, kv, scale=0.1, causal=False)
    assert out.shape == q.shape and not out.any()
    assert flash_attend.launches == before
    cfg = W.config()
    toks = W.tokens(cfg)[:, :W.PROMPT + 2]
    params = convert.from_jax(weights, device="cpu")
    cache = TM.init_cache(cfg, W.SB, toks.shape[1], device="cpu")
    assert tuple(cache["xk"].shape) == (W.L, W.SB, 0, 4, 32)
    want = _jax_decode(weights, None, toks, enc_len=0)
    t = torch.from_numpy(toks)
    feeds = [t[:, :W.PROMPT], t[:, W.PROMPT:W.PROMPT + 1],
             t[:, W.PROMPT + 1:]]
    with torch.no_grad():
        for f, w in zip(feeds, want):
            lg, cache = TM.decode_step(cfg, params, dict(tokens=f), cache)
            assert np.isfinite(lg.numpy()).all()
            np.testing.assert_allclose(lg[:, -1].numpy(), w, atol=TOL,
                                       rtol=TOL)


def test_caches_hold_the_cross_subtree():
    """``init_cache``, the pipeline cache and a rank's cache hold k/v and
    their offsets beside xk/xv: at data 2 a replica's rows of both, at
    tensor 2 a shard's heads of both; the V 2 cache re-folds to V 1 with
    xk/xv; ``lay_cross_cache`` lays each slot's layer (a padded slot the
    last layer's)."""
    cfg = W.config(2)
    c = TM.init_cache(cfg, 4, 16, enc_len=W.SF, device="cpu")
    assert set(c) == {"kv", "xk", "xv"}
    assert tuple(c["xk"].shape) == (6, 4, W.SF, 4, 32)
    plan = ST.plan_stages(cfg)
    pc = RT.init_pipeline_cache(cfg, plan, 4, 16, enc_len=W.SF,
                                device="cpu")
    assert tuple(pc["xv"].shape) == (2, 3, 4, W.SF, 4, 32)
    d2 = RT.init_stage_cache(cfg, plan, 1, 4, 16, data=2, enc_len=W.SF,
                             device="cpu")
    assert tuple(d2["xk"].shape) == (3, 2, W.SF, 4, 32)
    assert tuple(d2["kv"]["len"].shape) == (3, 4)
    t2 = RT.init_stage_cache(W.config(2, 2), ST.plan_stages(W.config(2, 2)),
                             0, 4, 16, enc_len=W.SF, device="cpu")
    assert tuple(t2["xk"].shape) == (3, 4, W.SF, 2, 32)
    assert tuple(t2["kv"]["k"].shape) == (3, 4, 16, 2, 32)
    cfg2 = W.config(2, V=2)
    p2, p1 = ST.plan_stages(cfg2), ST.plan_stages(cfg2, virtual=1)
    c2 = RT.init_pipeline_cache(cfg2, p2, 4, 16, enc_len=W.SF, device="cpu")
    assert tuple(c2["xk"].shape) == (2, 2, 2, 4, W.SF, 4, 32)
    layer = torch.arange(6.0)[:, None, None, None, None].expand(
        6, 4, W.SF, 4, 32)
    RT.lay_cross_cache(cfg2, p2, c2, dict(xk=layer, xv=-layer))
    # [S, V, Lc]: element [s, v, j] holds layer (v*S + s)*Lc + j, the
    # padded slots (layers 6, 7) layer 5
    want = [[[0, 1], [4, 5]], [[2, 3], [5, 5]]]
    assert c2["xk"][..., 0, 0, 0, 0].tolist() == want
    ST.restack_tree_(c2, p2, p1, cfg2.n_layers)
    assert c2["xk"][..., 0, 0, 0, 0].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert c2["xv"][..., 0, 0, 0, 0].tolist() == [[0, -1, -2],
                                                  [-3, -4, -5]]


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,V", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_serve_matches_jax(runs, S, V):
    """The pipelined serve at S stages (V 2: interleaved prefill, then
    the handoff to V 1, which re-folds xk/xv with the rest of the
    cache): every step's logits within 2e-4 of the JAX serve step filled
    as its ``_stack_chunks`` lays it, and of JAX's ``decode_step``;
    every slot's offset ends at the tokens fed."""
    got = runs["local"][f"serve S{S} V{V}"]
    for lg, step, dec in zip(got["logits"], runs["serve_step"],
                             runs["decode"]):
        np.testing.assert_allclose(lg[:, 0].numpy(), step, atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(lg[:, 0, :W.config().vocab].numpy(), dec,
                                   atol=TOL, rtol=TOL)
    assert got["len"].tolist() == [W.PROMPT + W.GEN] * W.SB


@pytest.mark.parametrize("case", [_case_id(c) for c in TRAIN_CASES])
def test_train_step_matches_jax_grad(runs, case):
    """One in-process step (``S3``: 3 stages of 2 layers, a stage holding
    an encoder and a decoder layer; the interleaved builders at V 2):
    the harness's bar against ``loss_fn`` / ``jax.grad``, the cross
    attention's leaves and every encoder leaf included."""
    S = int(case[1])
    V, _ = W.builder_case(case.split()[1], S)
    got = runs["local"][case]
    _check_grads(got["loss"], _unstacked(got["grads"], W.config(S, V=V)),
                 runs["jax"], case)


def test_remat_full_is_the_stage_recompute(runs):
    """``remat='full'`` checkpoints each layer on the dict carry: its
    loss and gradients equal the stage recompute's bit for bit."""
    for full, stage in (("S2 1f1b ticks remat=full", "S2 1f1b ticks"),
                        ("S3 zb-h1 stream remat=full", "S3 zb-h1 stream")):
        a, b = runs["local"][full], runs["local"][stage]
        assert torch.equal(a["loss"], b["loss"])
        assert all(torch.equal(x, y) for x, y in zip(
            ST.tree_leaves(a["grads"]), ST.tree_leaves(b["grads"])))


# ---------------------------------------------------------------------------
# on ranks
# ---------------------------------------------------------------------------

def _bitwise(a, b) -> bool:
    la, lb = ST.tree_leaves(a), ST.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("case,local", [("S2 1f1b ticks", "S2 1f1b ticks"),
                                        ("S2 zb-h1 stream",
                                         "S2 zb-h1 stream")])
def test_two_ranks_are_in_process_bitwise(runs, case, local):
    """Each replica's 2-rank stage group, a bare group: the loss and
    every gradient share bit for bit the in-process step's rows; each
    hop carries the pair as one flat message."""
    want = runs["local"][local]
    plan = ST.plan_stages(W.config(2))
    for r in runs["ranks"]:
        s = r["grid"]["d2_stage"]
        got = r[case]
        assert torch.equal(got["loss"], want["loss"]), case
        assert _bitwise(got["grads"], ST.stage_share(want["grads"], plan, s))
        msgs, nbytes = got["stats"]["hop"]
        _, M = W.builder_case(case.split()[1])
        # every message a pair: M forward or M backward hops a rank sends
        pair = (W.B // M) * (W.SF + W.SEQ) * W.D_MODEL * 4
        assert msgs > 0 and nbytes == M * pair


def test_two_ranks_serve_is_in_process_bitwise(runs):
    """The V 2 serve on 2 ranks (each rank's handoff re-folding its own
    share of xk/xv with the rest of its cache): every step's logits bit
    for bit the in-process V 2 serve's."""
    want = runs["local"]["serve S2 V2"]
    for r in runs["ranks"]:
        got = r["S2 serve V2"]
        assert all(torch.equal(a, b) for a, b in zip(got["logits"],
                                                     want["logits"]))
        assert got["len"].tolist() == want["len"].tolist()


def _full_from_ranks(cfg, shares) -> dict:
    """The whole tree (numpy, layers unstaged) from the ranks' gradient
    shares of one replica (``shares[s][t]``)."""
    plan = ST.plan_stages(cfg)
    full = convert.from_rank_shares(shares, cfg, plan)
    full["layers"] = jax.tree.map(
        lambda a: np.asarray(ST.unstack_chunks(a, plan))[:W.L],
        full["layers"])
    return full


def test_data2_matches_jax(runs):
    """Data 2 x stages 2: the replicas' gradients bit for bit alike, the
    whole batch's loss within 1e-6 of the in-process data-1 loss, the
    gradients at the harness's bar; serving at data 2 (each replica's 2
    rows of k/v and of xk/xv) gives the in-process serve's logits bit
    for bit (the same 2-row micro-batches)."""
    ranks = runs["ranks"]
    for s in range(2):
        a, b = ranks[s]["data2 1f1b"], ranks[2 + s]["data2 1f1b"]
        assert _bitwise(a["grads"], b["grads"])
        assert a["stats"]["grad_sync"][0] > 0
    loss = float(ranks[0]["data2 1f1b"]["loss"])
    want = float(runs["local"]["S2 1f1b ticks"]["loss"])
    assert abs(loss - want) <= 1e-6 * want
    full = _full_from_ranks(W.config(2), [
        [ranks[s]["data2 1f1b"]["grads"]] for s in range(2)])
    _check_grads(loss, full, runs["jax"], "data2")
    ref = runs["local"]["serve S2 V1"]
    for r in ranks:
        got = r["data2 serve"]
        assert got["shapes"]["kv/k"][1] == W.SB // 2
        assert got["shapes"]["xk"][1] == W.SB // 2
        assert got["shapes"]["kv/len"][-1] == W.SB
        assert all(torch.equal(a, b) for a, b in zip(got["logits"],
                                                     ref["logits"]))


@pytest.mark.parametrize("runtime", ["ticks", "stream"])
def test_tensor2_matches_jax(runs, runtime):
    """Stages 2 x tensor 2: the harness's bar against ``loss_fn`` /
    ``jax.grad`` on the whole tree (the encoder's output enters the
    cross-attention's column-parallel keys and values through
    ``copy_to_tensor``); the self- and cross-attention leaves are cut in
    two."""
    case = f"tensor 1f1b {runtime}"
    ranks = runs["ranks"]
    shares = [[ranks[s * 2 + t][case]["grads"] for t in range(2)]
              for s in range(2)]
    for s in range(2):
        for blk in ("attn", "xattn"):
            assert shares[s][0]["layers"][blk]["wk"].shape[-1] == 2 * 32
    full = _full_from_ranks(W.config(2, 2), shares)
    _check_grads(ranks[0][case]["loss"], full, runs["jax"], case)
    assert all(r[case]["stats"]["tensor"][0] > 0 for r in ranks)


def test_tensor2_serve_matches_jax(runs):
    """Serving at stages 2 x tensor 2: each shard's cache holds 2 of the
    4 heads of k/v and of xk/xv; every step's logits on every rank
    within 2e-4 of the JAX serve step's."""
    for r in runs["ranks"]:
        got = r["tensor serve"]
        assert got["shapes"]["kv/k"][-2] == 2
        assert got["shapes"]["xk"][-2] == 2
        for lg, want in zip(got["logits"], runs["serve_step"]):
            np.testing.assert_allclose(lg[:, 0].numpy(), want, atol=TOL,
                                       rtol=TOL)


def test_train_cli_on_ranks(runs):
    """``launch.train --arch whisper-base --reduced`` (its stub frames)
    as data 2 x stages 2 ranks: both steps' losses within 1e-5 relative
    of the in-process CLI at 4 micro-batches (the same 2-row
    micro-batches)."""
    want = runs["local"]["train cli"]["losses"]
    for r in runs["ranks"]:
        got = r["train cli data2"]["losses"]
        assert len(got) == len(want) == 2
        assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# checkpoints, the planner, the CLIs, refusals
# ---------------------------------------------------------------------------

def _jax_state(weights: dict) -> dict:
    """A training state of the reduced whisper at 2 stages as the JAX
    package holds it: the weights stacked by its ``_stack_chunks`` and
    AdamW moments (numpy leaves)."""
    from repro.optim import AdamW as JAdamW
    plan = JST.plan_stages(_jcfg(2))
    params = dict(weights, layers=jax.tree.map(
        lambda a: np.asarray(JST._stack_chunks(a, plan)),
        weights["layers"]))
    opt = dict(JAdamW().init(params), step=jnp.asarray(5, jnp.int32))
    return jax.tree.map(np.asarray, dict(params=params, opt=opt))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def test_checkpoints_cross_both_ways(tmp_path, weights):
    """A JAX checkpoint of whisper's state restores in the port bit for
    bit (``xattn`` and ``ln_x`` beside ``attn``); the port's save of it
    has the JAX save's ``.meta`` bytes and restores in the JAX package
    bit for bit."""
    ref = _jax_state(weights)
    plan = ST.plan_stages(W.config(2))
    extra = dict(layout=layout_dict(plan, W.L), arch="whisper-base")
    JC.save_checkpoint(str(tmp_path / "j"), ref, step=5, extra=extra)
    like = convert.from_jax(ref, device="cpu")
    got = convert.to_jax(restore_checkpoint(str(tmp_path / "j"), like,
                                            device="cpu"))
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert {"xattn", "ln_x"} <= set(got["params"]["layers"])
    for (k, a), (_, b) in zip(flat(got), flat(ref)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), k
    save_checkpoint(str(tmp_path / "p"), like, step=5, extra=extra)
    assert (tmp_path / "p.meta").read_bytes() == \
        (tmp_path / "j.meta").read_bytes()
    back = jax.tree.map(np.asarray, JC.restore_checkpoint(
        str(tmp_path / "p"), ref))
    for (k, a), (_, b) in zip(flat(back), flat(ref)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), k


def test_reshard_is_the_jax_packages(tmp_path, weights):
    """Whisper's state resharded from 2 stages to 2 stages of V 2 (the
    3 + 3 layers padded to 8 slots): the port's file byte-equal to the
    JAX package's."""
    ref = _jax_state(weights)
    pa, pb = ST.plan_stages(W.config(2)), ST.plan_stages(W.config(2, V=2))
    src = str(tmp_path / "src")
    JC.save_checkpoint(src, ref, step=5,
                       extra=dict(layout=layout_dict(pa, W.L)))
    got = reshard_checkpoint(src, str(tmp_path / "p"), pb)
    want = JC.reshard_checkpoint(src, str(tmp_path / "j"), JST.StagePlan(
        **dataclasses.asdict(pb)))
    assert got == want
    assert (tmp_path / "p.meta").read_bytes() == \
        (tmp_path / "j.meta").read_bytes()
    with np.load(str(tmp_path / "p.npz")) as x, \
            np.load(str(tmp_path / "j.npz")) as y:
        assert sorted(x.files) == sorted(y.files)
        assert any("xattn" in k for k in x.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_planner_plans_whisper_as_jax():
    """whisper-base at full width: ``auto_plan`` over 2 H100s and
    ``auto_plan3d`` over a pool of 4 pick the JAX planner's plans, and
    the train CLI's ``--auto-plan`` on the reduced model adopts the JAX
    explorer's plan and trains."""
    cfg, jcfg = get_config("whisper-base"), jax_get_config("whisper-base")
    kw = dict(global_batch=8, seq_len=448, model_axis=2, data_axis=1)
    a = TA.auto_plan(cfg, device=TH.H100, **kw)
    b = JA.auto_plan(jcfg, device=JH100, **kw)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    a3 = TA.auto_plan3d(cfg, device=TH.H100, global_batch=8, seq_len=448,
                        n_devices=4)
    b3 = JA.auto_plan3d(jcfg, device=JH100, global_batch=8, seq_len=448,
                        n_devices=4)
    assert dataclasses.astuple(a3) == dataclasses.astuple(b3)
    out = ttrain.main(["--arch", "whisper-base", "--reduced", "--layers",
                       "6", "--d-model", "128", "--batch", "8", "--seq",
                       "16", "--steps", "2", "--device", "cpu", "--stages",
                       "2", "--auto-plan", "--cluster", "h100,h100"])
    jred = dataclasses.replace(jcfg.reduced(n_layers=6, d_model=128,
                                            seq=16), stages=2)
    want = JA.auto_plan(jred, global_batch=8, seq_len=16, model_axis=2,
                        data_axis=1, devices=[JH100] * 2)
    fields = lambda p: (p.stages, p.tensor, p.n_microbatches, p.schedule,
                        p.virtual, p.data_axis, p.predicted_step_time)
    assert fields(out["plan"]) == fields(want)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


def test_train_cli_resumes_bitwise(tmp_path):
    """``launch.train --arch whisper-base --reduced`` at 3 stages (enc,enc
    | enc,dec | dec,dec): a run that saves at step 2 and dies after step
    3, resumed from its file, ends with the uninterrupted run's losses
    bit for bit."""
    argv = ["--arch", "whisper-base", "--reduced", "--layers", "6",
            "--d-model", "128", "--stages", "3", "--microbatches", "2",
            "--batch", "4", "--seq", "16", "--steps", "4", "--log-every",
            "100", "--device", "cpu"]
    ref = ttrain.main(argv)
    assert ref["stash_slots"] == [2, 2, 1]
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit):
        ttrain.main(argv + ["--ckpt", ck, "--ckpt-every", "2", "--die-at",
                            "3"])
    out = ttrain.main(argv + ["--resume", ck])
    assert out["losses"] == ref["losses"][2:]


def test_serve_cli_refuses_whisper():
    """``launch.serve --arch whisper-base`` raises a ValueError before any
    group is set up: the CLI takes no frames (nor does the JAX CLI serve
    the family); the message names the path that serves it."""
    with pytest.raises(ValueError, match="prefill_audio_cache"):
        tserve.main(["--arch", "whisper-base", "--reduced", "--device",
                     "cpu"])


def test_audio_refusals():
    """Continuous batching stays refused for the audio family (``n_valid``
    and the engine), as in JAX; a train batch without frames raises."""
    from repro_torch.core import serve_sched as SS
    cfg = W.config(1)
    plan = ST.plan_stages(cfg)
    step = RT.make_serve_step(cfg, plan, RT.PipelineConfig(n_microbatches=1),
                              q_len=4)
    params = ST.init_stacked_params(cfg, 0, plan, device="cpu")
    cache = RT.init_pipeline_cache(cfg, plan, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="audio"):
        step(params, cache, dict(tokens=torch.zeros(2, 4, dtype=torch.long),
                                 n_valid=torch.tensor([4, 1])))
    with pytest.raises(ValueError, match="audio"):
        SS.ContinuousEngine(cfg, step, params, cache, 2, 4)
    train = RT.make_train_step(cfg, plan, RT.PipelineConfig(n_microbatches=1))
    b = W.batch(cfg)
    del b["frames"]
    with pytest.raises(ValueError, match="frames"):
        train(params, b)
