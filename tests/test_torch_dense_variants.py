"""The port's dense GQA variants, gemma3-1b (sliding-window layers, a
global layer every ``global_every``, head_dim 256, GeLU, qk-norm, the
embedding scaled by sqrt(d_model)) and qwen3-1.7b (16/8 heads, qk-norm),
against the JAX package on the CPU.

Weights are made by the JAX package and carried over by
``repro_torch.convert`` (the serving CLI's by the port, carried the other
way); inputs are made with numpy from a seed.  Configs are the published
ones reduced to 3 layers, d_model 256 (gemma3: window 32, layer 2 global),
plus gemma3 at its published head_dim 256; sequences of 48 tokens, longer
than the window.  Bars: logits 2e-4 (the serving suites'), the
non-pipelined loss 2e-6 relative and its gradient 2e-6 of its largest
entry (what ROADMAP records for llama; each leaf also 1e-5 of its own),
pipelined training the JAX harness's (``tests/harness_pipe.py``:
loss 1e-4, layer gradients 1e-4 of max |ref|), the windowed attention
backward 1e-4 of max |ref|, greedy tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

B, SEQ = 4, 48
#: (id, arch, fields replaced on both sides after reduced(n_layers=3))
MODELS = [("gemma3", "gemma3-1b", {}),
          ("gemma3-hd256", "gemma3-1b", {"head_dim": 256}),
          ("qwen3", "qwen3-1.7b", {})]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, leaving the other cores to the
    test files that run beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _cfgs(arch, over, **kw):
    return tuple(dataclasses.replace(get(arch).reduced(n_layers=3), **over,
                                     **kw)
                 for get in (get_config, jax_get_config))


def _batch(vocab):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, vocab, (B, SEQ + 1)).astype(np.int32)
    return dict(tokens=toks[:, :-1], labels=toks[:, 1:])


@pytest.fixture(scope="module", params=MODELS, ids=[m[0] for m in MODELS])
def model(request):
    """One model's configs, JAX-made unstaged weights (numpy), a batch, and
    the JAX package's logits, loss and gradients on it."""
    _, arch, over = request.param
    cfg, jcfg = _cfgs(arch, over)
    jp = JST.init_stacked_params(jcfg, jax.random.PRNGKey(0),
                                 JST.plan_stages(jcfg))
    rp = dict(jp, layers=jax.tree.map(lambda a: a[0], jp["layers"]))
    batch = _batch(cfg.vocab)
    jb = jax.tree.map(jnp.asarray, batch)
    x, _, _ = JM.forward(jcfg, rp, jb)
    logits = (x @ rp["embed"].T).astype(jnp.float32)
    loss, grads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb))(rp)
    np_ = lambda t: jax.tree.map(np.asarray, t)
    return dict(cfg=cfg, jcfg=jcfg, params=np_(rp), batch=batch,
                logits=np.asarray(logits), loss=float(loss),
                grads=np_(grads))


def _port_params(model):
    return convert.from_jax(model["params"], device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the configs as the model reads them
# ---------------------------------------------------------------------------

def test_reduced_configs_window_layers():
    """gemma3 reduced to 3 layers: window 32 on layers 0 and 1, layer 2
    global with its own theta; qwen3 has no window; both as JAX's."""
    g, jg = _cfgs("gemma3-1b", {})
    meta, jmeta = TM.layer_meta(g), JM.layer_meta(jg)
    assert g.window == 32 and g.global_every == 3
    assert meta["is_global"] == [False, False, True]
    assert meta["is_global"] == [bool(x) for x in np.asarray(
        jmeta["is_global"])]
    np.testing.assert_array_equal(meta["rope_theta"],
                                  np.asarray(jmeta["rope_theta"]))
    q, _ = _cfgs("qwen3-1.7b", {})
    assert q.window == 0 and all(TM.layer_meta(q)["is_global"])


def test_gemma3_stage_plan_pads_two_inactive_slots():
    """26 layers over 4 stages: 7 slots a stage, the last 2 padded and
    inactive; the 4 global layers (5, 11, 17, 23) where the config puts
    them."""
    cfg = dataclasses.replace(get_config("gemma3-1b"), tensor=1)
    plan = ST.plan_stages(cfg)
    meta = ST.stacked_meta(cfg, plan)
    assert plan.layers_per_stage == 7 and plan.n_layers_padded == 28
    flat = [m for stage in meta for m in stage]
    assert [m["active"] for m in flat] == [True] * 26 + [False] * 2
    assert [i for i, m in enumerate(flat[:26]) if m["is_global"]] == \
        [5, 11, 17, 23]


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-1.7b"])
def test_embedding_scale_matches_jax(arch):
    """gemma scales the embedding by sqrt(d_model) in its dtype; qwen3
    gathers it plain."""
    cfg, jcfg = _cfgs(arch, {})
    rng = np.random.default_rng(3)
    table = rng.standard_normal((cfg.vocab, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    got = TM.embed_tokens(cfg, torch.from_numpy(table), torch.from_numpy(toks))
    want = JM.embed_tokens(jcfg, jnp.asarray(table), jnp.asarray(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    scale = np.float32(np.sqrt(cfg.d_model)) if arch.startswith("gemma") \
        else np.float32(1)
    np.testing.assert_array_equal(got.numpy(), table[toks] * scale)


# ---------------------------------------------------------------------------
# the windowed attention's backward and split-KV algorithm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [3, 8])
@pytest.mark.parametrize("D", [64, 256])
def test_attend_bwd_ref_window_matches_jax_vjp(window, D):
    """attend_bwd_ref (from the plain forward's output and statistics)
    against jax.vjp of the reference attend, per-row offsets with a row
    that sees no key and a row past the window's reach: dq, dk, dv within
    1e-4 of max |ref|."""
    rng = np.random.default_rng(window * 1000 + D)
    Bq, T, S, Hq, Hkv = 4, 12, 20, 4, 2
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((Bq, T, Hq, D), (Bq, S, Hkv, D), (Bq, S, Hkv, D),
                    (Bq, T, Hq, D)))
    q_start = np.array([0, 8, 0, 16], np.int32)
    kv_len = np.array([12, 20, 0, 4], np.int32)
    kw = dict(scale=D ** -0.5, causal=True)
    _, vjp = jax.vjp(lambda a, b, c: JL.attend(
        a, b, c, q_start=jnp.asarray(q_start), kv_len=jnp.asarray(kv_len),
        window=window, **kw), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    tkw = dict(kw, q_start=torch.from_numpy(q_start),
               kv_len=torch.from_numpy(kv_len), window=window)
    out = FA.attend_ref(*t[:3], **tkw)
    lse = FA.attend_lse_ref(t[0], t[1], **tkw)
    got = FA.attend_bwd_ref(*t[:3], out, lse, t[3], **tkw)
    for name, a, b in zip("qkv", got, want):
        assert _rel(a.numpy(), b) < 1e-4, name


@pytest.mark.parametrize("window", [5, 16])
def test_attend_split_ref_window_matches_attend_ref(window):
    """The decode route's algorithm with a window: 8 key splits of 8 over
    S = 64, rows near the end (most splits wholly before the window), one
    mid-cache and one that sees no key."""
    g = torch.Generator().manual_seed(window)
    q = torch.randn(4, 1, 4, 32, generator=g)
    k, v = torch.randn(4, 64, 1, 32, generator=g), torch.randn(
        4, 64, 1, 32, generator=g)
    kw = dict(scale=32 ** -0.5, causal=True,
              q_start=torch.tensor([63, 60, 20, 0], dtype=torch.int32),
              kv_len=torch.tensor([64, 61, 21, 0], dtype=torch.int32),
              window=window)
    want = FA.attend_ref(q, k, v, **kw)
    got = FA.attend_split_ref(q, k, v, n_split=8, **kw)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the models: forward, loss and gradients, pipelined training
# ---------------------------------------------------------------------------

def test_forward_logits_match_jax(model):
    cfg, params = model["cfg"], _port_params(model)
    x, _, _ = TM.forward(cfg, params, _torch_batch(model["batch"]))
    logits = (x @ params["embed"].T).float()
    np.testing.assert_allclose(logits.numpy(), model["logits"], atol=2e-4,
                               rtol=2e-4)


def test_loss_and_grads_match_jax(model):
    """The port's non-pipelined loss_fn under torch autograd against
    jax.value_and_grad: the loss within 2e-6 relative, the gradient
    within 2e-6 of its largest entry (max |got - ref| over every leaf over
    max |ref| over every leaf), and each leaf within 1e-5 of its own
    largest entry.  f32 sums in another order leave ~1.5e-6 of each leaf's
    largest entry, evenly over the leaves (measured on this CPU), so the
    per-leaf bar catches a wrong leaf without resting on rounding."""
    cfg, params = model["cfg"], _port_params(model)
    leaves = ST.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss = TM.loss_fn(cfg, params, _torch_batch(model["batch"]))
    grads = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    want = jax.tree.leaves(model["grads"])
    assert abs(loss.item() - model["loss"]) <= 2e-6 * abs(model["loss"])
    diff = max(np.abs(g - w).max() for g, w in zip(grads, want))
    assert diff <= 2e-6 * max(np.abs(w).max() for w in want)
    for g, w in zip(grads, want):
        assert _rel(g, w) < 1e-5


def _stacked(params_np, jcfg, S):
    """The unstaged JAX weights stacked [S, Lps, ...] by the JAX package's
    stacking; padded slots repeat the last layer."""
    plan = JST.plan_stages(dataclasses.replace(jcfg, stages=S))

    def stack(a):
        pad = plan.n_layers_padded - a.shape[0]
        if pad:
            a = np.concatenate([a] + [a[-1:]] * pad)
        return JST._stack_chunks(a, plan)
    return plan, convert.from_jax(dict(
        params_np, layers=jax.tree.map(stack, params_np["layers"])),
        device="cpu")


@pytest.mark.parametrize("schedule", ["1f1b", "zb-h1"])
def test_pipelined_train_step_matches_jax_grad(model, schedule):
    """2 stages (3 layers padded to 4 slots), 2 micro-batches, at the JAX
    harness's bar against loss_fn and jax.grad."""
    cfg = dataclasses.replace(model["cfg"], stages=2)
    plan = ST.plan_stages(cfg)
    jplan, params = _stacked(model["params"], model["jcfg"], 2)
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=2, schedule=schedule))
    loss, grads = step(params, _torch_batch(model["batch"]))
    want = model["grads"]
    assert abs(float(loss) - model["loss"]) < 1e-4
    got = jax.tree.map(lambda a: np.asarray(JST.unstack_chunks(a, jplan)),
                       convert.to_jax(grads["layers"]))
    L = cfg.n_layers
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want["layers"])):
        assert _rel(a[:L], b) < 1e-4
        assert not np.any(a[L:])                     # the padded slot
    assert np.abs(grads["embed"].numpy() - want["embed"]).max() < \
        1e-4 * (np.abs(want["embed"]).max() + 1)
    assert _rel(grads["final_norm"].numpy(), want["final_norm"]) < 1e-4


# ---------------------------------------------------------------------------
# greedy serving through the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-1.7b"])
def test_serve_cli_tokens_match_jax_decode(arch):
    """``repro_torch.launch.serve.main --reduced --device cpu`` (4 layers,
    2 stages, a 40-token prompt: longer than gemma3's 32-key window) gives
    the tokens of the JAX package's greedy decode_step loop with the same
    weights (the CLI's seed, carried over by convert)."""
    prompt_len, gen = 40, 4
    out = tserve.main(["--arch", arch, "--reduced", "--stages", "2",
                       "--batch", str(B), "--prompt-len", str(prompt_len),
                       "--gen", str(gen), "--device", "cpu"])
    cfg = dataclasses.replace(get_config(arch).reduced(n_layers=4,
                                                       d_model=256), stages=2)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(n_layers=4,
                                                            d_model=256))
    assert cfg.window == (32 if arch.startswith("gemma") else 0)
    plan = ST.plan_stages(cfg)
    stacked = ST.init_stacked_params(cfg, 0, plan, device="cpu")
    layers = ST._map_layers(lambda a: ST.unstack_chunks(a, plan)[:4],
                            stacked["layers"])
    rp = jax.tree.map(jnp.asarray, convert.to_jax(dict(stacked,
                                                       layers=layers)))
    prompt = torch.randint(0, cfg.vocab, (B, prompt_len),
                           generator=torch.Generator().manual_seed(1))
    step = jax.jit(lambda p, b, c: JM.decode_step(jcfg, p, b, c))
    cache = JM.init_cache(jcfg, B, max_len=prompt_len + gen)
    lg, cache = step(rp, dict(tokens=jnp.asarray(prompt.numpy())), cache)
    toks = [jnp.argmax(lg[:, -1, :cfg.vocab], -1)]
    for _ in range(gen - 1):
        lg, cache = step(rp, dict(tokens=toks[-1][:, None]), cache)
        toks.append(jnp.argmax(lg[:, 0, :cfg.vocab], -1))
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.stack([np.asarray(t) for t in toks], 1))
