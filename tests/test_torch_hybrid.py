"""The hybrid family in the port (hymba-1.5b: GQA attention and the
Mamba-2 SSM side by side on one normed input, fused as ``0.5 * (h_attn +
h_ssm)``) against the JAX package, on the CPU.

hymba-1.5b reduced to 3 layers (``tests/_torch_hybrid_worker.py``'s
:func:`config`: 4/4 heads of 64, window 32 with layer 0 global, the
SSM's 16 heads of 32, d_state 16, chunk 16; batch 4, seq 48), its
weights drawn once (the port's generator, seed 0) and handed to both
packages as numpy (``repro_torch.convert``).  Held to the JAX model on
the same inputs:

* the block, without a cache and with one (a 32-token prefill, then 3
  one-token steps past the window): outputs and both cache subtrees;
* the pipelined serve at V 1 and V 2 (the handoff re-folding both
  subtrees): every step's logits within 2e-4 of the JAX forward over
  the tokens fed;
* one train step under 1f1b, zb-h1 and 1f1b-interleaved, ticks and
  stream, and 1f1b under ``remat='full'``: loss and gradients at the
  harness's bar (``tests/harness_pipe.py:96-109``);
* on one world of 4 gloo ranks, spawned once while this process
  computes the references: 2 ranks bit for bit the in-process step and
  serve; data 2 x stages 2 against data 1; stages 2 x tensor 2 against
  the JAX ``loss_fn`` / ``jax.grad`` (an SSM input entering through
  ``copy_to_tensor`` doubles the gradient below it and misses this by
  far) with every ``ssm`` leaf's gradient bitwise equal on a stage's
  two shards, and its serve against the JAX logits;
* checkpoints crossing both ways bit for bit, one reshard byte-equal to
  the JAX package's, the planner's plans equal to the JAX package's;
* the refusals: ``n_valid`` and the continuous-batching engine for a
  hybrid model, a tensor degree that does not divide the heads.
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
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models import model as JM
from repro.optim import AdamW as JAdamW
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.checkpoint import (layout_dict, reshard_checkpoint,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core import autoplan as TA
from repro_torch.core import hardware as TH
from repro_torch.core import serve_sched as SS
from repro_torch.launch import mesh as MESH
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch import with_tensor
from repro_torch.models import model as TM
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

import _torch_hybrid_worker as W

TOL = 2e-4              # serving logits, as tests/test_torch_serve.py
BLOCK_TOL = 1e-4        # a block's output, as tests/test_torch_ssm.py
BLOCK_STEPS = 3         # the block's one-token steps past the window
JH100 = JH.DeviceSpec(**dataclasses.asdict(TH.H100))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _jcfg(S: int = 1, V: int = 1):
    return dataclasses.replace(
        jax_get_config("hymba-1.5b").reduced(n_layers=W.L), stages=S,
        tensor=1, virtual=V)


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


def test_trees_are_the_jax_packages(weights):
    """The port's parameter tree is the JAX package's leaf for leaf
    (``ssm`` beside ``attn``, same shapes and dtypes, from
    ``jax.eval_shape`` of its ``init_stacked_params``), and crosses
    ``repro_torch.convert`` both ways bit for bit."""
    jcfg = _jcfg()
    want = jax.eval_shape(lambda: JST.init_stacked_params(
        jcfg, jax.random.PRNGKey(0), JST.plan_stages(jcfg)))
    want = dict(want, layers=jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
        want["layers"]))
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert [(k, a.shape, a.dtype) for k, a in flat(weights)] == \
        [(k, a.shape, a.dtype) for k, a in flat(want)]
    assert set(weights["layers"]) == {"attn", "ssm", "ln1", "ln2", "mlp"}
    back = convert.to_jax(convert.from_jax(weights, device="cpu"))
    for (k, a), (_, b) in zip(flat(back), flat(weights)):
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def _jax_refs(weights: dict) -> dict:
    """The JAX loss and gradients on the step-0 batch, and the JAX
    logits over the tokens the in-process V 1 serve feeds."""
    jcfg = _jcfg()
    data = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=W.SEQ,
                          global_batch=W.B, seed=0)
    vg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(jcfg, p, b)))
    loss, grads = vg(weights, data.batch(0))
    return dict(loss=float(loss), grads=jax.tree.map(np.asarray, grads))


def _jax_logits(weights: dict, tokens: list) -> np.ndarray:
    """The JAX model's logits at every position of the tokens fed."""
    seq = np.concatenate([t.numpy() for t in tokens[:-1]], axis=1)
    x, _, _ = JM.forward(_jcfg(), weights, dict(tokens=jnp.asarray(seq)))
    return np.asarray(x @ weights["embed"].T)


@pytest.fixture(scope="module")
def runs(weights):
    """The world-4 spawn's per-rank results, and, computed here while
    the ranks run, the JAX references and the in-process runs."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(MESH.spawn_ranks, W.run_cases, 4, "gloo", weights,
                          tensor=2)
        jax_ref = _jax_refs(weights)
        local = {f"{s} {r}": W.train_case(weights, s, r)
                 for s in ("1f1b", "zb-h1", "1f1b-interleaved")
                 for r in ("ticks", "stream")}
        local["1f1b full"] = W.train_case(weights, remat="full")
        local["serve V1"] = W.serve_case(weights)
        local["serve V2"] = W.serve_case(weights, V=2)
        ranks = fut.result()
    return dict(ranks=ranks, weights=weights, jax=jax_ref, local=local,
                logits=_jax_logits(weights, local["serve V1"]["tokens"]))


def _check_grads(loss, full: dict, ref: dict, what: str):
    """The harness's bar: loss 1e-4, layer gradients 1e-4 relative, the
    embedding 1e-4 of (max |g| + 1), ``final_norm`` 1e-4 relative;
    ``full`` the port's whole stacked tree (numpy), ``ref`` JAX's."""
    assert abs(float(loss) - ref["loss"]) < 1e-4, what
    errs = jax.tree.map(_rel, full["layers"], ref["grads"]["layers"])
    assert max(jax.tree.leaves(errs)) < 1e-4, (what, errs)
    assert set(full["layers"]["ssm"]) == set(ref["grads"]["layers"]["ssm"])
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
# the block and its cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block_runs(weights):
    """Layer 1 (windowed) through the JAX block and the port's on the
    same inputs: no cache (T 32), then with a cache: a 32-token prefill
    and :data:`BLOCK_STEPS` one-token steps past the window (positions
    32, 33, 34: the window of 32 hides a key from the first on)."""
    jcfg, cfg = _jcfg(), W.config()
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]), weights["layers"])
    tp = convert.from_jax(jax.tree.map(lambda a: a[1], weights["layers"]),
                          device="cpu")
    jmeta = {k: v[1] for k, v in JM.layer_meta(jcfg).items()}
    meta = {k: v[1] for k, v in TM.layer_meta(cfg).items()}
    rng = np.random.default_rng(11)
    n = W.PROMPT + BLOCK_STEPS
    xs = rng.standard_normal((W.B, n, cfg.d_model)).astype(np.float32)
    apply = jax.jit(lambda x, pos, c: JM.block_apply(
        jcfg, jp, x, jmeta, pos=pos, cache_l=c)[:2])
    out = {}
    pos = np.broadcast_to(np.arange(W.PROMPT), (W.B, W.PROMPT))
    want, _, _ = JM.block_apply(jcfg, jp, jnp.asarray(xs[:, :W.PROMPT]),
                                jmeta, pos=jnp.asarray(pos))
    got, _, _ = TM.block_apply(cfg, tp, torch.from_numpy(xs[:, :W.PROMPT]),
                               meta, pos=torch.from_numpy(pos.copy()))
    out["nocache"] = [(got.numpy(), np.asarray(want))]
    jc = jax.tree.map(lambda a: a[1], JM.init_cache(jcfg, W.B, n))
    tc = TM.layer_slice(TM.init_cache(cfg, W.B, n, device="cpu"), 1)
    steps = [(0, W.PROMPT)] + [(t, t + 1) for t in range(W.PROMPT, n)]
    pairs = []
    for a, b in steps:
        pos = np.broadcast_to(np.arange(a, b), (W.B, b - a)).copy()
        y, jc = apply(jnp.asarray(xs[:, a:b]), jnp.asarray(pos), jc)
        got, new, _ = TM.block_apply(cfg, tp, torch.from_numpy(xs[:, a:b]),
                                     meta, pos=torch.from_numpy(pos),
                                     cache_l=tc)
        tc = dict(new, kv=dict(new["kv"]))
        pairs.append((got.numpy(), np.asarray(y)))
    out["prefill"], out["decode"] = pairs[:1], pairs[1:]
    out["cache"] = (convert.to_jax(tc), jax.tree.map(np.asarray, jc))
    return out


@pytest.mark.parametrize("case", ["nocache", "prefill", "decode"])
def test_block_matches_jax(block_runs, case):
    """The hybrid block's output within 1e-4 of the JAX block's; with a
    cache, after the last step both subtrees (k/v and their offsets, the
    SSM conv window and state) match the JAX cache's."""
    for got, want in block_runs[case]:
        assert got.shape == want.shape
        assert _rel(got, want) < BLOCK_TOL, case
    if case == "decode":
        got, want = block_runs["cache"]
        assert set(got) == set(want) == {"kv", "ssm"}
        assert np.array_equal(got["kv"]["len"], want["kv"]["len"])
        assert np.all(got["kv"]["len"] == W.PROMPT + BLOCK_STEPS)
        for sub, keys in (("kv", ("k", "v")), ("ssm", ("conv", "state"))):
            for k in keys:
                assert _rel(got[sub][k], want[sub][k]) < BLOCK_TOL, (sub, k)


def test_caches_hold_both_subtrees():
    """``init_cache``, the pipeline cache and a rank's cache hold k/v
    with their offsets beside the SSM conv window and state: at data 2 a
    replica's rows of both and every slot's offsets; at tensor 2 a
    shard's kv heads and every SSM head."""
    cfg = W.config(2)
    s = cfg.ssm
    nh, conv = s.n_heads(cfg.d_model), s.expand * cfg.d_model + 2 * s.d_state
    c = TM.init_cache(cfg, 4, 16, device="cpu")
    assert set(c) == {"kv", "ssm"} and TM._cache_len(c).tolist() == [0] * 4
    assert tuple(c["ssm"]["state"].shape) == (3, 4, nh, s.head_dim,
                                              s.d_state)
    plan = ST.plan_stages(cfg)
    pc = RT.init_pipeline_cache(cfg, plan, 4, 16, device="cpu")
    assert tuple(pc["kv"]["k"].shape) == (2, 2, 4, 16, 4, 64)
    assert tuple(pc["ssm"]["conv"].shape) == (2, 2, 4, s.d_conv - 1, conv)
    d2 = RT.init_stage_cache(cfg, plan, 1, 4, 16, data=2, device="cpu")
    assert tuple(d2["kv"]["k"].shape) == (2, 2, 16, 4, 64)
    assert tuple(d2["kv"]["len"].shape) == (2, 4)
    assert tuple(d2["ssm"]["state"].shape) == (2, 2, nh, s.head_dim,
                                               s.d_state)
    t2 = RT.init_stage_cache(W.config(2, 2), ST.plan_stages(W.config(2, 2)),
                             0, 4, 16, device="cpu")
    assert tuple(t2["kv"]["k"].shape) == (2, 4, 16, 2, 64)
    assert tuple(t2["ssm"]["state"].shape) == (2, 4, nh, s.head_dim,
                                               s.d_state)
    # the V 2 cache re-folds to V 1 with both subtrees
    cfg2 = W.config(2, V=2)
    p2, p1 = ST.plan_stages(cfg2), ST.plan_stages(cfg2, virtual=1)
    c2 = RT.init_pipeline_cache(cfg2, p2, 4, 16, device="cpu")
    ST.restack_tree_(c2, p2, p1, cfg2.n_layers)
    assert tuple(c2["ssm"]["state"].shape) == tuple(
        RT.init_pipeline_cache(cfg2, p1, 4, 16,
                               device="cpu")["ssm"]["state"].shape)


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [1, 2])
def test_serve_matches_jax(runs, V):
    """The pipelined serve at 2 stages (V 2: interleaved prefill, then
    the handoff to V 1): every step's logits within 2e-4 of the JAX
    forward over the tokens fed, decode past the window; V 2 feeds the
    tokens V 1 feeds, and both end with every slot's offset at 48."""
    got = runs["local"][f"serve V{V}"]
    if V == 2:
        assert all(torch.equal(a, b) for a, b in zip(
            got["tokens"], runs["local"]["serve V1"]["tokens"]))
    want = runs["logits"]
    for k, lg in enumerate(got["logits"]):
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   want[:, W.PROMPT - 1 + k], atol=TOL,
                                   rtol=TOL)
    assert got["len"].tolist() == [W.PROMPT + W.GEN] * W.B


@pytest.mark.parametrize("case", [f"{s} {r}" for s in (
    "1f1b", "zb-h1", "1f1b-interleaved") for r in ("ticks", "stream")]
    + ["1f1b full"])
def test_train_step_matches_jax_grad(runs, case):
    """One in-process step at 2 stages (the interleaved builder at V 2;
    ``1f1b full``: 1f1b under ``remat='full'``): the harness's bar
    against ``loss_fn`` / ``jax.grad``, every ``ssm`` leaf included."""
    sched = case.split()[0]
    V, _ = W.builder_case(sched)
    got = runs["local"][case]
    _check_grads(got["loss"], _unstacked(got["grads"], W.config(2, V=V)),
                 runs["jax"], case)


# ---------------------------------------------------------------------------
# on ranks
# ---------------------------------------------------------------------------

def _bitwise(a, b) -> bool:
    la, lb = ST.tree_leaves(a), ST.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("case,local", [("S2 1f1b ticks", "1f1b ticks"),
                                        ("S2 zb-h1 stream", "zb-h1 stream")])
def test_two_ranks_are_in_process_bitwise(runs, case, local):
    """Each replica's 2-rank stage group, a bare group: the loss and
    every gradient share bit for bit the in-process step's rows."""
    want = runs["local"][local]
    plan = ST.plan_stages(W.config(2))
    for r in runs["ranks"]:
        s = r["grid"]["d2_stage"]
        got = r[case]
        assert torch.equal(got["loss"], want["loss"]), case
        assert _bitwise(got["grads"], ST.stage_share(want["grads"], plan, s))
        assert got["stats"]["hop"][0] > 0


def test_two_ranks_serve_is_in_process_bitwise(runs):
    """The V 2 serve on 2 ranks (each rank's handoff re-folding its own
    share of both cache subtrees): every step's logits bit for bit the
    in-process V 2 serve's."""
    want = runs["local"]["serve V2"]
    for r in runs["ranks"]:
        got = r["S2 serve V2"]
        assert all(torch.equal(a, b) for a, b in zip(got["logits"],
                                                     want["logits"]))
        assert got["len"].tolist() == want["len"].tolist()


def test_data2_matches_data1(runs):
    """Data 2 x stages 2: the replicas' gradients bit for bit alike, the
    whole batch's loss within 1e-6 of the in-process data-1 loss, the
    gradients at the harness's bar; serving at data 2 (each replica's 2
    rows of k/v and of the SSM state) gives the in-process data-1 serve's
    logits bit for bit (the same 2-row micro-batches)."""
    ranks = runs["ranks"]
    plan = ST.plan_stages(W.config(2))
    for s in range(2):
        a, b = ranks[s]["data2 1f1b"], ranks[2 + s]["data2 1f1b"]
        assert _bitwise(a["grads"], b["grads"])
        assert a["stats"]["grad_sync"][0] > 0
    loss = float(ranks[0]["data2 1f1b"]["loss"])
    want = float(runs["local"]["1f1b ticks"]["loss"])
    assert abs(loss - want) <= 1e-6 * want
    full = convert.from_rank_shares(
        [[ranks[s]["data2 1f1b"]["grads"]] for s in range(2)], W.config(2),
        plan)
    full["layers"] = jax.tree.map(
        lambda a: np.asarray(ST.unstack_chunks(a, plan))[:W.L],
        full["layers"])
    _check_grads(loss, full, runs["jax"], "data2")
    ref = runs["local"]["serve V1"]
    for r in ranks:
        got = r["data2 serve"]
        assert got["shapes"]["kv/k"][1] == W.B // 2
        assert got["shapes"]["kv/len"][-1] == W.B
        assert got["shapes"]["ssm/state"][1] == W.B // 2
        assert all(torch.equal(a, b) for a, b in zip(got["logits"],
                                                     ref["logits"]))


@pytest.mark.parametrize("runtime", ["ticks", "stream"])
def test_tensor2_matches_jax(runs, runtime):
    """Stages 2 x tensor 2: the harness's bar against ``loss_fn`` /
    ``jax.grad`` on the whole tree (an SSM input entering through
    ``copy_to_tensor`` doubles the gradient of everything below it:
    relative errors ~1); every ``ssm`` leaf (replicated over tensor)
    gets bitwise the same gradient on both shards of a stage; the
    attention and MLP leaves are cut in two."""
    case = f"tensor 1f1b {runtime}"
    ranks = runs["ranks"]
    cfg = W.config(2, 2)
    plan = ST.plan_stages(cfg)
    shares = [[ranks[s * 2 + t][case]["grads"] for t in range(2)]
              for s in range(2)]
    for s in range(2):
        a, b = (sh["layers"]["ssm"] for sh in shares[s])
        assert ST.leaf_paths(a) == ST.leaf_paths(b)
        assert all(torch.equal(x, y) for x, y in zip(ST.tree_leaves(a),
                                                     ST.tree_leaves(b)))
        assert shares[s][0]["layers"]["attn"]["wq"].shape[-1] == 2 * 64
    full = convert.from_rank_shares(shares, cfg, plan)
    full["layers"] = jax.tree.map(
        lambda a: np.asarray(ST.unstack_chunks(a, plan))[:W.L],
        full["layers"])
    _check_grads(ranks[0][case]["loss"], full, runs["jax"], case)
    assert all(r[case]["stats"]["tensor"][0] > 0 for r in ranks)


def test_tensor2_serve_matches_jax(runs):
    """Serving at stages 2 x tensor 2: each shard's cache holds 2 of the
    4 kv heads and all 16 SSM heads; every step's logits on every rank
    within 2e-4 of the JAX forward over the tokens fed."""
    ranks = runs["ranks"]
    got = ranks[0]["tensor serve"]
    nh = W.config().ssm.n_heads(W.config().d_model)
    for r in ranks:
        assert r["tensor serve"]["shapes"]["kv/k"][-2] == 2
        assert r["tensor serve"]["shapes"]["ssm/state"][-3] == nh
        assert all(torch.equal(a, b) for a, b in zip(
            r["tensor serve"]["tokens"], got["tokens"]))
    want = _jax_logits(runs["weights"], got["tokens"])
    for k, lg in enumerate(got["logits"]):
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   want[:, W.PROMPT - 1 + k], atol=TOL,
                                   rtol=TOL)


# ---------------------------------------------------------------------------
# checkpoints, the planner, the CLIs
# ---------------------------------------------------------------------------

def _jax_state(weights: dict) -> dict:
    """A training state of the reduced hymba at 2 stages as the JAX
    package holds it: the weights stacked by its ``_stack_chunks`` and
    its ``AdamW.init`` moments, numpy leaves."""
    plan = JST.plan_stages(_jcfg(2))
    params = dict(weights, layers=jax.tree.map(
        lambda a: np.asarray(JST._stack_chunks(
            np.concatenate([a, a[-1:]]), plan)), weights["layers"]))
    opt = dict(JAdamW().init(params), step=jnp.asarray(5, jnp.int32))
    return jax.tree.map(np.asarray, dict(params=params, opt=opt))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def test_checkpoints_cross_both_ways(tmp_path, weights):
    """A JAX checkpoint of hymba's state restores in the port bit for
    bit (``ssm`` leaves beside ``attn``); the port's save of it has the
    JAX save's ``.meta`` bytes and restores in the JAX package bit for
    bit."""
    ref = _jax_state(weights)
    plan = ST.plan_stages(W.config(2))
    extra = dict(layout=layout_dict(plan, W.L), arch="hymba-1.5b")
    JC.save_checkpoint(str(tmp_path / "j"), ref, step=5, extra=extra)
    like = convert.from_jax(ref, device="cpu")
    got = convert.to_jax(restore_checkpoint(str(tmp_path / "j"), like,
                                            device="cpu"))
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert "ssm" in got["params"]["layers"] and "attn" in got["params"][
        "layers"]
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
    """Hymba's state resharded from 2 stages to 1 stage of V 2: the
    port's file byte-equal to the JAX package's."""
    ref = _jax_state(weights)
    pa, pb = ST.plan_stages(W.config(2)), ST.plan_stages(W.config(1, V=2))
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
        assert any("ssm" in k for k in x.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def _plan_fields(p) -> tuple:
    return dataclasses.astuple(p)


def test_planner_plans_hymba_as_jax():
    """hymba-1.5b at full width: ``auto_plan`` over 4 H100s and
    ``auto_plan3d`` over a pool of 4 pick the JAX planner's plans (its
    SSM keeps tensor at 1), and the train CLI's ``--auto-plan`` on the
    reduced model adopts the JAX explorer's plan and trains."""
    cfg, jcfg = get_config("hymba-1.5b"), jax_get_config("hymba-1.5b")
    kw = dict(global_batch=8, seq_len=1024, model_axis=4, data_axis=1)
    a = TA.auto_plan(cfg, device=TH.H100, **kw)
    b = JA.auto_plan(jcfg, device=JH100, **kw)
    assert _plan_fields(a) == _plan_fields(b) and a.tensor == 1
    a3 = TA.auto_plan3d(cfg, device=TH.H100, global_batch=8, seq_len=1024,
                        n_devices=4)
    b3 = JA.auto_plan3d(jcfg, device=JH100, global_batch=8, seq_len=1024,
                        n_devices=4)
    assert _plan_fields(a3) == _plan_fields(b3)
    out = ttrain.main(["--arch", "hymba-1.5b", "--reduced", "--layers", "3",
                       "--batch", "8", "--seq", "32", "--steps", "2",
                       "--device", "cpu", "--stages", "2", "--auto-plan",
                       "--cluster", "h100,h100"])
    jred = dataclasses.replace(jcfg.reduced(n_layers=3, seq=32), stages=2)
    want = JA.auto_plan(jred, global_batch=8, seq_len=32, model_axis=2,
                        data_axis=1, devices=[JH100] * 2)
    fields = lambda p: (p.stages, p.tensor, p.n_microbatches, p.schedule,
                        p.virtual, p.data_axis, p.predicted_step_time)
    assert fields(out["plan"]) == fields(want)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


def test_serve_cli_v2_is_v1():
    """``launch.serve --arch hymba-1.5b --reduced`` at ``--virtual 2``
    generates the V 1 run's tokens (the handoff re-folds both cache
    subtrees); the CPU launches no kernel."""
    argv = ["--arch", "hymba-1.5b", "--reduced", "--stages", "2",
            "--microbatches", "2", "--batch", "4", "--prompt-len", "32",
            "--gen", "8", "--device", "cpu"]
    v1 = tserve.main(argv)
    v2 = tserve.main(argv + ["--virtual", "2"])
    assert torch.equal(v1["tokens"], v2["tokens"])
    assert all(v == 0 for v in v1["launches"].values())


def test_train_cli_resumes_bitwise(tmp_path):
    """``launch.train --arch hymba-1.5b --reduced``: a run that saves at
    step 2 and dies after step 3, resumed from its file, ends with the
    uninterrupted run's losses bit for bit."""
    argv = ["--arch", "hymba-1.5b", "--reduced", "--layers", "3",
            "--stages", "2", "--microbatches", "2", "--batch", "4", "--seq",
            "32", "--steps", "4", "--log-every", "100", "--device", "cpu"]
    ref = ttrain.main(argv)
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit):
        ttrain.main(argv + ["--ckpt", ck, "--ckpt-every", "2", "--die-at",
                            "3"])
    out = ttrain.main(argv + ["--resume", ck])
    assert out["losses"] == ref["losses"][2:]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["n_valid", "engine"])
def test_continuous_batching_is_refused(what):
    """Continuous batching stays attention-family only: per-slot
    ``n_valid`` and the engine refuse a hybrid model (padding columns
    would pollute its recurrent SSM state)."""
    cfg = W.config(1)
    plan = ST.plan_stages(cfg)
    step = RT.make_serve_step(cfg, plan, RT.PipelineConfig(n_microbatches=1),
                              q_len=4)
    params = ST.init_stacked_params(cfg, 0, plan, device="cpu")
    cache = RT.init_pipeline_cache(cfg, plan, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="hybrid"):
        if what == "n_valid":
            step(params, cache, dict(tokens=torch.zeros(2, 4,
                                                        dtype=torch.long),
                                     n_valid=torch.tensor([4, 1])))
        else:
            SS.ContinuousEngine(cfg, step, params, cache, 2, 4)


def test_tensor_degree_must_divide_the_heads():
    """A tensor degree that does not divide the attention heads raises a
    ValueError before any group is set up (hymba-1.5b's 25 heads split
    over 1, 5 or 25; the reduced model's 4 not over 3); the SSM family,
    with no heads to split, keeps any degree."""
    full = get_config("hymba-1.5b")
    for t in (2, 3, 4):
        with pytest.raises(ValueError, match="25 attention heads"):
            with_tensor(full, t)
    assert with_tensor(full, 5).tensor == 5
    assert with_tensor(get_config("mamba2-2.7b"), 2).tensor == 2
    for cli in (ttrain, tserve):
        with pytest.raises(ValueError, match="4 attention heads"):
            cli.main(["--arch", "hymba-1.5b", "--reduced", "--tensor", "3",
                      "--device", "cpu"])
