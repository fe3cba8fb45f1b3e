"""The tensor axis of the port: Megatron tensor parallelism on a (data,
stage, tensor) grid of ranks, against the JAX package, on the CPU.

One world of 4 gloo ranks is spawned once for the module
(:func:`repro_torch.launch.mesh.spawn_ranks`, one torch thread a rank) and
runs every rank case (``tests/_torch_tensor_worker.py``) on three grids of
it (stages 2 x tensor 2, stages 1 x tensor 4, data 2 x stages 1 x tensor
2) while this process computes the JAX references.  The models are
reduced (4 layers, d_model 64; batch 4, seq 32): llama3.2-1b (tied, kv
heads sharded), gemma3-1b (window, qk-norm, one kv head: replicated over
tensor 4 and sliced), qwen3-1.7b (qk-norm, untied, a vocab of 600 that
``padded_vocab(4)`` pads to 1024), mamba2-2.7b (tied, its SSM blocks
replicated over tensor 2, the tables vocab-parallel).  The weights are numpy, drawn once
(at tensor 1) and handed to both packages.  The bars are the harness's
(``tests/harness_pipe.py:96-109``): loss 1e-4, layer gradients 1e-4
relative, the embedding 1e-4 (max |g| + 1), against ``loss_fn`` /
``jax.grad`` on the whole, unsharded tree (the tables cut to the vocab:
the JAX model masks no pad rows outside its tensor path); serving logits
2e-4.

Without spawning: the sharding rule against the JAX package's
``param_specs`` for every ported config, ``tensor_share`` /
``tensor_gather``, the grid's rank order against the JAX mesh's, and the
in-process refusals.
"""
import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models import model as JM
from repro.optim import adamw as JOPT
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import mesh as MESH
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

import _torch_tensor_worker as W

TOL = 2e-4          # serving logits, as tests/test_torch_serve.py


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _weights() -> dict:
    """Numpy weights of each reduced model at tensor 1, layers unstaged
    [L, ...]: the port's generator (seed 5; tables of padded_vocab(1)
    rows), and for the optimizer case the JAX package's
    (``PRNGKey(0)``, as tests/test_torch_train.py draws them)."""
    out = {}
    for name in W.MODELS:
        cfg = W.config(name)
        if name == "llama kv2":
            jcfg = _jax_cfg(name)
            p = jax.tree.map(np.asarray, JST.init_stacked_params(
                jcfg, jax.random.PRNGKey(0), JST.plan_stages(jcfg)))
        else:
            p = convert.to_jax(ST.init_stacked_params(
                cfg, 5, ST.plan_stages(cfg), device="cpu"))
        out[name] = dict(p, layers=jax.tree.map(lambda a: a[0], p["layers"]))
    return out


def _jax_cfg(name: str):
    cfg = W.config(name)
    jcfg = jax_get_config(cfg.arch_id).reduced(n_layers=4, d_model=64,
                                               seq=W.SEQ)
    return dataclasses.replace(jcfg, stages=1, tensor=1, vocab=cfg.vocab,
                               n_kv_heads=cfg.n_kv_heads,
                               tie_embeddings=cfg.tie_embeddings)


def _jax_tree(w: dict, vocab: int) -> dict:
    """The weights with the tables cut to the vocab."""
    return dict(w, **{k: w[k][:vocab] for k in ("embed", "head") if k in w})


def _jax_refs(weights: dict) -> dict:
    """The JAX loss and gradients of each model on the step-0 batch and
    a 3-step AdamW loop of the optimizer case's."""
    out = {}
    for name in W.MODELS:
        jcfg = _jax_cfg(name)
        tree = _jax_tree(weights[name], jcfg.vocab)
        vg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(jcfg, p, b)))
        if name != "llama kv2":
            data = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=W.SEQ,
                                  global_batch=W.B, seed=0)
            loss, grads = vg(tree, data.batch(0))
            out[name] = dict(loss=float(loss),
                             grads=jax.tree.map(np.asarray, grads))
        else:
            data = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=W.ADAM_SEQ,
                                  global_batch=W.B, seed=0)
            opt = JOPT.AdamW(lr=JOPT.warmup_cosine(W.LR, 20, W.STEPS),
                             weight_decay=0.01)
            p, st, losses = tree, opt.init(tree), []
            for step in range(W.STEPS):
                loss, g = vg(p, data.batch(step))
                p, st = opt.update(p, g, st)
                losses.append(float(loss))
            out["adamw"] = dict(losses=losses, params=jax.tree.map(
                np.asarray, p), m=jax.tree.map(np.asarray, st["m"]),
                v=jax.tree.map(np.asarray, st["v"]))
    return out


def _port_t1_loss(weights: dict) -> float:
    """The port's in-process tensor-1 loss of the llama case (1f1b)."""
    cfg = W.config("llama", 2, 1)
    plan = ST.plan_stages(cfg)
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=2, schedule="1f1b"))
    params = convert.from_jax(W.stacked_np(weights["llama"], plan),
                              device="cpu")
    return float(step(params, W.batch(cfg))[0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The host-side replays and comparisons on one torch thread, as the
    ranks run (several test workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """The world-4 spawn's per-rank results, the weights and the
    references (computed here while the ranks run)."""
    weights = _weights()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(MESH.spawn_ranks, W.run_cases, 4, "gloo", weights,
                          tensor=2)
        ref = _jax_refs(weights)
        t1 = _port_t1_loss(weights)
        ranks = fut.result()
    return dict(ranks=ranks, weights=weights, jax=ref, t1_loss=t1)


def _shares(ranks: list, case: str, S: int, T: int, key: str = "grads"):
    """``shares[s][t]`` of replica 0 (global rank ``s * T + t``)."""
    return [[ranks[s * T + t][case][key] for t in range(T)]
            for s in range(S)]


def _check_jax(ranks: list, case: str, name: str, ref: dict, S: int,
               T: int, V: int = 1):
    """One case at the harness's bar against the JAX loss and gradients
    of the whole tree; a table's rows past the vocab get no gradient."""
    cfg = W.config(name, S, T, V)
    plan = ST.plan_stages(cfg)
    for r in ranks[:S * T]:
        assert abs(float(r[case]["loss"]) - ref["loss"]) < 1e-4, case
    full = convert.from_rank_shares(_shares(ranks, case, S, T), cfg, plan)
    layers = jax.tree.map(lambda a: ST.unstack_chunks(a, plan),
                          full["layers"])
    errs = jax.tree.map(_rel, layers, ref["grads"]["layers"])
    assert max(jax.tree.leaves(errs)) < 1e-4, (case, errs)
    V_ = cfg.vocab
    want = ref["grads"]["embed"]
    embeds = [full["embed"]]
    if cfg.tie_embeddings and S > 1:     # the last stage's copy
        embeds.append(convert.from_rank_shares(
            _shares(ranks, case, S, T)[-1:], cfg,
            dataclasses.replace(plan, n_stages=1))["embed"])
    for e in embeds:
        assert e.shape[0] == cfg.padded_vocab(T)
        assert np.abs(e[:V_] - want).max() < 1e-4 * (np.abs(want).max() + 1)
        assert not e[V_:].any(), case
    assert _rel(full["final_norm"], ref["grads"]["final_norm"]) < 1e-4
    if not cfg.tie_embeddings:
        assert _rel(full["head"][:V_], ref["grads"]["head"]) < 1e-4
        assert not full["head"][V_:].any()


@pytest.mark.parametrize("runtime", ["ticks", "stream"])
@pytest.mark.parametrize("sched", W.BUILDERS)
def test_llama_stages2_tensor2_matches_jax(runs, sched, runtime):
    """Stages 2 x tensor 2 under every builder of the harness's list
    (the interleaved two at V 2), ticks and stream: the harness's bar
    against ``loss_fn`` / ``jax.grad``; the loss within 1e-6 relative of
    the port's in-process tensor-1 loss; every shard's loss the same."""
    case = f"llama {sched} {runtime}"
    V, _ = W.builder_case(sched)
    _check_jax(runs["ranks"], case, "llama", runs["jax"]["llama"], 2, 2, V)
    losses = {float(r[case]["loss"]) for r in runs["ranks"]}
    assert len(losses) == 1
    assert abs(losses.pop() - runs["t1_loss"]) <= 1e-6 * runs["t1_loss"]
    assert all(r[case]["tensor"][0] > 0 for r in runs["ranks"])


def test_gemma3_tensor4_slices_replicated_kv(runs):
    """gemma3 (one kv head) at stages 1 x tensor 4: ``wk``/``wv`` are
    replicated on every shard, each shard slices the kv head its query
    head reads; their gradients, summed over the shards, are the same on
    every shard and meet the harness's bar, as the whole case does."""
    ranks = runs["ranks"]
    _check_jax(ranks, "gemma3 1f1b ticks", "gemma3", runs["jax"]["gemma3"],
               1, 4)
    cfg = W.config("gemma3")
    for key in ("wk", "wv", "q_norm", "k_norm"):
        gs = [r["gemma3 1f1b ticks"]["grads"]["layers"]["attn"][key]
              for r in ranks]
        assert gs[0].shape[-1] == (cfg.resolved_head_dim
                                   if key.endswith("norm") else
                                   cfg.n_kv_heads * cfg.resolved_head_dim)
        assert all(torch.equal(g, gs[0]) for g in gs), key


@pytest.mark.parametrize("case", ["qwen3 1f1b ticks", "qwen3 zb-h1 stream"])
def test_qwen3_tensor4_pads_the_vocab(runs, case):
    """qwen3 (untied, vocab 600) at stages 1 x tensor 4: the tables hold
    ``padded_vocab(4)`` = 1024 rows, 256 a shard (shard 3 only pad rows);
    the pad columns are masked, so the loss and gradients meet the
    harness's bar against the JAX model over the 600 real rows, and the
    pad rows get no gradient."""
    ranks = runs["ranks"]
    for r in ranks:
        for key in ("embed", "head"):
            assert r[case]["grads"][key].shape[0] == 256
    _check_jax(ranks, case, "qwen3", runs["jax"]["qwen3"], 1, 4)


@pytest.mark.parametrize("runtime", ["ticks", "stream"])
def test_mamba2_stages2_tensor2_matches_jax(runs, runtime):
    """mamba2 at stages 2 x tensor 2 (the JAX package's layout at tensor
    2: the SSM replicated, the tied tables vocab-parallel): the harness's
    bar against ``loss_fn`` / ``jax.grad``, the tables' shards and both
    of the tied copies included; every SSM leaf's gradient the same on
    both shards of a stage (its input and cotangent are replicated)."""
    case = f"mamba2 1f1b {runtime}"
    ranks = runs["ranks"]
    _check_jax(ranks, case, "mamba2", runs["jax"]["mamba2"], 2, 2)
    for s in range(2):
        a, b = (ranks[s * 2 + t][case]["grads"]["layers"] for t in (0, 1))
        assert ST.leaf_paths(a) == ST.leaf_paths(b)
        for x, y in zip(ST.tree_leaves(a), ST.tree_leaves(b)):
            assert torch.equal(x, y), (case, s)
    for r in ranks:
        assert r[case]["grads"]["embed"].shape[0] == 512
        assert r[case]["tensor"][0] > 0


def test_data2_tensor2_overlap_matches_jax(runs):
    """Data 2 x stages 1 x tensor 2 under ``grad_sync='overlap'``: the
    whole batch's loss and gradients (each replica's shards) at the
    harness's bar; the replicas hold the same gradients."""
    ranks = runs["ranks"]
    _check_jax(ranks, "data2", "llama", runs["jax"]["llama"], 1, 2)
    for t in range(2):
        a, b = ranks[t]["data2"], ranks[2 + t]["data2"]
        assert all(torch.equal(x, y) for x, y in zip(
            ST.tree_leaves(a["grads"]), ST.tree_leaves(b["grads"])))
        assert a["grad_sync"][0] > 0


def test_adamw_over_shards_matches_jax_loop(runs):
    """Three AdamW steps at stages 2 x tensor 2 (the clip norm's terms
    summed over the shards; tests/test_torch_train.py's model and
    batches): losses within 1e-4, the parameters and moments gathered
    back within 1e-5 relative of the JAX loop's."""
    ranks, want = runs["ranks"], runs["jax"]["adamw"]
    np.testing.assert_allclose(ranks[0]["adamw"]["losses"], want["losses"],
                               rtol=0, atol=1e-4)
    cfg = W.config("llama kv2", 2, 2)
    plan = ST.plan_stages(cfg)
    for key in ("params", "m", "v"):
        full = convert.from_rank_shares(
            [[ranks[s * 2 + t]["adamw"][key] for t in range(2)]
             for s in range(2)], cfg, plan)
        full["layers"] = jax.tree.map(lambda a: ST.unstack_chunks(a, plan),
                                      full["layers"])
        for a, b in zip(jax.tree.leaves(full), jax.tree.leaves(want[key])):
            assert _rel(a, b) < 1e-5, key


def _jax_logits(runs, name: str, tokens: list) -> np.ndarray:
    jcfg = _jax_cfg(name)
    tree = _jax_tree(runs["weights"][name], jcfg.vocab)
    seq = np.concatenate([t.numpy() for t in tokens[:-1]], axis=1)
    x, _, _ = JM.forward(jcfg, tree, dict(tokens=seq))
    return np.asarray(x @ tree.get("head", tree["embed"]).T)


@pytest.mark.parametrize("case,name,kv", [
    ("serve llama V1", "llama", 2), ("serve llama V2", "llama", 2),
    ("serve gemma3", "gemma3", 1)])
def test_serve_tensor_matches_jax(runs, case, name, kv):
    """Serving at stages 2 x tensor 2 (V 1, and V 2 with each shard's
    handoff) and gemma3 at stages 1 x tensor 4 (one kv slot a shard, the
    kv head replicated): every step's logits on every rank (the vocab
    shards gathered in shard order) within 2e-4 of the JAX model's
    forward over the prompt and the tokens fed; every rank the same
    tokens; each rank's cache holds its shard's kv heads."""
    ranks = runs["ranks"]
    got = ranks[0][case]
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r[case]["tokens"],
                                                     got["tokens"]))
    for r in ranks:
        assert r[case]["k_shape"][-2] == kv
    want = _jax_logits(runs, name, got["tokens"])
    vocab = _jax_cfg(name).vocab
    for k, lg in enumerate(got["logits"]):
        np.testing.assert_allclose(lg[:, 0, :vocab].numpy(),
                                   want[:, W.PROMPT - 1 + k], atol=TOL,
                                   rtol=TOL)
    assert all(r[case]["transport"]["tensor"][0] > 0 for r in ranks)


def test_engine_at_tensor2_is_tensor1s(runs):
    """``ContinuousEngine`` over the stages 2 x tensor 2 step retires the
    requests of the in-process tensor-1 engine, token for token, in as
    many steps."""
    want = runs["ranks"][0]["ref engine"]
    for r in runs["ranks"]:
        assert r["engine"] == want


def test_train_cli_tensor2(runs):
    """``train.main([... "--tensor", "2"], mesh=...)``: the in-process
    ``--tensor 1`` CLI's losses within 1e-5 relative over three AdamW
    steps."""
    want = runs["ranks"][1]["ref train cli"]["losses"]
    for r in runs["ranks"]:
        got = r["train cli"]["losses"]
        assert r["train cli"]["tensor"] == 2
        assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) < 1e-5


def test_serve_cli_tensor2(runs):
    """``serve.main([... "--tensor", "2"], mesh=...)``: the in-process
    ``--tensor 1`` CLI's tokens, every step's logits within 2e-4; the
    transport counts the tensor group's collectives."""
    want = runs["ranks"][1]["ref serve cli"]
    for r in runs["ranks"]:
        got = r["serve cli"]
        assert torch.equal(got["tokens"], want["tokens"])
        for a, b in zip(got["logits"], want["logits"]):
            torch.testing.assert_close(a[..., :1024], b[..., :1024],
                                       atol=TOL, rtol=TOL)
        assert all(t["decode"]["tensor"][0] > 0 for t in got["transport"])


def test_mamba2_cli_tensor2_replicates_the_ssm(runs):
    """The train CLI's plumbing for mamba2 at ``--tensor 2 --stages 2``:
    the losses those of the in-process ``--tensor 1`` run within 1e-5
    relative (the gradients are held against the JAX package's by
    :func:`test_mamba2_stages2_tensor2_matches_jax`)."""
    want = runs["ranks"][2]["ref mamba cli"]["losses"]
    for r in runs["ranks"]:
        got = r["mamba cli"]["losses"]
        assert len(got) == len(want) == 2
        assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) < 1e-5


def test_auto_plan_tensor_plan_trains(runs):
    """The homogeneous ``--auto-plan`` at ``--stages 4`` plans stages 1 x
    tensor 4; on a tensor-4 grid of the same world it trains, with the
    losses of the in-process tensor-1 run of the same stages,
    micro-batches and schedule within 1e-5 relative."""
    want = runs["ranks"][3]["ref plan cli"]["losses"]
    for r in runs["ranks"]:
        plan = r["plan cli"]["plan"]
        assert (plan.stages, plan.tensor, plan.data_axis) == (1, 4, 1)
        got = r["plan cli"]["losses"]
        assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) < 1e-5


def test_grids_are_the_mesh_order(runs):
    """Each rank's groups on the three grids are those of
    ``mesh.grid_ranks``: global rank ``(d * S + s) * T + t``."""
    for name, (D, S, T) in (("S2T2", (1, 2, 2)), ("S1T4", (1, 1, 4)),
                            ("D2T2", (2, 1, 2))):
        ranks = MESH.grid_ranks(D, S, T)
        for r, res in enumerate(runs["ranks"]):
            g = res["grid"][name]
            assert g["rank"] == r
            assert (g["data_rank"], g["stage"], g["tensor_rank"]) == (
                r // (S * T), r // T % S, r % T)
            for kind in ("stage", "data", "tensor"):
                assert list(g[f"{kind}_ranks"]) in ranks[kind], (name, kind)
                assert r in g[f"{kind}_ranks"]


# ---------------------------------------------------------------------------
# without spawning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tensor", [2, 4])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-1b", "qwen3-1.7b",
                                  "mamba2-2.7b"])
def test_sharding_rule_is_param_specs(arch, tensor):
    """For every ported config and every leaf, ``stage.tensor_dim``
    names the dim the JAX package's ``param_specs`` shards over
    ``tensor`` (or none), on the stacked tree's shapes."""
    jcfg = dataclasses.replace(jax_get_config(arch), tensor=tensor)
    plan = JST.plan_stages(jcfg, n_stages=2)
    shapes = jax.eval_shape(lambda k: JST.init_stacked_params(jcfg, k, plan),
                            jax.random.PRNGKey(0))
    specs = JST.param_specs(jcfg, shapes, tensor_size=tensor)
    cfg = dataclasses.replace(get_config(arch), tensor=tensor)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert flat
    for path, spec in flat:
        keys = tuple(p.key for p in path)
        nd = len(_leaf(shapes, keys).shape)
        want = next((i - nd for i, a in enumerate(spec) if a == "tensor"),
                    None)
        assert ST.tensor_dim(keys, cfg, tensor) == want, keys


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name,T", [("qwen3", 4), ("gemma3", 4),
                                    ("llama", 2)])
def test_tensor_share_and_gather_round_trip(name, T):
    """``tensor_share`` of a tensor-1 tree, then ``tensor_gather``, gives
    the tree back (the tables padded with zero rows up to
    ``padded_vocab(T)``); ``init_stage_params(tensor_rank=t)`` is shard
    t's share of stage s's rows of the tensor-1 draws, bit for bit."""
    cfg1 = W.config(name, 2, 1)
    cfg = dataclasses.replace(cfg1, tensor=T)
    plan1, plan = ST.plan_stages(cfg1), ST.plan_stages(cfg)
    full = ST.init_stacked_params(cfg1, 2, plan1, device="cpu")
    shares = [ST.tensor_share(full, cfg, plan, t) for t in range(T)]
    back = ST.tensor_gather(shares, cfg, plan)
    for path, a in zip(ST.leaf_paths(full), ST.tree_leaves(full)):
        b = back
        for k in path:
            b = b[k]
        assert torch.equal(b[:a.shape[0]], a), path
        assert not b[a.shape[0]:].any()
        if path[0] in ("embed", "head"):
            assert b.shape[0] == cfg.padded_vocab(T)
    for s in range(2):
        for t in range(T):
            got = ST.init_stage_params(cfg, 2, plan, s, tensor_rank=t,
                                       device="cpu")
            want = ST.tensor_share(ST.stage_share(full, plan, s), cfg, plan,
                                   t)
            assert sorted(ST.leaf_paths(got)) == sorted(ST.leaf_paths(want))
            for path in ST.leaf_paths(got):
                assert torch.equal(_leaf(got, path), _leaf(want, path)), \
                    (s, t, path)


def test_grid_ranks_are_the_jax_mesh_order():
    """The groups of ``grid_ranks`` are the lines of the JAX mesh's
    ``("data", "stage", "tensor")`` device array (devices in rank order)
    along each axis; at tensor 1 the stage, data and tied groups are the
    (data, stage) grid's: ranks ``d * S + s``."""
    for D, S, T in ((1, 2, 2), (2, 2, 2), (1, 1, 4), (2, 3, 1), (1, 4, 1),
                    (2, 1, 2), (1, 3, 2)):
        mesh = np.arange(D * S * T).reshape(D, S, T)
        g = MESH.grid_ranks(D, S, T)
        lines = lambda ax: sorted(np.moveaxis(mesh, ax, -1).reshape(
            -1, mesh.shape[ax]).tolist())
        assert sorted(g["stage"]) == lines(1)
        assert sorted(g["data"]) == lines(0)
        assert sorted(g["tensor"]) == lines(2)
        assert g["tie"] == ([[int(mesh[d, 0, t]), int(mesh[d, S - 1, t])]
                             for d in range(D) for t in range(T)]
                            if S > 2 else [])
        if T == 1:
            assert g["stage"] == [list(range(d * S, (d + 1) * S))
                                  for d in range(D)]
            assert g["data"] == [list(range(s, D * S, S)) for s in range(S)]


@pytest.fixture
def no_allocation(monkeypatch):
    """Any model set-up after the refusal point fails the test loudly."""
    def boom(*a, **k):
        raise AssertionError("allocated before refusing")
    for mod, name in ((ST, "init_stacked_params"), (ST, "init_stage_params"),
                      (RT, "init_pipeline_cache"), (RT, "init_stage_cache")):
        monkeypatch.setattr(mod, name, boom)


def test_tensor_in_one_process_raises_before_allocation(no_allocation):
    """In one process tensor > 1 raises a ValueError naming the world it
    needs (data x stages x tensor processes), in the step factories and
    in both CLIs, before anything is allocated."""
    cfg = W.config("llama", 2, 2)
    plan = ST.plan_stages(cfg)
    match = "tensor 2 = 4 processes on a \\(data, stage, tensor\\) grid"
    for call in (lambda: RT.make_train_step(cfg, plan, RT.PipelineConfig()),
                 lambda: RT.make_serve_step(cfg, plan, RT.PipelineConfig()),
                 lambda: ttrain.main(W.TRAIN_CLI + ["--tensor", "2"]),
                 lambda: tserve.main(W.SERVE_CLI + ["--tensor", "2"])):
        with pytest.raises(ValueError, match=match):
            call()
    with pytest.raises(ValueError, match="data 2 x 2 stages x tensor 2 = 8"):
        ttrain.main(W.TRAIN_CLI + ["--tensor", "2", "--data", "2"])
