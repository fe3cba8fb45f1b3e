"""The data axis of the port: the pipelined train and serve steps on a
(data, stage) grid of ranks, against the JAX package, on the CPU.

One world of 4 gloo ranks (data 2 x stages 2) is spawned once for the
module (:func:`repro_torch.launch.mesh.spawn_ranks`, one torch thread a
rank) and runs every rank case (``tests/_torch_data_worker.py``) while
this process computes the JAX references.  The model is ``llama3.2-1b``
reduced to 4 layers, d_model 128; batch 8, seq 32; the weights are
numpy, drawn once and handed to both packages through
``repro_torch.convert``.  The bars:

* every builder of the JAX harness's list (``tests/harness_pipe.py:
  336-338``; the interleaved two at V 2) under ``grad_sync='overlap'``
  is bit for bit ``'end'``'s, and at the harness's bar (loss 1e-4,
  layer gradients 1e-4, the embedding 1e-4 (max |g| + 1);
  ``harness_pipe.py:96-109``) against ``loss_fn`` / ``jax.grad`` on the
  whole batch; the two replicas hold the same gradients bit for bit;
* ``ar_groups=2`` is bit for bit one bucket's (1f1b and zb-h1);
* 2bw by the JAX harness's three checks (``harness_pipe.py:425-457``);
* serving at data 2: logits within 2e-4 of the JAX model's, greedy
  tokens equal to the port's in-process data-1 serve; one
  ``ContinuousEngine`` run equal to the in-process engine's;
* both CLIs with ``--data 2`` (and the planner's data-4 plan on a data 4
  x stages 1 grid of the same world) against their in-process runs.

Without spawning: ``add_grad_sync``, the AR tick and instruction
lowerings and ``simulate(..., grad_sync=G)`` against the JAX package's,
and the refusals that remain.
"""
import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import schedplan as JSP
from repro.core import simulator as JSIM
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models import model as JM
from repro_torch import convert
from repro_torch.core import schedplan as SP
from repro_torch.core import simulator as SIM
from repro_torch.launch import mesh as MESH
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw as OPT
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

import _torch_data_worker as W

ITEM = "tensor and data parallel over NCCL"
TOL = 2e-4          # serving logits, as tests/test_torch_serve.py


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _weights(tied: bool) -> dict:
    """Numpy weights of the reduced llama, layers unstaged [L, ...]
    (drawn by the port's generator, seed 5)."""
    cfg = W.config(1, tied=tied)
    p = convert.to_jax(ST.init_stacked_params(cfg, 5, ST.plan_stages(cfg),
                                              device="cpu"))
    return dict(p, layers=jax.tree.map(lambda a: a[0], p["layers"]))


def _jax_cfg(tied: bool):
    cfg = jax_get_config("llama3.2-1b").reduced(n_layers=4, d_model=128)
    return dataclasses.replace(cfg, stages=1, tensor=1, tie_embeddings=tied)


def _jax_train(weights: dict, tied: bool) -> dict:
    """The JAX package's non-pipelined loss and gradients on the step-0
    batch (the whole batch)."""
    jcfg = _jax_cfg(tied)
    batch = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=W.SEQ,
                           global_batch=W.B, seed=0).batch(0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b)))(weights, batch)
    return dict(loss=float(loss), grads=jax.tree.map(np.asarray, grads))


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
    """The world-4 spawn's per-rank results, the weights and the JAX
    references (computed here while the ranks run)."""
    weights = {t: _weights(t) for t in (True, False)}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(MESH.spawn_ranks, W.run_cases, 4, "gloo", weights,
                          data=2)
        ref = {t: _jax_train(weights[t], t) for t in (True, False)}
        ranks = fut.result()
    return dict(ranks=ranks, weights=weights, jax=ref)


def _bitwise(a, b) -> bool:
    la, lb = ST.tree_leaves(a), ST.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def _replica_tree(shares: list, key: str = "grads") -> dict:
    """Replica 0's full stacked tree from its two stages' shares (ranks 0
    and 1): layers ``[S, ...]``, the embedding of stage 0, the final norm
    and an untied head of stage 1."""
    s0, s1 = shares[0][key], shares[1][key]
    out = dict(layers=_stack([s0["layers"], s1["layers"]]),
               embed=s0["embed"], final_norm=s1["final_norm"])
    if "head" in s1:
        out["head"] = s1["head"]
    return out


def _stack(trees: list) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def _check_jax(ranks: list, name: str, ref: dict, tied: bool = True):
    """One case at the harness's bar against the JAX loss and gradients."""
    V, _ = W.builder_case(name.split()[0] if not name.startswith("untied")
                          else "1f1b")
    plan = ST.plan_stages(W.config(2, V, tied))
    for r in ranks:
        assert abs(float(r[name]["loss"]) - ref["loss"]) < 1e-4, name
    full = _replica_tree([r[name] for r in ranks])
    layers = jax.tree.map(
        lambda a: np.asarray(ST.unstack_chunks(torch.from_numpy(a), plan)),
        convert.to_jax(full["layers"]))
    errs = jax.tree.map(_rel, layers, ref["grads"]["layers"])
    assert max(jax.tree.leaves(errs)) < 1e-4, (name, errs)
    want = ref["grads"]["embed"]
    embs = [ranks[0][name]["grads"]["embed"]]
    if tied:
        embs.append(ranks[1][name]["grads"]["embed"])
    for e in embs:
        assert np.abs(e.numpy() - want).max() < 1e-4 * (np.abs(want).max()
                                                        + 1), name
    assert _rel(full["final_norm"].numpy(), ref["grads"]["final_norm"]) \
        < 1e-4
    if not tied:
        assert _rel(full["head"].numpy(), ref["grads"]["head"]) < 1e-4


def _check_replicas(ranks: list, name: str):
    """Both replicas of each stage hold the same loss and gradients."""
    for s in range(2):
        a, b = ranks[s][name], ranks[2 + s][name]
        assert torch.equal(a["loss"], b["loss"]), (name, s)
        assert _bitwise(a["grads"], b["grads"]), (name, s)


@pytest.mark.parametrize("name", W.BUILDERS)
def test_overlap_is_end_bitwise(runs, name):
    """``grad_sync='overlap'`` (each bucket posted at its ARSYNC slot)
    gives ``'end'``'s loss and gradients bit for bit on every rank; the
    overlap stream holds one ARSYNC a chunk, the end stream none, and
    both post V + 1 buckets (a reduce-scatter and an all-gather each)."""
    V, _ = W.builder_case(name)
    for r in runs["ranks"]:
        end, ovl = r[f"{name} end"], r[f"{name} overlap"]
        assert torch.equal(end["loss"], ovl["loss"]), name
        assert _bitwise(end["grads"], ovl["grads"]), name
        assert (end["ar_slots"], ovl["ar_slots"]) == (0, V)
        assert end["grad_sync"][0] == ovl["grad_sync"][0] == 2 * (V + 1)
        assert end["grad_sync"][1] == ovl["grad_sync"][1] > 0
    _check_replicas(runs["ranks"], f"{name} overlap")


@pytest.mark.parametrize("name", W.BUILDERS)
def test_data2_matches_jax(runs, name):
    """Data 2 x stages 2 under ``'overlap'`` at the harness's bar against
    the JAX package's ``loss_fn`` / ``jax.grad`` on the whole batch."""
    _check_jax(runs["ranks"], f"{name} overlap", runs["jax"][True])


@pytest.mark.parametrize("name", ["1f1b", "zb-h1"])
def test_ar_groups_bitwise(runs, name):
    """Two layer-group buckets a chunk: one bucket's bits, twice the
    ARSYNC slots."""
    for r in runs["ranks"]:
        one, two = r[f"{name} overlap"], r[f"{name} overlap G2"]
        assert torch.equal(one["loss"], two["loss"])
        assert _bitwise(one["grads"], two["grads"]), name
        assert two["ar_slots"] == 2 * one["ar_slots"] == 2


def test_untied_head_syncs(runs):
    """An untied head: overlap bit for bit end, at the harness's bar."""
    ranks = runs["ranks"]
    for r in ranks:
        assert _bitwise(r["untied 1f1b end"]["grads"],
                        r["untied 1f1b overlap"]["grads"])
    _check_replicas(ranks, "untied 1f1b overlap")
    _check_jax(ranks, "untied 1f1b overlap", runs["jax"][False], tied=False)


def _two_bw(runs) -> tuple:
    """2bw's per-step trees (replica 0, stacked) and the start."""
    ranks = runs["ranks"]
    steps = len(ranks[0]["2bw"]["params"])
    for s in range(2):      # the replicas step alike
        for k in range(steps):
            for key in ("params", "pending"):
                assert _bitwise(ranks[s]["2bw"][key][k],
                                ranks[2 + s]["2bw"][key][k])
    traj = [_replica_tree([{"t": r["2bw"]["params"][k]} for r in ranks[:2]],
                          "t") for k in range(steps)]
    pend = [_replica_tree([{"t": r["2bw"]["pending"][k]} for r in ranks[:2]],
                          "t") for k in range(steps)]
    plan = ST.plan_stages(W.config(2))
    start = W.stacked(runs["weights"][True], plan)
    return traj, pend, start


def test_2bw_pending_is_the_end_gradients(runs):
    """Step 0's ``pending`` is the synchronous ('end') step's gradients
    at the same parameters (within 1e-4), and step 0's loss is its."""
    _, pend, _ = _two_bw(runs)
    end = _replica_tree([r["1f1b end"] for r in runs["ranks"][:2]])
    errs = [_rel(a.numpy(), b.numpy()) for a, b in zip(
        ST.tree_leaves(pend[0]), ST.tree_leaves(end))]
    assert max(errs) < 1e-4, errs
    assert abs(float(runs["ranks"][0]["2bw"]["losses"][0])
               - float(runs["ranks"][0]["1f1b end"]["loss"])) < 1e-5


def test_2bw_replays_stale_by_one(runs):
    """A host replay of the recorded ``pending`` snapshots through AdamW
    with the one-step lag (step 0 applies its own) gives the ranks'
    parameter trajectory within 1e-6."""
    traj, pend, p = _two_bw(runs)
    opt = OPT.AdamW(lr=W.LR)
    state = opt.init(p)
    worst = 0.0
    for k in range(len(traj)):
        p, state = opt.update(p, pend[0] if k == 0 else pend[k - 1], state)
        worst = max(worst, max(_rel(a.numpy(), b.numpy()) for a, b in zip(
            ST.tree_leaves(traj[k]), ST.tree_leaves(p))))
    assert worst < 1e-6, worst


def test_2bw_fresh_replay_diverges(runs):
    """Applying each step's fresh gradients instead gives another
    trajectory: the staleness is the schedule's, not noise."""
    traj, pend, p = _two_bw(runs)
    opt = OPT.AdamW(lr=W.LR)
    state = opt.init(p)
    for k in range(len(traj)):
        p, state = opt.update(p, pend[k], state)
    assert any(float((a - b).abs().max()) > 1e-6 for a, b in zip(
        ST.tree_leaves(p), ST.tree_leaves(traj[-1])))


def test_serve_data2_matches_jax_and_data1(runs):
    """Serving at data 2 x stages 2: every step's logits on every rank
    (the whole batch, the replicas' rows in order) within 2e-4 of the JAX
    model's forward over the prompt and the tokens fed; the greedy
    tokens those of the port's in-process data-1 serve."""
    ranks = runs["ranks"]
    got, ref = ranks[0]["serve"], ranks[0]["ref serve"]
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r["serve"]["logits"],
                                                     got["logits"]))
    assert all(torch.equal(a, b) for a, b in zip(got["tokens"],
                                                 ref["tokens"]))
    jcfg = _jax_cfg(True)
    seq = np.concatenate([t.numpy() for t in got["tokens"][:-1]], axis=1)
    x, _, _ = JM.forward(jcfg, runs["weights"][True], dict(tokens=seq))
    want = np.asarray(x @ runs["weights"][True]["embed"].T)
    for k, lg in enumerate(got["logits"]):
        pos = W.PROMPT - 1 + k
        np.testing.assert_allclose(lg[:, 0, :jcfg.vocab].numpy(),
                                   want[:, pos, :jcfg.vocab], atol=TOL,
                                   rtol=TOL)
    # the logits cross the data group: one gather a step on every rank
    for r in ranks:
        assert r["serve"]["transport"]["logits"][0] >= 1


def test_engine_at_data2_is_data1s(runs):
    """``ContinuousEngine`` over the data-2 rank step retires the
    requests of the in-process data-1 engine, token for token, in as
    many steps."""
    want = runs["ranks"][1]["ref engine"]
    for r in runs["ranks"]:
        assert r["engine"] == want


def test_train_cli_data2(runs):
    """``train.main([... "--data", "2", "--runtime", "stream",
    "--grad-sync", "overlap", "--ar-groups", "2"], mesh=...)``: the
    in-process CLI's losses (the same micro-batches, M 4) within 1e-5
    relative over three AdamW steps."""
    want = runs["ranks"][2]["ref train cli"]["losses"]
    for r in runs["ranks"]:
        got = r["train cli"]["losses"]
        assert len(got) == len(want) == 3
        assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) < 1e-5


def test_serve_cli_data2(runs):
    """``serve.main([... "--data", "2"], mesh=..., keep_logits=True)``:
    the in-process CLI's tokens, every step's logits within 2e-4 of its;
    the transport counts the logits' gather."""
    want = runs["ranks"][2]["ref serve cli"]
    for r in runs["ranks"]:
        got = r["serve cli"]
        assert torch.equal(got["tokens"], want["tokens"])
        assert len(got["logits"]) == len(want["logits"]) == 4
        for a, b in zip(got["logits"], want["logits"]):
            torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
        assert all(t["decode"]["logits"][0] > 0 for t in got["transport"])


def test_grid_is_data_major(runs):
    """Global rank ``d * S + s`` runs stage s of replica d; its stage
    group holds its replica's ranks by stage, its data group its stage's
    ranks by replica."""
    for r, res in enumerate(runs["ranks"]):
        g = res["grid"]
        assert (g["rank"], g["stages"]) == (r, 2)
        assert (g["data_rank"], g["stage"]) == divmod(r, 2)
        assert g["stage_ranks"] == tuple(range(2 * g["data_rank"],
                                               2 * g["data_rank"] + 2))
        assert g["data_ranks"] == (g["stage"], g["stage"] + 2)


def test_planner_data_plan_runs(runs):
    """``--auto-plan3d --pool 4`` plans data 4 x stages 1 (tensor 1): on a
    data 4 grid of the same ranks it trains, with the losses of the
    in-process run of the same micro-batches within 1e-5 relative."""
    want = runs["ranks"][3]["ref plan cli"]["losses"]
    for r in runs["ranks"]:
        plan = r["plan cli"]["plan"]
        assert (plan.data_axis, plan.tensor, plan.stages) == (4, 1, 1)
        got = r["plan cli"]["losses"]
        assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) < 1e-5


# ---------------------------------------------------------------------------
# without spawning
# ---------------------------------------------------------------------------

def _cases(name: str):
    V = 2 if "interleaved" in name else 1
    for M, N in ((4, 2), (8, 4), (6, 3)):
        if V > 1 and name.endswith("memlean") and M % N:
            continue
        yield M, N, V, (dict(mem_limit=2) if name == "zb-auto" else {})


def _ops(plan) -> list:
    return [[(op.kind, op.m, op.v, op.device) for op in ops]
            for ops in plan.device_ops]


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("name", SP.BUILDER_NAMES)
def test_add_grad_sync_matches_jax(name, groups):
    """The AR op tables, their groups and validation: the JAX package's."""
    for M, N, V, kw in _cases(name):
        plan = SP.build_schedule(name, M, N, V, grad_sync=groups, **kw)
        jplan = JSP.build_schedule(name, M, N, V, grad_sync=groups, **kw)
        assert _ops(plan) == _ops(jplan)
        assert plan.has_grad_sync and plan.grad_sync_groups == groups
        again = SP.add_grad_sync(SP.build_schedule(name, M, N, V, **kw),
                                 groups)
        assert _ops(again) == _ops(plan)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("name", SP.BUILDER_NAMES)
def test_ar_lowering_matches_jax(name, groups):
    """``lower_to_ticks``' AR rows and ``lower_to_instructions``'
    streams, ``arsync`` and ``slot_of``: the JAX package's."""
    for M, N, V, kw in _cases(name):
        plan = SP.build_schedule(name, M, N, V, grad_sync=groups, **kw)
        jplan = JSP.build_schedule(name, M, N, V, grad_sync=groups, **kw)
        got, want = SP.lower_to_instructions(plan), \
            JSP.lower_to_instructions(jplan)
        assert dataclasses.asdict(got.ticks) == \
            dataclasses.asdict(want.ticks)
        assert [[repr(i) for i in s] for s in got.streams] == \
            [[repr(i) for i in s] for s in want.streams]
        assert got.arsync == want.arsync and sum(got.arsync) == \
            N * V * groups
        assert got.slot_of == want.slot_of


@pytest.mark.parametrize("name", SP.BUILDER_NAMES)
def test_simulate_grad_sync_matches_jax(name):
    V = 2 if "interleaved" in name else 1
    for M, N in ((4, 2), (8, 4)):
        B = [2.0 + 0.1 * n for n in range(N)]
        for gs in (True, 2):
            for ar in (None, 0.7, [0.3 * (n + 1) for n in range(N)]):
                got = SIM.simulate(name, M, N, 1.0, B, V=V, ar=ar,
                                   grad_sync=gs)
                want = JSIM.simulate(name, M, N, 1.0, B, V=V, ar=ar,
                                     grad_sync=gs)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_simulate_costs_grad_sync_matches_jax():
    costs = SP.StageCosts(F=(1.0, 1.2, 0.9), B=(1.0, 1.2, 0.9),
                          W=(1.0, 0.9, 0.9), SR=(0.1, 0.2))
    jcosts = JSP.StageCosts(**dataclasses.asdict(costs))
    for name in ("1f1b", "zb-h1"):
        for gs in (True, 2):
            got = SIM.simulate_costs(name, 6, 3, costs, ar=[0.5, 0.4, 0.3],
                                     grad_sync=gs)
            want = JSIM.simulate_costs(name, 6, 3, jcosts,
                                       ar=[0.5, 0.4, 0.3], grad_sync=gs)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_in_process_data_raises_naming_the_world():
    """Data > 1 runs only as ranks: the in-process executors and CLIs
    name the world they need (data x stages processes)."""
    cfg = W.config(2)
    plan = ST.plan_stages(cfg)
    pcfg = RT.PipelineConfig()
    for call in (lambda: RT.make_train_step(cfg, plan, pcfg, data=2),
                 lambda: RT.make_serve_step(cfg, plan, pcfg, data=2),
                 lambda: ttrain.main(W.TRAIN_CLI + ["--data", "2"]),
                 lambda: tserve.main(W.SERVE_CLI + ["--data", "2"])):
        with pytest.raises(ValueError, match="4 processes on a"):
            call()
    with pytest.raises(ValueError, match="does not split over data 3"):
        RT.init_stage_cache(cfg, plan, 0, 8, 16, data=3, device="cpu")


def test_grad_sync_knobs_raise_as_jax():
    """What the JAX runtime rejects (``runtime.py:478-495``), the port
    rejects with its words; fsdp stays refused by the item's name, and
    tensor > 1 in one process names the ranks it needs."""
    cfg = W.config(2)
    plan = ST.plan_stages(cfg)
    opt = OPT.AdamW()
    for kw, match in ((dict(grad_sync="sometimes"), "unknown grad_sync"),
                      (dict(grad_sync="overlap"), "requires runtime='stream'"),
                      (dict(grad_sync="2bw", runtime="stream"),
                       "needs an optimizer"),
                      (dict(ar_groups=0), "ar_groups must be >= 1"),
                      (dict(ar_groups=2), "OVERLAPPED AR buckets"),
                      (dict(ar_groups=2, runtime="stream", grad_sync="end"),
                       "OVERLAPPED AR buckets")):
        with pytest.raises(ValueError, match=match):
            RT.make_train_step(cfg, plan, RT.PipelineConfig(**kw))
    fsdp = dataclasses.replace(cfg, fsdp=True)
    with pytest.raises(NotImplementedError, match=ITEM):
        RT.make_train_step(fsdp, plan, RT.PipelineConfig(), optimizer=opt)
    with pytest.raises(NotImplementedError, match=ITEM):
        RT.make_serve_step(fsdp, plan, RT.PipelineConfig())
    plan2 = dataclasses.replace(plan, tensor=2)
    with pytest.raises(ValueError, match="tensor 2 = 4 processes"):
        RT.make_train_step(cfg, plan2, RT.PipelineConfig(), optimizer=opt)
    with pytest.raises(ValueError, match="tensor 2 = 4 processes"):
        RT.make_serve_step(cfg, plan2, RT.PipelineConfig())


def test_check_world_names_both_numbers():
    MESH.check_world(2, 4, 2)
    MESH.check_world(4, 4)
    for S, world, data in ((2, 4, 1), (2, 4, 3), (3, 4, 1), (2, 6, 2)):
        with pytest.raises(ValueError, match=f"data {data} x {S} stages on "
                                             f"{world} ranks"):
            MESH.check_world(S, world, data)
    with pytest.raises(ValueError, match="must equal the world size"):
        MESH.spawn_ranks(W.run_cases, 4, "gloo", {}, data=3)


@pytest.mark.parametrize("cli,flags", [
    (ttrain, ["--reduced", "--stages", "2", "--data", "3"]),
    (tserve, ["--reduced", "--stages", "2", "--data", "3"]),
    (ttrain, ["--reduced", "--stages", "2", "--tensor", "2", "--data",
              "2"])])
def test_torchrun_grid_refused_before_any_group(monkeypatch, cli, flags):
    """Under torchrun's environment (4 ranks) a grid that is not data x
    stages x tensor = world (data 2 x stages 2 x tensor 2 is 8) raises
    before any group is set up."""
    for k, v in (("WORLD_SIZE", "4"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="must equal the world size"):
        cli.main(["--arch", "llama3.2-1b", "--device", "cpu"] + flags)
    assert not torch.distributed.is_initialized()
