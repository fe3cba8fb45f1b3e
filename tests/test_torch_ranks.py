"""The rank executor (one process per pipeline stage, gloo on the CPU),
under the tick and the stream runtime, against the port's in-process
executor and the JAX package.

Each world size is spawned once (:func:`repro_torch.launch.mesh.
spawn_ranks`, a ``FileStore`` in a temporary directory): one module
fixture runs every case of that size on the ranks
(``tests/_torch_ranks_worker.py``) and on the in-process executor in a
fresh process, with one torch thread on both sides, and the tests
compare the results.  The bar against the in-process executor is bit for bit:
the loss, every gradient leaf of each rank's share, the stash count;
after three AdamW steps the losses, parameters and moments.  The 2-rank
1f1b run is held to ``loss_fn`` / ``jax.grad`` at
the harness's bar (loss 1e-4, layer gradients 1e-4;
``tests/harness_pipe.py:96-109``), numpy weights going to both packages
through ``repro_torch.convert``.  Under ``runtime='stream'`` (each rank
walking its ``lower_to_instructions`` stream) every ``SCHEDULES`` entry
at 2 ranks, three at 3, mamba2, three AdamW steps and the numpy-weights
case are held to the same in-process tick results, their hop messages
and bytes to the tick runs'; a traced zb-h2 run with rank 1 held back
shows where a stream rank waits; ``launch.train.main(["--runtime",
"stream", ...])`` on the 2 ranks gives the single-process CLI's losses.
Without spawning: the hop list against the table's consumed arrivals,
``init_stage_params`` against the stacked tree's rows, and the
refusals.  One CLI run under ``torchrun`` (2 ranks) gives the
single-process CLI's losses bit for bit.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models import model as JM
from repro_torch import convert
from repro_torch.checkpoint import CheckpointMismatch
from repro_torch.checkpoint import ckpt as CKP
from repro_torch.core import schedplan as SP
from repro_torch.launch import mesh as MESH
from repro_torch.launch import train as ttrain
from repro_torch.pipeline import comm as C
from repro_torch.pipeline import stage as ST

import _torch_ranks_worker as W
from test_torch_train import B, L, SCHEDULES, SEQ, _case, _rel, _stacked, \
    _unstacked

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spec(name, schedule, S, *, arch="llama3.2-1b", tied=True, steps=0,
          weights=None):
    """A worker case for a ``SCHEDULES`` entry at S stages."""
    pcfg, V, rows = _case(schedule, S)
    return dict(name=name, arch=arch, tied=tied, V=V, pcfg=pcfg, rows=rows,
                seq=32 if arch == "mamba2-2.7b" else SEQ, steps=steps,
                weights=weights)


def _stream(case: dict, **kw) -> dict:
    """``case`` under the stream runtime, held to ``case``'s in-process
    (tick) result."""
    return {**case, "name": case["name"] + " stream", "ref": case["name"],
            "pcfg": dataclasses.replace(case["pcfg"], runtime="stream"),
            **kw}


def _jax_cfg():
    return dataclasses.replace(
        jax_get_config("llama3.2-1b").reduced(n_layers=L, d_model=64),
        n_kv_heads=2, stages=1, tensor=1)


def _weights() -> dict:
    """Numpy weights of the reduced llama, unstaged (layers [L, ...]),
    drawn by the port's generator (seed 5: not the ranks' own seed 0)."""
    cfg = W.config("llama3.2-1b", 1)
    p = convert.to_jax(ST.init_stacked_params(cfg, 5, ST.plan_stages(cfg),
                                              device="cpu"))
    return dict(p, layers=jax.tree.map(lambda a: a[0], p["layers"]))


def _jax_loss_and_grads(weights: dict) -> dict:
    """The JAX package's non-pipelined loss and gradients on the step-0
    batch of B rows."""
    jcfg = _jax_cfg()
    batch = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=SEQ, global_batch=B,
                           seed=0).batch(0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b)))(weights, batch)
    return dict(loss=float(loss), grads=jax.tree.map(np.asarray, grads))


#: the CLI run on 2 ranks under stream against the single-process CLI
CLI = ["--arch", "llama3.2-1b", "--reduced", "--layers", "4", "--d-model",
       "64", "--stages", "2", "--microbatches", "2", "--batch", "4", "--seq",
       "16", "--steps", "3", "--device", "cpu"]
#: the traced stream run: rank 1 held back this many seconds
HOLD = 0.5


def _cases2(weights: dict):
    cases = [_spec(s, s, 2) for s in SCHEDULES]
    cases += [_spec("mamba2 1f1b", "1f1b", 2, arch="mamba2-2.7b"),
              _spec("untied 1f1b", "1f1b", 2, tied=False),
              _spec("adamw 1f1b", "1f1b", 2, steps=3),
              _spec("jax 1f1b", "1f1b", 2, weights=convert.to_jax(
                  _stacked(weights, 2)))]
    cases += [_stream(c) for c in cases if c["name"] in STREAM2]
    held = _spec("zb-h2 held", "zb-h2", 2)
    cases += [dict(held, ref="zb-h2", hold=HOLD),
              _stream(held, ref="zb-h2", hold=HOLD),
              dict(name="cli", cli=CLI, arch="llama3.2-1b", tied=True, V=1)]
    return cases


CASES3 = ("1f1b", "zb-h1", "1f1b-interleaved")
CASES1 = ("1f1b", "1f1b-interleaved")
NAMES2 = SCHEDULES + ("mamba2 1f1b", "untied 1f1b")
#: the cases that also run under the stream runtime
STREAM2 = SCHEDULES + ("mamba2 1f1b", "adamw 1f1b", "jax 1f1b")
STREAM_NAMES2 = tuple(f"{n} stream" for n in SCHEDULES + ("mamba2 1f1b",))
STREAM_NAMES3 = tuple(f"{n} stream" for n in CASES3)


@pytest.fixture(scope="module")
def runs():
    """Every case on its spawned gloo ranks (2 and 3) and on the
    in-process executor in a fresh process of its own (a 1-rank spawn),
    the three spawns at once, each in a thread that waits on its
    processes, while this process runs the JAX reference:
    ``{S: {name: (per-rank results, in-process result, stage plan)},
    "jax": the JAX loss and gradients}``.  No torch run shares this
    process's state (JAX runs here)."""
    weights = _weights()
    cases3 = [_spec(s, s, 3) for s in CASES3]
    cases = {2: _cases2(weights), 3: cases3 + [_stream(c) for c in cases3]}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        spawned = {S: pool.submit(MESH.spawn_ranks, W.run_cases, S, "gloo",
                                  cs) for S, cs in cases.items()}
        one = [_spec(s, s, 1) for s in CASES1]
        ref = pool.submit(MESH.spawn_ranks, W.in_process_cases, 1, "gloo",
                          cases, one + [_stream(one[-1])])
        out = {"jax": _jax_loss_and_grads(weights)}
        ranks = {S: f.result() for S, f in spawned.items()}
        ref = ref.result()[0]
    out["one rank"] = ref["one rank"]
    out.update({S: {c["name"]: ([r[c["name"]] for r in ranks[S]],
                                ref[S][c.get("ref", c["name"])],
                                ST.plan_stages(W.config(c["arch"], S, c["V"],
                                                        c["tied"])))
                    for c in cs}
                for S, cs in cases.items()})
    return out


@pytest.fixture(scope="module")
def world2(runs):
    return runs[2]


@pytest.fixture(scope="module")
def world3(runs):
    return runs[3]


def _assert_bitwise(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for (a, b) in zip(ST.tree_leaves(got), ST.tree_leaves(want)):
        assert a.shape == b.shape and torch.equal(a, b), what


def _check_case(res, name):
    ranks, ref, plan = res[name]
    for r, got in enumerate(ranks):
        assert torch.equal(got["loss"], ref["loss"]), (name, r)
        _assert_bitwise(got["grads"], ST.stage_share(ref["grads"], plan, r),
                        f"{name} rank {r}")
        assert got["stash"] == ref["stash"][r], (name, r)


@pytest.mark.parametrize("name", NAMES2 + STREAM_NAMES2)
def test_two_ranks_bitwise(world2, name):
    _check_case(world2, name)


@pytest.mark.parametrize("name", CASES3 + STREAM_NAMES3)
def test_three_ranks_bitwise(world3, name):
    """3 ranks pad the 4 layers to 6 slots (the interleave: 6 chunks of
    one layer)."""
    _check_case(world3, name)


@pytest.mark.parametrize("name", CASES1 + ("1f1b-interleaved stream",))
def test_one_rank_group_bitwise(runs, name):
    """A group of one rank: the whole model on the rank executor (at
    V = 2 the chunk pass wraps to the rank itself; under stream each
    message to itself is handed over as it is) gives the in-process
    step's bits."""
    got, want = runs["one rank"][name]
    V = 2 if "interleaved" in name else 1
    plan = ST.plan_stages(W.config("llama3.2-1b", 1, V))
    assert torch.equal(got["loss"], want["loss"])
    _assert_bitwise(got["grads"], ST.stage_share(want["grads"], plan, 0),
                    name)


def test_adamw_steps_bitwise(world2, name="adamw 1f1b"):
    """Three AdamW steps (1f1b, clip active): the global norm formed from
    the ranks' gathered terms gives the in-process update's bits."""
    ranks, ref, plan = world2[name]
    for r, got in enumerate(ranks):
        assert all(torch.equal(a, b) for a, b in zip(got["losses"],
                                                     ref["losses"]))
        for key in ("params", "m", "v"):
            _assert_bitwise(got[key], ST.stage_share(ref[key], plan, r),
                            f"{key} rank {r}")


def test_two_ranks_match_jax(runs, name="jax 1f1b"):
    """The slice as a whole: the 2-rank 1f1b step on numpy weights
    (through ``convert``) against the JAX package's non-pipelined
    loss_fn and jax.grad on the same weights."""
    jax_ref, ranks = runs["jax"], runs[2][name][0]
    assert abs(float(ranks[0]["loss"]) - jax_ref["loss"]) < 1e-4
    stacked = _stack_rows([r["grads"]["layers"] for r in ranks])
    got = _unstacked(convert.to_jax(stacked), 2)
    errs = jax.tree.map(lambda a, b: _rel(a[:L], b), got,
                        jax_ref["grads"]["layers"])
    assert max(jax.tree.leaves(errs)) < 1e-4, errs
    want = jax_ref["grads"]
    for r, key in ((0, "embed"), (1, "embed")):
        emb = np.abs(ranks[r]["grads"][key].numpy() - want[key]).max()
        assert emb < 1e-4 * (np.abs(want[key]).max() + 1)
    assert _rel(ranks[1]["grads"]["final_norm"].numpy(),
                want["final_norm"]) < 1e-4


def test_adamw_steps_bitwise_stream(world2):
    test_adamw_steps_bitwise(world2, "adamw 1f1b stream")


def test_two_ranks_match_jax_stream(runs):
    """The numpy-weights case under stream: at the harness's bar against
    JAX, and bit for bit against the in-process tick step."""
    test_two_ranks_match_jax(runs, "jax 1f1b stream")
    ranks, ref, plan = runs[2]["jax 1f1b stream"]
    for r, got in enumerate(ranks):
        assert torch.equal(got["loss"], ref["loss"])
        _assert_bitwise(got["grads"], ST.stage_share(ref["grads"], plan, r),
                        f"rank {r}")


@pytest.mark.parametrize("name", STREAM_NAMES2 + STREAM_NAMES3)
def test_stream_hops_are_the_tick_runs(runs, name):
    """Each rank's hop messages and bytes under stream equal the tick
    run's on the same ranks, and ``comm.ring_hops``' count (a message at
    both its ends); no rank holds more registers at once than under
    ticks."""
    S = 3 if name in STREAM_NAMES3 else 2
    stream, _, plan = runs[S][name]
    ticks = runs[S][name[:-len(" stream")]][0]
    pcfg, V, _ = _case(name.split()[-2], S)
    lo = SP.lower_to_ticks(SP.build_schedule(
        SP.resolve_ring_schedule(pcfg.schedule, V), pcfg.n_microbatches, S,
        V, mem_limit=pcfg.mem_limit or None))
    ends = [sum((src == r) + (dst == r) for h in C.ring_hops(lo)
                for _, src, dst in h) for r in range(S)]
    assert [g["hop"] for g in stream] == [g["hop"] for g in ticks], name
    assert [g["hop"][0] for g in stream] == ends
    assert all(a["live"] <= b["live"] for a, b in zip(stream, ticks))


def _reader_slots(lo, s: int) -> list:
    """The slot of the tick reading each of stage s's arrivals: a direct
    one at its own slot, a parked one where its inbox register is read."""
    out = []
    for t in range(lo.n_ticks):
        k = lo.kind[s][t]
        if k == SP.TICK_F and lo.fsrc[s][t] in (1, 2):
            out.append(t)
        if k == SP.TICK_B and lo.bsrc[s][t] in (1, 2):
            out.append(t)
    return out


def test_stream_rank_waits_only_where_read(world2):
    """zb-h2, rank 1 held back ``HOLD`` s after a barrier.  Under stream
    every wait on an arrival falls inside the tick that reads it (a
    parked one: where its inbox register is read, not where it landed),
    every send is waited after the last tick, and rank 0 runs its
    warm-up forwards while rank 1 is held; under ticks rank 0 stops at
    its first exchange until rank 1 comes.  Both runs give the
    in-process bits."""
    _check_case(world2, "zb-h2 held")
    _check_case(world2, "zb-h2 held stream")
    pcfg, V, _ = _case("zb-h2", 2)
    lo = SP.lower_to_ticks(SP.build_schedule("zb-h2", pcfg.n_microbatches,
                                             2))
    assert any(p >= 0 for row in lo.fpark + lo.bpark for p in row)
    ranks = world2["zb-h2 held stream"][0]
    for s, got in enumerate(ranks):
        ev = got["events"]
        recv = [t for what, t, _ in ev if what == "recv"]
        assert sorted(recv) == _reader_slots(lo, s), s
        last = max(i for i, e in enumerate(ev) if e[0] == "ticked")
        sends = [i for i, e in enumerate(ev) if e[0] == "send"]
        assert sends and all(ev[i][1] == -1 and i > last for i in sends), s
    started = min(t for what, _, t in ranks[1]["events"] if what == "tick")
    ahead = [t for what, t, at in ranks[0]["events"]
             if what == "ticked" and at < started]
    warmup = min(_reader_slots(lo, 0))      # rank 0's first arrival read
    assert ahead[:warmup] == list(range(warmup)) and warmup >= 2, ahead
    ticks = world2["zb-h2 held"][0]
    started = min(t for what, _, t in ticks[1]["events"] if what == "tick")
    assert [t for what, t, at in ticks[0]["events"]
            if what == "ticked" and at < started] == [0]


def test_rank_cli_stream_matches_single_process(world2):
    """``train.main([... "--runtime", "stream"], mesh=...)`` on the 2
    ranks: the single-process (tick) CLI's losses bit for bit, its stash
    counts, the runtime reported and registers live at most per rank."""
    ranks, ref, _ = world2["cli"]
    assert ranks[0]["runtime"] == "stream" and ref["runtime"] == "ticks"
    assert ranks[0]["losses"] == ref["losses"] and len(ref["losses"]) == 3
    assert ranks[0]["stash"] == ref["stash"] == [2, 1]
    assert ranks[0]["live"] == ranks[1]["live"] and \
        len(ranks[0]["live"]) == 2


def _stack_rows(trees: list) -> dict:
    """Per-rank layer trees -> one tree stacked [S, ...]."""
    return {k: _stack_rows([t[k] for t in trees])
            if isinstance(trees[0][k], dict) else torch.stack(
                [t[k] for t in trees]) for k in trees[0]}


# ---------------------------------------------------------------------------
# without spawning
# ---------------------------------------------------------------------------

def _consumed_arrivals(lo) -> list:
    """What the table's element flow needs moved: every F output but the
    last virtual stage's goes to stage s+1 at the next tick; every B (or
    B_SEED) output but virtual stage 0's goes to stage s-1."""
    S, NS = lo.N, lo.N * lo.V
    want = [set() for _ in range(lo.n_ticks)]
    for s in range(S):
        for t in range(lo.n_ticks):
            vs = lo.v[s][t] * S + s
            if lo.kind[s][t] == SP.TICK_F and vs < NS - 1:
                want[t + 1].add((C.FWD, s, (s + 1) % S))
            if lo.kind[s][t] in (SP.TICK_B, SP.TICK_B_SEED) and vs > 0:
                want[t + 1].add((C.BWD, s, (s - 1) % S))
    return want


@pytest.mark.parametrize("name", SP.BUILDER_NAMES)
def test_hops_are_the_consumed_arrivals(name):
    V = 2 if "interleaved" in name else 1
    for M, N in ((2, 1), (4, 2), (6, 3), (8, 4)):
        if V > 1 and (M < N or (name.endswith("memlean") and M % N)):
            continue
        kw = dict(mem_limit=2) if name == "zb-auto" and N > 1 else {}
        lo = SP.lower_to_ticks(SP.build_schedule(name, M, N, V, **kw))
        hops = C.ring_hops(lo)
        assert [len(set(h)) for h in hops] == [len(h) for h in hops]
        assert [set(h) for h in hops] == _consumed_arrivals(lo), (M, N)
        # a stage sends at most one message a tick (one op a tick)
        for h in hops:
            srcs = [src for _, src, _ in h]
            assert len(srcs) == len(set(srcs))


@pytest.mark.parametrize("arch,S,V,tied", [
    ("llama3.2-1b", 2, 1, True), ("llama3.2-1b", 3, 1, True),
    ("llama3.2-1b", 2, 2, True), ("llama3.2-1b", 3, 2, False),
    ("llama3.2-1b", 1, 1, True), ("mamba2-2.7b", 2, 1, True)])
def test_init_stage_params_is_the_stacked_row(arch, S, V, tied):
    cfg = W.config(arch, S, V, tied)
    plan = ST.plan_stages(cfg)
    full = ST.init_stacked_params(cfg, 3, plan, device="cpu")
    for s in range(S):
        got = ST.init_stage_params(cfg, 3, plan, s, device="cpu")
        _assert_bitwise(got, ST.stage_share(full, plan, s), f"stage {s}")
        assert ("embed" in got) == (s == 0 or (s == S - 1 and tied))
        assert ("head" in got) == (s == S - 1 and not tied)


def test_nccl_with_more_ranks_than_cards_raises():
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="cannot put two ranks on one device"):
        MESH.check_backend("nccl", "cuda", cards + 1)
    with pytest.raises(ValueError, match="use backend 'gloo'"):
        MESH.spawn_ranks(W.run_cases, cards + 1, "nccl", [], device="cuda")
    with pytest.raises(ValueError, match="cannot put two ranks"):
        MESH.init_stage_group("nccl", "cuda", rank=0, world=cards + 1,
                              init_method="file:///nonexistent")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="expected one of"):
        MESH.check_backend("mpi", "cpu", 2)


@pytest.mark.parametrize("flag,err,item", [
    (["--tensor", "2"], ValueError,
     "stages x tensor 2 on 2 ranks.*must equal the world size")])
def test_rank_cli_still_refuses_by_item(monkeypatch, flag, err, item):
    """Under torchrun's environment a grid that is not the world size
    (``--tensor 2`` at 2 stages needs 4 ranks) names both numbers, before
    any group is set up (``--data`` and ``--tensor``, once refused here,
    run: tests/test_torch_data.py, tests/test_torch_tensor.py; so do the
    elastic flags: tests/test_torch_elastic.py and below)."""
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(err, match=item):
        ttrain.main(["--arch", "llama3.2-1b", "--reduced", "--stages", "2",
                     "--steps", "1", "--device", "cpu"] + flag)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("extra,err,match", [
    (["--resume", "{ck}"], CheckpointMismatch,
     "at tensor 2, the run at tensor 1: a tensor degree change"),
    (["--resume", "{ck}.none"], FileNotFoundError, "none.meta"),
    (["--drift-every", "1", "--drift-inject", "1,1,1"], SystemExit, None)])
def test_rank_cli_checks_elastic_flags_before_any_group(monkeypatch,
                                                        tmp_path, extra,
                                                        err, match):
    """Under torchrun's environment ``--resume`` reads the checkpoint's
    layout first: one at another tensor degree raises CheckpointMismatch
    and a missing one FileNotFoundError; a wrong ``--drift-inject`` count
    is a usage error (exit 2); all before any group is set up."""
    ck = str(tmp_path / "ck")
    CKP.save_checkpoint(ck, dict(w=torch.zeros(1)), extra=dict(layout=dict(
        stages=2, tensor=2, virtual=1, layers_per_stage=2,
        n_layers_padded=4, n_layers=4)))
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(err, match=match) as e:
        ttrain.main(["--arch", "llama3.2-1b", "--reduced", "--layers", "4",
                     "--d-model", "64", "--stages", "2", "--tensor", "1",
                     "--steps", "1", "--device", "cpu"]
                    + [a.format(ck=ck) for a in extra])
    if err is SystemExit:
        assert e.value.code == 2
    assert not torch.distributed.is_initialized()


def test_rank_step_refuses_stream_and_stage_count(monkeypatch):
    """A world size other than the stage count raises before any group
    is set up (the stream runtime, once refused here, runs: above)."""
    for k, v in (("WORLD_SIZE", "3"), ("RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="must equal the world size"):
        ttrain.main(["--arch", "llama3.2-1b", "--reduced", "--layers", "4",
                     "--d-model", "64", "--stages", "2", "--steps", "1",
                     "--device", "cpu"])
    assert not torch.distributed.is_initialized()


def test_torchrun_cli_matches_single_process(tmp_path):
    """``torchrun --nproc-per-node 2`` of the CLI on the CPU (gloo): the
    single-process CLI's losses, bit for bit (both fresh processes, one
    torch thread each, run at once)."""
    argv = ["-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
            "--reduced", "--layers", "4", "--d-model", "64", "--stages", "2",
            "--microbatches", "2", "--batch", "4", "--seq", "16", "--steps",
            "3", "--device", "cpu", "--losses-out"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2"]
    procs = {name: subprocess.Popen(
        pre + argv + [str(tmp_path / f"{name}.json")], env=env, cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, pre in (("ranks", torchrun), ("single", [sys.executable]))}
    out = {name: p.communicate(timeout=240) for name, p in procs.items()}
    for name, p in procs.items():
        assert p.returncode == 0, (name, out[name][0][-2000:],
                                   out[name][1][-3000:])
    assert "stash slots per rank [2, 1]" in out["ranks"][0], out["ranks"][0]
    losses = {name: json.loads((tmp_path / f"{name}.json").read_text())[
        "losses"] for name in procs}
    assert len(losses["single"]) == 3
    assert losses["ranks"] == losses["single"], losses
