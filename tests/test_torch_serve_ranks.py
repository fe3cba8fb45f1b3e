"""The serve step as one process per stage (gloo on the CPU) against the
port's in-process serve step and the JAX package.

Two spawns (:func:`repro_torch.launch.mesh.spawn_ranks`, a ``FileStore``
in a temporary directory), started at once: 3 ranks run every case on
its ranks (``tests/_torch_serve_ranks_worker.py``; the 2-rank cases on a
subgroup of ranks 0-1), and one rank runs every case on the in-process
executor, each with one torch thread; this process runs the JAX
reference meanwhile.  The bar against the in-process step is bit for
bit: the logits of every step on every rank, the tokens, each rank's
cache share against the stacked cache's row and, after the V > 1
handoff, each rank's layers and cache against the stacked re-fold's
rows; for the ``ContinuousEngine`` run the step plans and the retired
requests.  The 2-rank llama prefill and teacher-forced decode on numpy
weights (through ``repro_torch.convert``) are held to
``repro.models.model.decode_step`` within 2e-4, the serve slice's
tolerance (``tests/test_torch_serve.py``).  Without spawning: the ring's
hops against the table's consumed arrivals, ``init_stage_cache`` against
the stacked cache's rows, the handoff's routes against the stacked
re-fold, and the refusals.  One CLI run under ``torchrun`` (2 ranks,
V = 2 prefill and the handoff) gives the single-process CLI's tokens bit
for bit.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch import convert
from repro_torch.core import schedplan as SP
from repro_torch.launch import mesh as MESH
from repro_torch.launch import serve as tserve
from repro_torch.pipeline import comm as C
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

import _torch_serve_ranks_worker as W
from test_torch_ranks import _jax_cfg, _weights
from test_torch_train import _stacked

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
ITEM = "tensor and data parallel over NCCL"


def _case(name, S, V=1, *, arch="llama3.2-1b", M=2, B=4, forced=None,
          weights=None, engine=None):
    return dict(name=name, arch=arch, S=S, V=V, M=M, B=B, forced=forced,
                weights=weights, engine=engine)


def _requests() -> list:
    """Six requests, one arriving a step, prompts of 3-10 tokens."""
    rng = np.random.default_rng(7)
    return [(rid, rng.integers(0, 1024, int(n)).tolist(), 3, rid)
            for rid, n in enumerate(rng.integers(3, 11, 6))]


def _cases(weights: dict, forced: np.ndarray) -> list:
    return [
        _case("llama 2 V1", 2),
        # M 4 > S: stage 0 parks each ring return for its next pass
        _case("llama 2 V2", 2, 2, M=4),
        _case("mamba2 2 V1", 2, arch="mamba2-2.7b"),
        _case("engine 2", 2, engine=(4, 4, 10 + 3 + 4, _requests())),
        _case("jax 2", 2, forced=forced,
              weights=convert.to_jax(_stacked(weights, 2))),
        # 4 layers pad to 6 slots; at V 2 the re-pad repeats layer 3,
        # which rank 0 holds, into rank 2's padded slots
        _case("llama 3 V1", 3, B=6),
        _case("llama 3 V2", 3, 2, M=3, B=6),
    ]


def _jax_logits(weights: dict, forced: np.ndarray) -> list:
    """The JAX package's single-device ``decode_step``: the prompt's last
    logits, then each teacher-forced decode step's."""
    jcfg = _jax_cfg()
    step = jax.jit(lambda p, b, c: JM.decode_step(jcfg, p, b, c))
    cache = JM.init_cache(jcfg, 4, max_len=W.PROMPT + W.GEN)
    lg, cache = step(weights, dict(tokens=jnp.asarray(
        W.prompt(4, jcfg.vocab), dtype=jnp.int32)), cache)
    out = [np.asarray(lg[:, -1])]
    for t in range(W.GEN):
        lg, cache = step(weights, dict(tokens=jnp.asarray(
            forced[:, t:t + 1], dtype=jnp.int32)), cache)
        out.append(np.asarray(lg[:, 0]))
    return out


@pytest.fixture(scope="module")
def runs():
    """``{name: (per-rank results, in-process result, case)}`` and
    ``"jax"``: the JAX logits.  No torch run shares this process's state
    (JAX runs here)."""
    weights = _weights()
    forced = np.random.default_rng(11).integers(
        0, 1024, (4, W.GEN)).astype(np.int32)
    cases = _cases(weights, forced)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(MESH.spawn_ranks, W.run_cases, 3, "gloo", cases)
        ref = pool.submit(MESH.spawn_ranks, W.in_process_cases, 1, "gloo",
                          cases)
        out = {"jax": _jax_logits(weights, forced)}
        ranks, ref = ranks.result(), ref.result()[0]
    out.update({c["name"]: ([r[c["name"]] for r in ranks[:c["S"]]],
                            ref[c["name"]], c) for c in cases})
    return out


def _assert_bitwise(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for a, b in zip(ST.tree_leaves(got), ST.tree_leaves(want)):
        assert a.shape == b.shape and torch.equal(a, b), what


def _row(tree: dict, s: int) -> dict:
    return ST._map_layers(lambda a: a[s], tree)


@pytest.mark.parametrize("name", ["llama 2 V1", "llama 2 V2", "mamba2 2 V1",
                                  "llama 3 V1", "llama 3 V2", "jax 2"])
def test_rank_serve_bitwise(runs, name):
    ranks, ref, case = runs[name]
    for r, got in enumerate(ranks):
        what = f"{name} rank {r}"
        assert len(got["logits"]) == len(ref["logits"]) == 1 + W.GEN
        for a, b in zip(got["logits"], ref["logits"]):
            assert torch.equal(a, b), what
        for a, b in zip(got["fed"], ref["fed"]):
            assert torch.equal(a, b), what
        _assert_bitwise(got["cache"], _row(ref["cache"], r), what)
        # a call moves ring hops and broadcasts the logits once
        for st in got["transport"]:
            assert st["hop"][0] > 0 and st["logits"][0] == 1, what
        if case["V"] > 1:
            assert case["M"] == case["S"] or any(SP.lower_to_ring(
                SP.build_schedule("1f1b-interleaved", case["M"], case["S"],
                                  2)).park)
            # the handoff moved layers between ranks and left each rank
            # the stacked re-fold's rows
            _assert_bitwise(got["handoff"]["layers"],
                            _row(ref["handoff"]["layers"], r), what)
            _assert_bitwise(got["handoff"]["cache"],
                            _row(ref["handoff"]["cache"], r), what)
            assert got["handoff_transport"]["handoff"][0] > 0, what


def test_ssm_ranks_refuse_n_valid(runs):
    ranks, ref, _ = runs["mamba2 2 V1"]
    for got in ranks + [ref]:
        assert "continuous batching (n_valid)" in got["n_valid_refusal"]


def test_engine_on_ranks_bitwise(runs):
    """One ``ContinuousEngine`` run (chunk 4, requests arriving over
    time, slots reused) on each rank over the rank step: the step plans
    and the retired requests of the in-process engine, and each rank's
    cache share its row."""
    ranks, ref, _ = runs["engine 2"]
    assert len(ref["retired"]) == 6 and len(ref["plans"]) > 6
    assert any(len({w[1] for w in p[2]} - {"idle"}) > 1
               for p in ref["plans"])      # some step mixes roles
    for r, got in enumerate(ranks):
        assert got["retired"] == ref["retired"], r
        assert len(got["plans"]) == len(ref["plans"]), r
        for (t, nv, work), (t0, nv0, work0) in zip(got["plans"],
                                                  ref["plans"]):
            assert (t == t0).all() and (nv == nv0).all() and work == work0
        _assert_bitwise(got["cache"], _row(ref["cache"], r), f"rank {r}")


def test_two_ranks_match_jax_decode_step(runs):
    """The slice as a whole: the 2-rank prefill and teacher-forced decode
    on numpy weights against the JAX package's ``decode_step``."""
    ranks, _, _ = runs["jax 2"]
    for got in ranks:
        for g, w in zip(got["logits"], runs["jax"]):
            np.testing.assert_allclose(g[:, 0].numpy(), w, atol=TOL,
                                       rtol=TOL)


# ---------------------------------------------------------------------------
# without spawning
# ---------------------------------------------------------------------------

def _consumed_arrivals(lo) -> list:
    """What the ring table's element flow needs moved: each element's
    output on stage s < S-1 goes to s+1 at the next tick; its last
    stage's output goes back to stage 0, arriving S ticks after its
    first, unless it is a final (chunk V-1) output."""
    S = lo.N
    want = [set() for _ in range(lo.n_ticks)]
    for e, v in enumerate(lo.v_of_e):
        for s in range(S - 1):
            want[e + s + 1].add((s, s + 1))
        if v < lo.V - 1:
            want[e + S].add((S - 1, 0))
    return want


@pytest.mark.parametrize("name", SP.BUILDER_NAMES)
def test_serve_hops_are_the_consumed_arrivals(name):
    V = 2 if "interleaved" in name else 1
    seen, parked = 0, False
    for M, N in ((1, 1), (2, 1), (2, 2), (4, 2), (3, 3), (6, 3), (8, 4)):
        try:
            lo = SP.lower_to_ring(SP.build_schedule(name, M, N, V))
        except ValueError:
            continue            # no ring table for this schedule here
        seen += 1
        hops = C.serve_hops(lo)
        assert [len(set(h)) for h in hops] == [len(h) for h in hops]
        assert [set(h) for h in hops] == _consumed_arrivals(lo), (M, N)
        parked |= any(lo.park)
    assert seen, name
    # the streaming interleave parks ring returns for a later pass
    assert parked == (name == "1f1b-interleaved"), name


@pytest.mark.parametrize("arch,S,V", [
    ("llama3.2-1b", 2, 1), ("llama3.2-1b", 3, 1), ("llama3.2-1b", 2, 2),
    ("llama3.2-1b", 3, 2), ("mamba2-2.7b", 2, 1), ("mamba2-2.7b", 2, 2)])
def test_init_stage_cache_is_the_stacked_row(arch, S, V):
    cfg = W.config(arch, S, V)
    plan = ST.plan_stages(cfg)
    full = RT.init_pipeline_cache(cfg, plan, 4, 12, device="cpu")
    for s in range(S):
        _assert_bitwise(RT.init_stage_cache(cfg, plan, s, 4, 12,
                                            device="cpu"),
                        _row(full, s), f"stage {s}")


@pytest.mark.parametrize("S,L,V_from,V_to", [
    (2, 4, 2, 1), (2, 3, 2, 1), (3, 4, 2, 1), (2, 5, 2, 1), (4, 16, 2, 1),
    (2, 4, 1, 2), (3, 5, 1, 2)])
def test_handoff_routes_are_the_stacked_refold(S, L, V_from, V_to):
    """Which rank sends which global layer to which rank's row: the flat
    slot :func:`stage.restack_layers` takes each new slot from, padded
    slots (the last real layer repeated) included."""
    cfg = dataclasses.replace(W.config("llama3.2-1b", S), n_layers=L)
    p_from = ST.plan_stages(cfg, virtual=V_from)
    p_to = ST.plan_stages(cfg, virtual=V_to)
    n_from = p_from.virtual * p_from.layers_per_stage
    n_to = p_to.virtual * p_to.layers_per_stage
    flat = np.arange(p_from.n_layers_padded).reshape(
        (S, n_from) if V_from == 1 else (S, V_from, -1))
    src_slot = ST.restack_layers(flat, p_from, p_to, L).reshape(S, n_to)
    routes = ST.handoff_routes(p_from, p_to, L)
    assert len(routes) == p_to.n_layers_padded
    slot_from, slot_to = ST._slot_of_layer(p_from), ST._slot_of_layer(p_to)
    for g, src, src_row, dst, dst_row in routes:
        assert src_slot[dst, dst_row] == src * n_from + src_row
        assert g == min(slot_to[dst * n_to + dst_row], L - 1)
        assert slot_from[src * n_from + src_row] == g
    if p_to.n_layers_padded > L:    # a padded slot takes the last layer
        assert any(g == L - 1 and slot_to[d * n_to + r] >= L
                   for g, _, _, d, r in routes)


def test_serve_refusals_name_the_item():
    cfg = W.config("llama3.2-1b", 2)
    plan = ST.plan_stages(cfg)
    plan2 = dataclasses.replace(plan, tensor=2)
    pcfg = RT.PipelineConfig()
    # the data and tensor axes are ported, as ranks only: in process
    # they name them (the in-process cache too); a rank's cache shards
    # the kv heads; fsdp is refused
    with pytest.raises(ValueError, match="runs only as ranks"):
        RT.make_serve_step(cfg, plan, pcfg, data=2)
    for call in (lambda: RT.make_serve_step(cfg, plan2, pcfg),
                 lambda: RT.init_pipeline_cache(cfg, plan2, 2, 4,
                                                device="cpu")):
        with pytest.raises(ValueError, match="tensor 2 = 4 processes"):
            call()
    with pytest.raises(NotImplementedError, match=ITEM):
        RT.make_serve_step(dataclasses.replace(cfg, fsdp=True), plan, pcfg)
    share = RT.init_stage_cache(cfg, plan2, 0, 2, 4, device="cpu")
    hd = cfg.resolved_head_dim
    assert share["kv"]["k"].shape[-2:] == (cfg.n_kv_heads // 2, hd)


_CLI = ["--arch", "llama3.2-1b", "--reduced", "--batch", "4",
        "--prompt-len", "8", "--gen", "3"]


@pytest.mark.parametrize("flags,err,match", [
    (["--stages", "2", "--tensor", "2", "--device", "cpu"],
     ValueError, "x tensor 2 on 2 ranks"),
    (["--stages", "3", "--device", "cpu"], ValueError,
     "must equal the world size"),
    (["--stages", "2", "--device", "cuda", "--dist-backend", "nccl"],
     ValueError, "cannot put two ranks on one device"),
    # nccl is the default on cuda
    (["--stages", "2", "--device", "cuda"], ValueError,
     "cannot put two ranks on one device")])
def test_rank_cli_refuses_before_any_group(monkeypatch, flags, err, match):
    """Under torchrun's environment (2 ranks) the serve CLI refuses a
    grid that is not the world size (``--tensor 2`` at 2 stages needs 4
    ranks) and nccl with more ranks than cards, before any group is set
    up (``--data`` and ``--tensor`` run: tests/test_torch_data.py,
    tests/test_torch_tensor.py)."""
    if torch.cuda.device_count() >= 2 and "cuda" in flags:
        pytest.skip("two cards: nccl could run both ranks")
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(err, match=match):
        tserve.main(_CLI + flags)
    assert not torch.distributed.is_initialized()


def test_torchrun_serve_cli_matches_single_process(tmp_path):
    """``torchrun --nproc-per-node 2`` of the serve CLI on the CPU
    (gloo; V = 2 prefill, the handoff across ranks, V = 1 decode): the
    single-process CLI's tokens, bit for bit (both fresh processes, one
    torch thread each, run at once)."""
    argv = ["-m", "repro_torch.launch.serve"] + _CLI + [
        "--stages", "2", "--virtual", "2", "--device", "cpu",
        "--tokens-out"]
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
    text = out["ranks"][0]
    assert "ranks=2 backend=gloo" in text and "handoff: V=2" in text, text
    assert "transport rank 1 (gloo) handoff: handoff" in text, text
    assert "logits 1 msgs" in text, text
    toks = {name: json.loads((tmp_path / f"{name}.json").read_text())[
        "tokens"] for name in procs}
    assert np.asarray(toks["single"]).shape == (4, 3)
    assert toks["ranks"] == toks["single"], toks
