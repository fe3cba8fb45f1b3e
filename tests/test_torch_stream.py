"""The stream runtime's instruction lowering and its in-process executor,
on the CPU, with no spawn.

``repro_torch.core.schedplan.lower_to_instructions`` is held field for
field to the JAX package's (the streams as field tuples, the ring gates,
``slot_of``, ``arsync``, ``n_shifts``) for every builder of
``BUILDER_NAMES`` over drawn (M, N, V); ``slot_of`` to the port
simulator's event order at unit op durations, as
``tests/test_schedplan_properties.py`` holds the reference; each
stream's SENDs to ``comm.ring_hops``' messages.  The in-process
``runtime='stream'`` (every stage's stream replayed slot by slot, the
FREEs applied) is held bit for bit to ``runtime='ticks'`` for every
``SCHEDULES`` entry of ``tests/test_torch_train.py``.  The rank
executor under stream is in ``tests/test_torch_ranks.py``.
"""
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # tier-1 must collect without hypothesis
    from _hypo_shim import given, settings, strategies as st

import dataclasses

import pytest
import torch

from repro.core import schedplan as JSP
from repro_torch.core import schedplan as SP
from repro_torch.core.simulator import simulate
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.pipeline import comm as C
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

from test_torch_train import SCHEDULES, SEQ, _case, _cfgs


def _shape(name, N, mmult, V):
    """Feasible (M, V) for a builder given the drawn knobs."""
    return N * mmult, V if name in SP.INTERLEAVED else 1


def _lower(mod, name, M, N, V):
    return mod.lower_to_instructions(mod.build_schedule(name, M, N, V))


@pytest.mark.parametrize("name", SP.BUILDER_NAMES)
@settings(max_examples=10, deadline=None)
@given(N=st.integers(1, 6), mmult=st.integers(1, 4), V=st.integers(1, 4))
def test_lowering_matches_jax(name, N, mmult, V):
    M, v = _shape(name, N, mmult, V)
    got, want = _lower(SP, name, M, N, v), _lower(JSP, name, M, N, v)
    assert [[dataclasses.astuple(i) for i in s] for s in got.streams] == \
        [[dataclasses.astuple(i) for i in s] for s in want.streams]
    assert [list(map(repr, s)) for s in got.streams] == \
        [list(map(repr, s)) for s in want.streams]
    assert (got.fsend, got.bsend, got.slot_of, got.arsync) == \
        (want.fsend, want.bsend, want.slot_of, want.arsync)
    assert (got.n_shifts, got.n_slots, got.has_w, got.schedule) == \
        (want.n_shifts, want.n_slots, want.has_w, want.schedule)
    assert not any(got.arsync)
    assert dataclasses.asdict(got.ticks) == dataclasses.asdict(want.ticks)


@pytest.mark.parametrize("name", SP.BUILDER_NAMES)
@settings(max_examples=10, deadline=None)
@given(N=st.integers(1, 6), mmult=st.integers(1, 4), V=st.integers(1, 4))
def test_slots_are_the_simulator_event_order(name, N, mmult, V):
    """Every op's slot is its start in the port simulator's unit-duration
    free-comm replay; the ring gates fire exactly where some device
    produces a value that travels."""
    M, v = _shape(name, N, mmult, V)
    plan = SP.build_schedule(name, M, N, v)
    lo = SP.lower_to_instructions(plan)
    res = simulate(plan, M, N, float(v), float(v) * (2 if plan.has_w else 1),
                   0.0, V=v, comm="free")
    assert len(res.events) == len(lo.slot_of)
    for (s, _e, kind, m, vs) in res.events:
        assert lo.slot_of[(kind, m, vs)] == pytest.approx(s), (kind, m, vs)
    assert res.makespan == pytest.approx(lo.n_slots)
    NS = N * v
    f_prod = {t for (k, _m, vs), t in lo.slot_of.items()
              if k == "F" and vs < NS - 1}
    b_prod = {t for (k, _m, vs), t in lo.slot_of.items()
              if k == "B" and vs > 0}
    assert {t for t, g in enumerate(lo.fsend) if g} == f_prod
    assert {t for t, g in enumerate(lo.bsend) if g} == b_prod
    assert lo.n_shifts <= 2 * lo.n_slots


@pytest.mark.parametrize("name", SP.BUILDER_NAMES)
def test_sends_are_the_ring_hops(name):
    """A stream's SENDs are the messages ``comm.ring_hops`` has its rank
    send, and its RECVs those it has it receive, slot for slot (the tick
    executor's hops arrive one tick after their SEND)."""
    V = 2 if name in SP.INTERLEAVED else 1
    for M, N in ((2, 1), (4, 2), (6, 3), (8, 4)):
        if V > 1 and (M < N or (name.endswith("memlean") and M % N)):
            continue
        kw = dict(mem_limit=2) if name == "zb-auto" and N > 1 else {}
        lo = SP.lower_to_instructions(SP.build_schedule(name, M, N, V, **kw))
        hops = C.ring_hops(lo.ticks)
        ring = {C.FWD: "fwd", C.BWD: "bwd"}
        for r, stream in enumerate(lo.streams):
            sends = [(i.slot + 1, i.ring) for i in stream
                     if i.op == SP.INSTR_SEND]
            recvs = [(i.slot, i.ring) for i in stream
                     if i.op == SP.INSTR_RECV]
            assert sends == [(t, ring[g]) for t, h in enumerate(hops)
                             for g, src, _ in h if src == r], (M, N, r)
            assert sorted(recvs) == sorted(
                (t, ring[g]) for t, h in enumerate(hops)
                for g, _, dst in h if dst == r), (M, N, r)


def _step_results(schedule: str, S: int) -> dict:
    """loss, gradients, stash and live registers of one step of the
    reduced llama under each runtime, in process."""
    pcfg, V, rows = _case(schedule, S)
    cfg = dataclasses.replace(_cfgs()[0], stages=S, virtual=V)
    plan = ST.plan_stages(cfg)
    params = ST.init_stacked_params(cfg, 0, plan, device="cpu")
    batch = SyntheticLM(cfg.vocab, SEQ, rows, device="cpu").batch(0)
    out = {}
    for runtime in ("ticks", "stream"):
        step = RT.make_train_step(cfg, plan,
                                  dataclasses.replace(pcfg, runtime=runtime))
        loss, grads = step(params, batch)
        out[runtime] = dict(loss=loss, grads=grads, stash=step.stash_slots,
                            live=step.live_registers, step=step)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_in_process_stream_is_ticks_bitwise(schedule):
    """Two stages: the loss, every gradient leaf and the stash count bit
    for bit; the FREEs leave no stage holding more registers at once
    than under ticks, where none is emptied."""
    res = _step_results(schedule, 2)
    ticks, stream = res["ticks"], res["stream"]
    assert torch.equal(stream["loss"], ticks["loss"])
    for a, b in zip(ST.tree_leaves(stream["grads"]),
                    ST.tree_leaves(ticks["grads"])):
        assert torch.equal(a, b)
    assert stream["stash"] == ticks["stash"]
    assert all(a <= b for a, b in zip(stream["live"], ticks["live"]))
    instr = stream["step"].instructions
    assert isinstance(instr, SP.InstrLowering) and instr.ticks == \
        stream["step"].lowering
    assert ticks["step"].instructions is None


@pytest.mark.parametrize("schedule", ["1f1b", "zb-h2", "1f1b-interleaved"])
def test_in_process_stream_three_stages(schedule):
    """Three stages (4 layers padded to 6 slots; V 2 wraps the ring)."""
    res = _step_results(schedule, 3)
    assert torch.equal(res["stream"]["loss"], res["ticks"]["loss"])
    for a, b in zip(ST.tree_leaves(res["stream"]["grads"]),
                    ST.tree_leaves(res["ticks"]["grads"])):
        assert torch.equal(a, b)


def test_stream_frees_registers():
    """zb-h2 at 2 stages parks arrivals and stashes cotangents: the
    stream empties them, so its stages hold fewer registers at once."""
    res = _step_results("zb-h2", 2)
    assert sum(res["stream"]["live"]) < sum(res["ticks"]["live"])


def test_unknown_runtime_raises():
    cfg = dataclasses.replace(_cfgs()[0], stages=2)
    plan = ST.plan_stages(cfg)
    with pytest.raises(ValueError, match="expected ticks | stream"):
        RT.make_train_step(cfg, plan, RT.PipelineConfig(runtime="lockstep"))
    for kw in (dict(grad_sync="overlap"), dict(grad_sync="2bw"),
               dict(ar_groups=2)):
        with pytest.raises(NotImplementedError,
                           match="tensor and data parallel over NCCL"):
            RT.make_train_step(cfg, plan,
                               RT.PipelineConfig(runtime="stream", **kw))


def test_cli_runs_stream_in_one_process():
    """``--runtime stream`` in one process: the tick run's losses bit for
    bit; the scheduled gradient sync stays refused by its item."""
    from repro_torch.launch import train as ttrain
    argv = ["--arch", "llama3.2-1b", "--reduced", "--layers", "4",
            "--d-model", "64", "--stages", "2", "--microbatches", "2",
            "--batch", "4", "--seq", "16", "--steps", "2", "--device", "cpu"]
    ticks = ttrain.main(argv)
    stream = ttrain.main(argv + ["--runtime", "stream"])
    assert (ticks["runtime"], stream["runtime"]) == ("ticks", "stream")
    assert stream["losses"] == ticks["losses"]
    assert stream["stash_slots"] == ticks["stash_slots"] == [2, 1]
    for flag in (["--grad-sync", "overlap"], ["--grad-sync", "2bw"],
                 ["--ar-groups", "2"]):
        with pytest.raises(NotImplementedError,
                           match="tensor and data parallel over NCCL"):
            ttrain.main(argv + ["--runtime", "stream"] + flag)
    with pytest.raises(SystemExit):
        ttrain.main(argv + ["--runtime", "lockstep"])
