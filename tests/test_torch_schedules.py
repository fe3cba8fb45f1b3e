"""The port's schedule-plan IR, simulator and interleaved stage layouts
against the JAX package's, on the CPU.

Every builder of the JAX package's ``BUILDER_NAMES`` (V 2 and 3 for the
interleaved two) must give the same ``lower_to_ticks`` tables; ``zb-auto``
under a ``mem_limit`` of None, an int and a per-device list, and under
scalar, vector and heterogeneous ``StageCosts`` costs, the same op table;
``zb_h2_mem_caps``, ``live_activation_counts`` and ``peak_live`` the same
rows; ``simulate`` the same result (makespan, peak rows, idle, the event
log) on the JAX package's random grid (``tests/test_schedplan.py``), under
the three communication models.  Equality is exact: ``build_zb_auto``
breaks ties on ``<`` comparisons of float sums, so its arithmetic must
follow the reference step for step.  The stacking of ``[S, V, Lc, ...]``
layouts (V 2 and 3) is held against the JAX package's on numpy arrays.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import schedplan as JSP
from repro.core import simulator as JSIM
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import schedplan as SP
from repro_torch.core import simulator as SIM
from repro_torch.pipeline import stage as ST

_NCCL = "tensor and data parallel over NCCL"

# the JAX package's random grid (tests/test_schedplan.py): M a multiple of
# N, so every builder (memlean's M % N == 0 included) takes every point
RNG = random.Random(20260730)
GRID = []
for _ in range(40):
    _N = RNG.randint(1, 6)
    GRID.append((_N * RNG.randint(1, 5), _N, RNG.choice([1, 2, 3, 4]),
                 round(RNG.uniform(0.1, 5.0), 3),
                 round(RNG.uniform(0.1, 5.0), 3)))


def _ops(plan):
    return [[dataclasses.astuple(o) for o in ops] for ops in plan.device_ops]


def _both(fn_port, fn_jax):
    """Call both; if the JAX package raises ValueError, the port must
    raise it too.  Returns the two results, or None."""
    try:
        want = fn_jax()
    except ValueError:
        with pytest.raises(ValueError):
            fn_port()
        return None
    return fn_port(), want


def test_builder_names_match_jax():
    assert SP.BUILDER_NAMES == JSP.BUILDER_NAMES
    assert SP.INTERLEAVED == JSP.INTERLEAVED
    assert set(SP._BUILDERS) == set(JSP._BUILDERS)
    assert SP._ALIASES == JSP._ALIASES


@pytest.mark.parametrize("name", JSP.BUILDER_NAMES)
@pytest.mark.parametrize("M,N", [(1, 1), (2, 1), (4, 2), (2, 4), (4, 4),
                                 (6, 3), (8, 3), (8, 4)])
def test_tick_tables_match_jax_every_builder(name, M, N):
    for V in ((2, 3) if name in JSP.INTERLEAVED else (1,)):
        got = _both(lambda: SP.build_schedule(name, M, N, V),
                    lambda: JSP.build_schedule(name, M, N, V))
        if got is None:             # the builder's rule refuses (M, N)
            continue
        plan, jplan = got
        assert plan.name == jplan.name and _ops(plan) == _ops(jplan)
        assert plan.peak_live() == jplan.peak_live()
        assert dataclasses.asdict(SP.lower_to_ticks(plan)) == \
            dataclasses.asdict(JSP.lower_to_ticks(jplan))


@pytest.mark.parametrize("mem_limit", [None, 0, 1, 2, 3, [2, 0, 1],
                                       [5, 4, 3], [1, 1, 1]])
@pytest.mark.parametrize("M", [3, 6, 9])
def test_zb_auto_mem_limit_matches_jax(mem_limit, M):
    N = 3
    plan = SP.build_schedule("zb-auto", M, N, mem_limit=mem_limit)
    jplan = JSP.build_schedule("zb-auto", M, N, mem_limit=mem_limit)
    assert _ops(plan) == _ops(jplan)
    assert dataclasses.asdict(SP.lower_to_ticks(plan)) == \
        dataclasses.asdict(JSP.lower_to_ticks(jplan))
    assert SP.live_activation_counts("zb-auto", M, N, mem_limit=mem_limit) \
        == JSP.live_activation_counts("zb-auto", M, N, mem_limit=mem_limit)


_COSTS = [
    (1.0, 1.0, 1.0),
    (1.0, 0.6, 1.4),
    ([1.0, 2.0, 1.5, 0.5], 1.0, [0.5, 1.0, 2.0, 1.0]),
    ([0.3, 0.7, 1.9, 1.1], [1.2, 0.4, 0.9, 2.2], [0.8, 1.6, 0.2, 1.0]),
]


@pytest.mark.parametrize("costs", _COSTS)
@pytest.mark.parametrize("mem_limit", [None, 2, [4, 3, 0, 2]])
@pytest.mark.parametrize("M", [4, 8])
def test_zb_auto_costs_match_jax(costs, mem_limit, M):
    """Scalar and vector ``(F, B, W)`` costs, under each kind of cap; the
    heterogeneous ones take both portfolio steps."""
    got = SP.build_zb_auto(M, 4, costs=costs, mem_limit=mem_limit)
    want = JSP.build_zb_auto(M, 4, costs=costs, mem_limit=mem_limit)
    assert got.name == want.name and _ops(got) == _ops(want)


def _stage_costs(mod, rng, N, sr, width):
    draw = lambda: tuple(round(rng.uniform(0.2, 3.0), 3) for _ in range(N))
    return mod.StageCosts(F=draw(), B=draw(), W=draw(),
                          SR=tuple(round(rng.uniform(0.0, 0.5), 3)
                                   for _ in range(N - 1)) if sr else (),
                          width=tuple(rng.randint(1, 4) for _ in range(N))
                          if width else ())


@pytest.mark.parametrize("seed", range(6))
def test_heterogeneous_stage_costs_match_jax(seed):
    """Random heterogeneous StageCosts (with and without per-hop SR): the
    zb-auto table, the cost vector's derived views and the replay under
    ``simulate_costs`` are the JAX package's."""
    rng_a, rng_b = random.Random(seed), random.Random(seed)
    N = 2 + seed % 3
    sr, width = seed % 2 == 0, seed % 3 == 1
    costs = _stage_costs(SP, rng_a, N, sr, width)
    jcosts = _stage_costs(JSP, rng_b, N, sr, width)
    for attr in ("F", "B", "W", "SR", "width", "widths", "B_full", "w_frac",
                 "sr_hops", "uniform", "even_split", "uniform_width"):
        assert getattr(costs, attr) == getattr(jcosts, attr), attr
    assert costs.bottleneck() == jcosts.bottleneck()
    assert dataclasses.asdict(costs.max_scalar()) == \
        dataclasses.asdict(jcosts.max_scalar())
    for M in (N, 2 * N + 1):
        for mem_limit in (None, N):
            plan = SP.build_zb_auto(M, N, costs=costs, mem_limit=mem_limit)
            jplan = JSP.build_zb_auto(M, N, costs=jcosts, mem_limit=mem_limit)
            assert _ops(plan) == _ops(jplan)
            for sched, jsched in ((plan, jplan), ("zb-h1", "zb-h1"),
                                  ("1f1b", "1f1b")):
                got = SIM.simulate_costs(sched, M, N, costs)
                want = JSIM.simulate_costs(jsched, M, N, jcosts)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
    uni = SP.StageCosts.uniform_costs(N, 1.5, 2.5, SR=0.25, w_frac=0.3)
    juni = JSP.StageCosts.uniform_costs(N, 1.5, 2.5, SR=0.25, w_frac=0.3)
    assert dataclasses.asdict(uni) == dataclasses.asdict(juni)


def test_stage_costs_and_zb_auto_reject_what_jax_rejects():
    bad = [dict(F=(1.0,), B=(1.0, 1.0), W=(1.0,)),
           dict(F=(1.0, 1.0), B=(1.0, 1.0), W=(1.0, 0.0)),
           dict(F=(1.0, 1.0), B=(1.0, 1.0), W=(1.0, 1.0), SR=(0.1, 0.1)),
           dict(F=(1.0, 1.0), B=(1.0, 1.0), W=(1.0, 1.0), SR=(-0.1,)),
           dict(F=(1.0, 1.0), B=(1.0, 1.0), W=(1.0, 1.0), width=(1,)),
           dict(F=(1.0, 1.0), B=(1.0, 1.0), W=(1.0, 1.0), width=(1, 0))]
    for kw in bad:
        with pytest.raises(ValueError):
            JSP.StageCosts(**kw)
        with pytest.raises(ValueError):
            SP.StageCosts(**kw)
    for kw in (dict(costs=(1.0, 0.0, 1.0)), dict(costs=([1.0, 1.0], 1, 1)),
               dict(mem_limit=[1, 2]),
               dict(costs=SP.StageCosts.uniform_costs(2, 1.0, 1.0))):
        jkw = dict(kw)
        if isinstance(kw.get("costs"), SP.StageCosts):
            jkw["costs"] = JSP.StageCosts.uniform_costs(2, 1.0, 1.0)
        with pytest.raises(ValueError):
            JSP.build_zb_auto(4, 3, **jkw)
        with pytest.raises(ValueError):
            SP.build_zb_auto(4, 3, **kw)


@pytest.mark.parametrize("M,N", [(1, 1), (4, 1), (2, 2), (4, 4), (8, 4),
                                 (5, 6), (12, 5)])
def test_memory_rows_match_jax(M, N):
    assert SP.zb_h2_mem_caps(M, N) == JSP.zb_h2_mem_caps(M, N)
    for mem_limit in (None, 2, [0] * N, list(range(1, N + 1))):
        assert SP._normalize_caps(mem_limit, M, N) == \
            JSP._normalize_caps(mem_limit, M, N)
    for name in list(JSP._ALIASES):
        for V in ((1, 2, 3) if JSP.canonical_name(name) in JSP.INTERLEAVED
                  else (1,)):
            for fm in (1, 2):
                assert SP.live_activation_counts(name, M, N, V, fm) == \
                    JSP.live_activation_counts(name, M, N, V, fm), name
        got = _both(lambda: SP.build_schedule(name, M, N).peak_live(),
                    lambda: JSP.build_schedule(name, M, N).peak_live())
        if got is not None:
            assert got[0] == got[1], name


@pytest.mark.parametrize("M,N,V,F,B", GRID)
def test_simulate_matches_jax_on_the_grid(M, N, V, F, B):
    """Every builder replayed by both simulators: the same SimResult, the
    event log included, free comm; with SR > 0 under latency and
    blocking; zero-bubble plans also at an uneven ``w_frac``."""
    for name in JSP.BUILDER_NAMES:
        v = V if name in JSP.INTERLEAVED else 1
        runs = [dict(), dict(SR=round(F / 7, 3), comm="latency"),
                dict(SR=round(B / 5, 3), comm="blocking")]
        if name.startswith("zb"):
            runs.append(dict(w_frac=[0.2 + 0.6 * n / N for n in range(N)]))
        for kw in runs:
            got = SIM.simulate(name, M, N, F, B, V=v, **kw)
            want = JSIM.simulate(name, M, N, F, B, V=v, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (name, kw)
            assert got.internal_idle == want.internal_idle
            assert got.bubble_fraction() == want.bubble_fraction()


def test_simulate_prebuilt_zb_auto_plans_match_jax():
    """Cost- and cap-parameterised zb-auto tables replayed as prebuilt
    plans, with per-device F/B vectors and per-hop SR."""
    for M, N, ml in ((8, 4, None), (8, 4, 2), (12, 3, [4, 0, 2])):
        F = [1.0 + 0.25 * n for n in range(N)]
        B = [2.0 - 0.2 * n for n in range(N)]
        plan = SP.build_schedule("zb-auto", M, N, mem_limit=ml)
        jplan = JSP.build_schedule("zb-auto", M, N, mem_limit=ml)
        for kw in (dict(), dict(SR=[0.1] * (N - 1), comm="latency")):
            assert dataclasses.asdict(SIM.simulate(plan, M, N, F, B, **kw)) \
                == dataclasses.asdict(JSIM.simulate(jplan, M, N, F, B, **kw))


def test_unported_grad_sync_raises_by_name():
    with pytest.raises(NotImplementedError, match=_NCCL):
        SP.build_schedule("1f1b", 4, 2, grad_sync=True)
    with pytest.raises(NotImplementedError, match=_NCCL):
        SIM.simulate("1f1b", 4, 2, 1.0, 2.0, grad_sync=True)
    with pytest.raises(NotImplementedError, match=_NCCL):
        SIM.simulate("1f1b", 4, 2, 1.0, 2.0, ar=0.5)
    # what the reference rejects, the port rejects
    for mod in (SP, JSP):
        with pytest.raises(ValueError, match="mem_limit"):
            mod.build_schedule("zb-h2", 4, 2, mem_limit=2)
        with pytest.raises(ValueError):
            mod.build_schedule("zb-auto", 4, 2, V=2)
        with pytest.raises(ValueError):
            mod.resolve_ring_schedule("1f1b", 2)


@pytest.mark.parametrize("schedule", ["auto", "", None, "1F1B-I",
                                      "1f1b-interleaved-memlean", "zb_auto",
                                      "ZB-H2", "gpipe"])
@pytest.mark.parametrize("V", [1, 2])
def test_resolve_ring_schedule_matches_jax(schedule, V):
    got = _both(lambda: SP.resolve_ring_schedule(schedule, V),
                lambda: JSP.resolve_ring_schedule(schedule, V))
    if got is not None:
        assert got[0] == got[1]


# ---------------------------------------------------------------------------
# interleaved stage layouts
# ---------------------------------------------------------------------------

def _tiny_cfgs(n_layers):
    kw = dict(n_kv_heads=2, tensor=1)
    return (dataclasses.replace(
                get_config("llama3.2-1b").reduced(n_layers=n_layers,
                                                  d_model=64), **kw),
            dataclasses.replace(
                jax_get_config("llama3.2-1b").reduced(n_layers=n_layers,
                                                      d_model=64), **kw))


@pytest.mark.parametrize("S,V,n_layers", [(1, 2, 4), (2, 2, 4), (3, 2, 4),
                                          (2, 3, 7), (3, 3, 9), (4, 2, 16)])
def test_interleaved_stacking_matches_jax(S, V, n_layers):
    """[S, V, Lc] stacking, its inverse and the per-slot metadata on numpy
    arrays and on tensors; the tensor layout is contiguous."""
    cfg, jcfg = _tiny_cfgs(n_layers)
    plan = ST.plan_stages(cfg, n_stages=S, virtual=V)
    jplan = JST.plan_stages(jcfg, n_stages=S, virtual=V)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    a = np.arange(plan.n_layers_padded * 6, dtype=np.float32).reshape(-1, 2, 3)
    want = np.asarray(JST._stack_chunks(a, jplan))
    np.testing.assert_array_equal(ST._stack_chunks(a, plan), want)
    t = ST._stack_chunks(torch.from_numpy(a), plan)
    assert t.shape == (S, V, plan.layers_per_stage, 2, 3)
    assert t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(ST.unstack_chunks(t, plan).numpy(), a)
    np.testing.assert_array_equal(
        ST.unstack_chunks(want, plan), np.asarray(JST.unstack_chunks(want,
                                                                     jplan)))
    jm = jax.tree.map(np.asarray, JST.stacked_meta(jcfg, jplan))
    tm = ST.stacked_meta(cfg, plan)
    for key in ("active", "rope_theta", "is_global"):
        np.testing.assert_array_equal(
            np.array([[[ml[key] for ml in chunk] for chunk in row]
                      for row in tm]), jm[key])


def test_jax_interleaved_params_cross_into_the_port_layout():
    """JAX-made V = 2 parameters [S, V, Lc, ...] go through
    ``convert.from_jax`` leaf by leaf into the port's layout: the port's
    unstacking gives the JAX package's global layer order, and the port's
    own stacking of those layers gives the same tensors.  The port's
    initialiser draws the same global layers for V = 1 and V = 2."""
    cfg, jcfg = _tiny_cfgs(4)
    jplan = JST.plan_stages(jcfg, n_stages=2, virtual=2)
    plan = ST.plan_stages(cfg, n_stages=2, virtual=2)
    jp = jax.tree.map(np.asarray, JST.init_stacked_params(
        jcfg, jax.random.PRNGKey(0), jplan))
    tp = convert.from_jax(jp)
    for key in ("embed", "final_norm"):
        np.testing.assert_array_equal(tp[key].numpy(), jp[key])
    for got, want in zip(ST.tree_leaves(tp["layers"]),
                         jax.tree.leaves(jp["layers"])):
        assert tuple(got.shape) == want.shape == \
            (2, 2, plan.layers_per_stage) + want.shape[3:]
        flat = np.asarray(JST.unstack_chunks(want, jplan))
        np.testing.assert_array_equal(ST.unstack_chunks(got, plan).numpy(),
                                      flat)
        np.testing.assert_array_equal(
            ST._stack_chunks(torch.from_numpy(flat), plan).numpy(), want)
    p1 = ST.init_stacked_params(cfg, 3, ST.plan_stages(cfg, n_stages=2),
                                device="cpu")
    p2 = ST.init_stacked_params(cfg, 3, plan, device="cpu")
    for a, b in zip(ST.tree_leaves(p1["layers"]),
                    ST.tree_leaves(p2["layers"])):
        assert b.is_contiguous()
        assert torch.equal(ST.unstack_chunks(a, ST.plan_stages(
            cfg, n_stages=2)), ST.unstack_chunks(b, plan))
