"""The port's analytic planner stack against the JAX package's, on the CPU.

``repro_torch.core`` holds copies of the reference's ``hardware``,
``profiler``, ``partition``, ``schedules``, ``explorer`` and ``autoplan``.
The explorer ranks candidates with ``<`` on float sums and keeps the first
of equal times, so the port must compute every number the reference
computes, in its order: each comparison here is exact (``==`` on the
dataclasses' fields, floats included), except the measured block proxy,
which is held to 1e-5 of the JAX proxy on the JAX proxy's parameters.

The cases come from the reference tests (``test_partition.py``,
``test_hetero_costs.py``, ``test_explorer.py``, ``test_plan3d.py``,
``test_autoplan.py``, ``test_drift_replan.py``) and the schedule grid of
``test_schedplan.py``.  The port's ``H100`` is handed to the JAX
``DeviceSpec`` field by field, so both planners plan for the same card.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from repro.configs import all_arch_ids
from repro.configs import get_config as jax_get_config
from repro.core import autoplan as JA
from repro.core import explorer as JE
from repro.core import hardware as JH
from repro.core import partition as JPT
from repro.core import profiler as JP
from repro.core import schedplan as JSP
from repro.core import schedules as JS
from repro.configs import base as JB
from repro_torch.configs import base as TB
from repro_torch.configs import get_config
from repro_torch.core import autoplan as TA
from repro_torch.core import explorer as TE
from repro_torch.core import hardware as TH
from repro_torch.core import partition as TPT
from repro_torch.core import profiler as TP
from repro_torch.core import schedplan as TSP
from repro_torch.core import schedules as TS
from repro_torch.pipeline import stage as TST


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    """A dataclass (nested ones too) as plain tuples, for ``==`` across
    the two packages' classes."""
    if dataclasses.is_dataclass(x):
        return dataclasses.astuple(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_t(v) for v in x)
    return x


def _both(fn_port, fn_jax):
    """Both results, or None when the JAX package raises ValueError (then
    the port must raise it too)."""
    try:
        want = fn_jax()
    except ValueError:
        with pytest.raises(ValueError):
            fn_port()
        return None
    return fn_port(), want


# ---------------------------------------------------------------------------
# hardware
# ---------------------------------------------------------------------------

_CATALOGUE = ("TPU_V5E", "V100", "VCU118", "VCU129")
JH100 = JH.DeviceSpec(**dataclasses.asdict(TH.H100))


def _jdev(name):
    return JH100 if name == "H100" else getattr(JH, name)


def test_hardware_catalogue_matches_jax():
    for name in _CATALOGUE:
        assert dataclasses.asdict(getattr(TH, name)) == \
            dataclasses.asdict(getattr(JH, name)), name
    assert set(TH.CATALOGUE) == {"tpu_v5e", "v100", "vcu118", "vcu129",
                                 "h100"}
    # the port's card, handed to the JAX DeviceSpec field by field
    assert JH100.effective_flops == TH.H100.effective_flops
    for axis in ("data", "stage", "tensor"):
        assert JH100.axis_bandwidth(axis) == TH.H100.axis_bandwidth(axis)
    assert not TH.H100.async_capable
    assert TS.schedules_for(TH.H100.async_capable) == ("1F1B-SNO", "1F1B-SO")


@pytest.mark.parametrize("name", _CATALOGUE + ("H100",))
def test_fused_devices_clusters_and_fleets_match_jax(name):
    dev, jdev = getattr(TH, name), _jdev(name)
    for w in (1, 2, 4, 8):
        assert dataclasses.asdict(TH.fused_device(dev, w)) == \
            dataclasses.asdict(JH.fused_device(jdev, w))
    with pytest.raises(ValueError):
        TH.fused_device(dev, 0)
    cl = TH.heterogeneous_cluster([dev, TH.V100, dev])
    jcl = JH.heterogeneous_cluster([jdev, JH.V100, jdev])
    assert [cl.link_bandwidth(i) for i in range(2)] == \
        [jcl.link_bandwidth(i) for i in range(2)]
    assert (cl.homogeneous, cl.n) == (jcl.homogeneous, jcl.n)
    for axis in ("data", "stage", "tensor"):
        assert cl.axis_bandwidth(axis) == jcl.axis_bandwidth(axis)
    fleet, jfleet = TH.homogeneous_fleet(dev, 8), JH.homogeneous_fleet(jdev, 8)
    for widths in ([1] * 8, [2, 2, 4], [4, 4], [8], [1, 2, 1]):
        assert _t(fleet.chain(widths)) == _t(jfleet.chain(widths))
    with pytest.raises(ValueError):
        fleet.chain([4, 8])
    other = TH.VCU118 if name == "V100" else TH.V100
    with pytest.raises(ValueError):
        TH.FleetSpec(devices=(dev, other)).chain([2])


# ---------------------------------------------------------------------------
# profiler (analytic) and param_count
# ---------------------------------------------------------------------------

def _port_cfg(jcfg):
    """The JAX package's ArchConfig as the port's (the port's registry
    holds only the families it runs; the planner takes any)."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(TB, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return TB.ArchConfig(**kw)


@pytest.mark.parametrize("arch", all_arch_ids())
def test_profile_arch_and_param_count_match_jax(arch):
    jcfg = jax_get_config(arch)
    cfg = _port_cfg(jcfg)
    for seq in (128, 1024, 4096):
        assert _t(TP.profile_arch(cfg, seq=seq)) == \
            _t(JP.profile_arch(jcfg, seq=seq))
    red = jcfg.reduced(n_layers=4, d_model=128, seq=64)
    assert _t(TP.profile_arch(_port_cfg(red), seq=64)) == \
        _t(JP.profile_arch(red, seq=64))
    assert cfg.param_count() == jcfg.param_count()
    assert [TP.layer_kind(cfg, i) for i in range(cfg.n_layers)] == \
        [JP.layer_kind(jcfg, i) for i in range(jcfg.n_layers)]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b"])
def test_port_configs_profile_as_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    for seq in (64, 512, 1024, 4096):
        assert _t(TP.profile_arch(cfg, seq=seq)) == \
            _t(JP.profile_arch(jcfg, seq=seq))
    with pytest.raises(ValueError):
        TP.profile_arch(dataclasses.replace(cfg, profile_w_frac="other"))


def test_paper_profiles_match_jax():
    pairs = [(TP.profile_vgg16(), JP.profile_vgg16()),
             (TP.profile_resnet50(), JP.profile_resnet50()),
             (TP.profile_gnmt(8), JP.profile_gnmt(8)),
             (TP.profile_gnmt_L(16), JP.profile_gnmt_L(16)),
             (TP.profile_vgg16(bpp=4), JP.profile_vgg16(bpp=4))]
    for a, b in pairs:
        assert _t(a) == _t(b)
    lay = TP.profile_gnmt(8).layers[4]
    jlay = JP.profile_gnmt(8).layers[4]
    for name in ("TPU_V5E", "V100", "H100"):
        dev, jdev = getattr(TH, name), _jdev(name)
        for u in (1, 7, 64):
            assert TP.fwd_time(lay, dev, u) == JP.fwd_time(jlay, jdev, u)
            assert TP.bwd_split_time(lay, dev, u) == \
                JP.bwd_split_time(jlay, jdev, u)
            for tp in (1, 2, 4):
                assert TP.fwd_time_tp(lay, dev, u, tp) == \
                    JP.fwd_time_tp(jlay, jdev, u, tp)
                assert TP.bwd_time_tp(lay, dev, u, tp) == \
                    JP.bwd_time_tp(jlay, jdev, u, tp)
                assert TP.bwd_split_time_tp(lay, dev, u, tp) == \
                    JP.bwd_split_time_tp(jlay, jdev, u, tp)


# ---------------------------------------------------------------------------
# schedules: closed forms, hetero forms, gradient sync
# ---------------------------------------------------------------------------

# the JAX package's random grid (tests/test_schedplan.py)
RNG = random.Random(20260730)
GRID = []
for _ in range(40):
    _N = RNG.randint(1, 6)
    GRID.append((_N * RNG.randint(1, 5), _N, RNG.choice([1, 2, 3, 4]),
                 round(RNG.uniform(0.1, 5.0), 3),
                 round(RNG.uniform(0.1, 5.0), 3)))


@pytest.mark.parametrize("M,N,V,F,B", GRID)
def test_closed_forms_match_jax_on_the_grid(M, N, V, F, B):
    SR, a, w = 0.1 * min(F, B), 3.0, 7.0
    for name in TS.SCHEDULES:
        fn, jfn = TS.SCHEDULES[name], JS.SCHEDULES[name]
        kws = [dict(V=V)] if name in ("1F1B-I", "1F1B-I-ML") else (
            [dict(), dict(mem_limit=N + 1, w_frac=0.3),
             dict(mem_limit=[N] * N)] if name == "ZB-AUTO" else [dict()])
        for kw in kws:
            got = _both(lambda: fn(M, N, F, B, SR, a, w, **kw),
                        lambda: jfn(M, N, F, B, SR, a, w, **kw))
            if got is not None:
                assert _t(got[0]) == _t(got[1]), (name, kw)
    for fn in ("eval_1f1b_interleaved_latency",):
        got = _both(lambda: getattr(TS, fn)(M, N, F, B, SR, a, w, V=V),
                    lambda: getattr(JS, fn)(M, N, F, B, SR, a, w, V=V))
        if got is not None:
            assert _t(got[0]) == _t(got[1])
    assert _t(TS.eval_1f1b_interleaved_blocking(M, N, F, B, SR, a, w)) == \
        _t(JS.eval_1f1b_interleaved_blocking(M, N, F, B, SR, a, w))
    for fn in ("latency_hops_1f1b_interleaved",):
        assert getattr(TS, fn)(M, N, V) == getattr(JS, fn)(M, N, V)
    for fn in ("blocking_stall_1f1b_interleaved",
               "blocking_hops_1f1b_interleaved"):
        assert getattr(TS, fn)(M, N) == getattr(JS, fn)(M, N)
    assert TS.hideable_sr_1f1b_interleaved(M, N, V, F, B) == \
        JS.hideable_sr_1f1b_interleaved(M, N, V, F, B)
    if M > 3:
        assert TS.blockable_sr_1f1b_interleaved(M, N, F, B) == \
            JS.blockable_sr_1f1b_interleaved(M, N, F, B)
    assert TS.schedules_for(True) == JS.schedules_for(True)
    assert TS.schedules_for(False) == JS.schedules_for(False)
    assert set(TS.HETERO_SCHEDULES) == set(JS.HETERO_SCHEDULES)


# the JAX package's heterogeneous grid (tests/test_hetero_costs.py)
HRNG = random.Random(20260731)


def _rand_costs(N, with_sr):
    vals = dict(
        F=[round(HRNG.uniform(0.1, 5.0), 3) for _ in range(N)],
        B=[round(HRNG.uniform(0.1, 5.0), 3) for _ in range(N)],
        W=[round(HRNG.uniform(0.1, 5.0), 3) for _ in range(N)],
        SR=[round(HRNG.uniform(0.0, 0.3), 3) for _ in range(N - 1)]
        if with_sr else ())
    return TSP.StageCosts(**vals), JSP.StageCosts(**vals)


HGRID = []
for _i in range(30):
    _N = HRNG.randint(1, 5)
    HGRID.append((HRNG.randint(_N, 16), _N, _rand_costs(_N, _i % 2 == 1),
                  HRNG.choice([None, _N, _N + 1, 2 * _N + 3])))


@pytest.mark.parametrize("M,N,costs,mem_limit", HGRID)
def test_hetero_forms_match_jax(M, N, costs, mem_limit):
    tc, jc = costs
    a, w = 2.0, 5.0
    for name, fn in TS.HETERO_SCHEDULES.items():
        jfn = JS.HETERO_SCHEDULES[name]
        kw = (dict(V=2) if name in ("1F1B-I", "1F1B-I-ML") else
              dict(mem_limit=mem_limit) if name == "ZB-AUTO" else {})
        got = _both(lambda: fn(M, N, tc, a, w, **kw),
                    lambda: jfn(M, N, jc, a, w, **kw))
        if got is not None:
            assert _t(got[0]) == _t(got[1]), name
    for drain in ("full", "input", "none"):
        assert TS.hetero_makespan_floor(M, tc, drain) == \
            JS.hetero_makespan_floor(M, jc, drain)
    # a uniform vector delegates to the scalar forms in both
    uc = TSP.StageCosts(F=(1.5,) * N, B=(1.0,) * N, W=(1.0,) * N)
    juc = JSP.StageCosts(F=(1.5,) * N, B=(1.0,) * N, W=(1.0,) * N)
    for name, fn in TS.HETERO_SCHEDULES.items():
        kw = dict(V=2) if name in ("1F1B-I", "1F1B-I-ML") else {}
        got = _both(lambda: fn(M, N, uc, a, w, **kw),
                    lambda: JS.HETERO_SCHEDULES[name](M, N, juc, a, w, **kw))
        if got is not None:
            assert _t(got[0]) == _t(got[1]), name


def _sync(g):
    return _t(g), g.exposed, g.hidden


@pytest.mark.parametrize("M,N,costs,mem_limit", HGRID[:12])
def test_grad_sync_evals_match_jax(M, N, costs, mem_limit):
    tc, jc = costs
    F, B = max(tc.F), max(tc.B_full)
    ar_vec = [0.1 * (i + 1) for i in range(N)]
    for name in ("1f1b", "gpipe", "dapple", "zb-h1", "zb-h2", "zb-auto",
                 "1F1B-AS", "ZB-H1", "DAPPLE", "1F1B-SO"):
        ml = mem_limit if name == "zb-auto" else None
        for ar in (0.25, ar_vec):
            for groups in (1, 3):
                assert _sync(TS.eval_grad_sync(
                    name, M, N, F, B, ar, w_frac=0.4, mem_limit=ml,
                    groups=groups)) == _sync(JS.eval_grad_sync(
                        name, M, N, F, B, ar, w_frac=0.4, mem_limit=ml,
                        groups=groups))
                assert _sync(TS.eval_grad_sync_costs(
                    name, M, N, tc, ar, mem_limit=ml, groups=groups)) == \
                    _sync(JS.eval_grad_sync_costs(
                        name, M, N, jc, ar, mem_limit=ml, groups=groups))
            assert _sync(TS.eval_grad_sync_2bw(name, M, N, F, B, ar,
                                               mem_limit=ml)) == \
                _sync(JS.eval_grad_sync_2bw(name, M, N, F, B, ar,
                                            mem_limit=ml))
        assert TS.canonical_replay_name(name) == \
            JS.canonical_replay_name(name)
    if M >= N:
        for name in ("1f1b-interleaved", "1F1B-I"):
            assert _sync(TS.eval_grad_sync(name, M, N, F, B, ar_vec,
                                           V=2)) == \
                _sync(JS.eval_grad_sync(name, M, N, F, B, ar_vec, V=2))
    ends = [HRNG.uniform(0, 5) for _ in range(N)]
    assert TS.grad_sync_fifo(ends, ar_vec) == JS.grad_sync_fifo(ends, ar_vec)
    with pytest.raises(ValueError):
        TS.eval_grad_sync("1f1b", M, N, F, B, [1.0] * (N + 1))


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------

def _toy(costs, acts=None, weights=None):
    """The reference tests' toy profile, in both packages."""
    acts = acts or [1e6] * len(costs)
    weights = weights or [1e6] * len(costs)
    out = []
    for P in (TP, JP):
        layers = tuple(P.LayerProfile(name=f"l{i}", flops_fwd=c * 1e9,
                                      bytes_weights=w, bytes_act_out=a)
                       for i, (c, a, w) in enumerate(zip(costs, acts,
                                                         weights)))
        out.append(P.NetworkProfile("toy", layers, unit="sample"))
    return out


def _devs(*specs):
    """(port, jax) DeviceSpec lists from the same fields."""
    return ([TH.DeviceSpec(**s) for s in specs],
            [JH.DeviceSpec(**s) for s in specs])


_FAST = dict(name="fast", peak_flops=100e12, hbm_bandwidth=1e12,
             memory_capacity=16e9, link_bandwidth=100e9, efficiency=1.0)
_SLOW = dict(_FAST, name="slow", peak_flops=25e12)
_SLOWLINK = dict(_FAST, name="slowlink", link_bandwidth=1e9)

PARTITION_CASES = [
    pytest.param([1.0] * 12, None, None, [_FAST] * 4, id="uniform-12x4"),
    pytest.param([1.0] * 10, None, None, [_FAST, _SLOW], id="hetero-10"),
    pytest.param([5.0, 1.0, 1.0, 1.0, 1.0, 5.0], None, None, [_FAST] * 3,
                 id="refine-6x3"),
    pytest.param([1.0] * 8, [1e12] * 5 + [1e3] + [1e12] * 2, None,
                 [_SLOWLINK] * 2, id="coarse-8x2"),
    pytest.param([1.0] * 8, None, [7e9, 2e9] + [0.5e9] * 6, [_FAST] * 4,
                 id="memory-8x4"),
    pytest.param([0.3, 2.0, 1.1, 0.7, 4.0, 0.9, 1.3, 2.2, 0.5], None, None,
                 [_FAST, _SLOW, _FAST], id="ragged-9x3"),
]


@pytest.mark.parametrize("costs,acts,weights,devs", PARTITION_CASES)
def test_partitioners_match_jax(costs, acts, weights, devs):
    prof, jprof = _toy(costs, acts, weights)
    tdev, jdev = _devs(*devs)
    cl, jcl = (TH.heterogeneous_cluster(tdev),
               JH.heterogeneous_cluster(jdev))
    for mb in (1, 4):
        for overlap in (True, False):
            for ieh in (True, False):
                assert _t(TPT.dp_partition(prof, cl, mb, overlap,
                                           include_embed_head=ieh)) == \
                    _t(JPT.dp_partition(jprof, jcl, mb, overlap,
                                        include_embed_head=ieh))
            assert _t(TPT.eq1_partition(prof, cl, mb, overlap)) == \
                _t(JPT.eq1_partition(jprof, jcl, mb, overlap))
            assert _t(TPT.coarse_partition(prof, cl, mb, overlap)) == \
                _t(JPT.coarse_partition(jprof, jcl, mb, overlap))
        assert TPT.eq1_targets(prof, cl, mb) == JPT.eq1_targets(jprof, jcl, mb)
        plan = TPT.dp_partition(prof, cl, mb)
        jplan = JPT.dp_partition(jprof, jcl, mb)
        assert _t(plan.cost_vector()) == _t(jplan.cost_vector())
        assert (plan.bottleneck_FB(), plan.balanced_F(), plan.balanced_B(),
                plan.max_boundary_act(), TPT.comm_bound(plan)) == \
            (jplan.bottleneck_FB(), jplan.balanced_F(), jplan.balanced_B(),
             jplan.max_boundary_act(), JPT.comm_bound(jplan))
        assert _t(TPT.intra_layer_refine(prof, cl, plan, mb)) == \
            _t(JPT.intra_layer_refine(jprof, jcl, jplan, mb))
        assert TPT.coarse_cuts(prof, 1e4) == JPT.coarse_cuts(jprof, 1e4)
        for sched, fm, M, ml in (("1f1b", 1, 8, None),
                                 ("zb-h2", 1, 8, None), ("zb-auto", 1, 8, 3),
                                 ("1F1B-SO", 2, 4, None)):
            assert TPT.stage_memory(plan, fm, M, sched, ml) == \
                JPT.stage_memory(jplan, fm, M, sched, ml)
            assert _t(TPT.memory_fine_tune(prof, cl, plan, mb, fm, M,
                                           schedule=sched, mem_limit=ml)) \
                == _t(JPT.memory_fine_tune(jprof, jcl, jplan, mb, fm, M,
                                           schedule=sched, mem_limit=ml))
        if 2 * cl.n <= len(costs):
            iv = TPT.interleaved_partition(prof, cl, mb, 2)
            jiv = JPT.interleaved_partition(jprof, jcl, mb, 2)
            assert _t(iv) == _t(jiv)
            assert _t(iv.device_costs()) == _t(jiv.device_costs())
            assert _t(iv.cost_vector()) == _t(jiv.cost_vector())
            assert TPT.stage_memory(iv, 1, 8) == JPT.stage_memory(jiv, 1, 8)
            assert _t(TPT.memory_fine_tune(prof, cl, iv, mb, 1, 8)) == \
                _t(JPT.memory_fine_tune(jprof, jcl, jiv, mb, 1, 8))
    with pytest.raises(ValueError):
        TPT.dp_partition(prof, TH.homogeneous_cluster(tdev[0],
                                                      len(costs) + 1), 1)


@pytest.mark.parametrize("name", ["TPU_V5E", "H100"])
def test_3d_costing_matches_jax(name):
    """plan_costs_3d, stage_memory_3d and reshard_sr on the reference's
    skewed profile (tests/test_plan3d.py)."""
    dev, jdev = getattr(TH, name), _jdev(name)
    prof, jprof = _toy([1.0, 1.0, 1.0, 8.0, 1.0, 1.0, 1.0, 1.0],
                       acts=[1e4] * 8,
                       weights=[1e6, 1e6, 1e6, 8e6, 1e6, 1e6, 1e6, 1e6])
    for bounds, shards in (([(0, 4), (4, 8)], [(1, 1), (1, 1)]),
                           ([(0, 3), (3, 4), (4, 8)], [(1, 1), (1, 4),
                                                       (1, 1)]),
                           ([(0, 8)], [(2, 2)]),
                           ([(0, 2), (2, 8)], [(2, 1), (1, 2)])):
        for mb in (4, 32):
            assert _t(TPT.plan_costs_3d(prof, dev, bounds, mb, shards)) == \
                _t(JPT.plan_costs_3d(jprof, jdev, bounds, mb, shards))
            assert TPT.stage_memory_3d(prof, bounds, shards, mb) == \
                JPT.stage_memory_3d(jprof, bounds, shards, mb)
    for a, b in (((1, 1), (1, 1)), ((2, 2), (1, 4)), ((1, 4), (1, 4))):
        assert TPT.reshard_sr(1e6, a, b, 1e9) == JPT.reshard_sr(1e6, a, b, 1e9)


# ---------------------------------------------------------------------------
# explorer
# ---------------------------------------------------------------------------

def _balanced(n, flops=1e12, act=1e9):
    out = []
    for P in (TP, JP):
        out.append(P.NetworkProfile("balanced", tuple(
            P.LayerProfile(name=f"l{i}", flops_fwd=flops, bytes_weights=1e6,
                           bytes_act_out=act) for i in range(n)),
            unit="sample"))
    return out


def _explore_cases():
    """(label, (port profile, jax profile), (port cluster, jax cluster),
    minibatch, kwargs) after tests/test_explorer.py and
    tests/test_hetero_costs.py."""
    pp = lambda f: (getattr(TP, f), getattr(JP, f))
    hom = lambda name, n: (TH.homogeneous_cluster(getattr(TH, name), n),
                           JH.homogeneous_cluster(_jdev(name), n))
    het = lambda names: (
        TH.heterogeneous_cluster([getattr(TH, n) for n in names]),
        JH.heterogeneous_cluster([_jdev(n) for n in names]))
    roomy = dict(dataclasses.asdict(TH.TPU_V5E), memory_capacity=1e15,
                 link_bandwidth=1e13, async_capable=True)
    rt, rj = _devs(roomy)
    fast = dict(name="fast", peak_flops=100e12, hbm_bandwidth=1e12,
                memory_capacity=1e15, link_bandwidth=1e15,
                async_capable=True, efficiency=1.0)
    ft, fj = _devs(fast, dict(fast, name="slow", peak_flops=50e12))
    skew = (TH.heterogeneous_cluster([ft[0], ft[1], ft[0], ft[1]]),
            JH.heterogeneous_cluster([fj[0], fj[1], fj[0], fj[1]]))
    llama = (TP.profile_arch(get_config("llama3.2-1b"), seq=1024),
             JP.profile_arch(jax_get_config("llama3.2-1b"), seq=1024))
    return [
        ("resnet50-v100x8", tuple(f() for f in pp("profile_resnet50")),
         hom("V100", 8), 128, {}),
        ("vgg16-v100x4", tuple(f() for f in pp("profile_vgg16")),
         hom("V100", 4), 128, {}),
        ("gnmt8-v100x4", tuple(f(8) for f in pp("profile_gnmt")),
         hom("V100", 4), 256, {}),
        ("resnet50-vcu118x4", tuple(f() for f in pp("profile_resnet50")),
         hom("VCU118", 4), 32, {}),
        ("resnet50-fpga-mix", tuple(f() for f in pp("profile_resnet50")),
         het(["VCU129", "VCU129", "VCU118", "VCU118"]), 32, {}),
        ("gnmt16-v100x2-nodp", tuple(f(16) for f in pp("profile_gnmt")),
         hom("V100", 2), 64, dict(consider_dp=False)),
        ("balanced-interleave", _balanced(16),
         (TH.homogeneous_cluster(rt[0], 4), JH.homogeneous_cluster(rj[0], 4)),
         8, dict(candidate_Ms=[4], consider_dp=False)),
        ("gnmt16-roomy-zb", tuple(f(16) for f in pp("profile_gnmt")),
         (TH.homogeneous_cluster(rt[0], 4), JH.homogeneous_cluster(rj[0], 4)),
         8, dict(candidate_Ms=[4], consider_dp=False, mem_limit=5)),
        ("skewed-hetero", _balanced(7), skew, 8,
         dict(candidate_Ms=[2, 4, 8], consider_dp=False)),
        ("skewed-scalar", _balanced(7), skew, 8,
         dict(candidate_Ms=[2, 4, 8], consider_dp=False, hetero=False)),
        ("llama-h100x4", llama, hom("H100", 4), 8 * 1024,
         dict(candidate_Ms=[1, 2, 4, 8], consider_dp=False)),
        ("llama-tpu-dp2", llama, hom("TPU_V5E", 4), 4 * 1024,
         dict(candidate_Ms=[1, 2, 4], consider_dp=False, dp_degree=2)),
        ("llama-h100-dp2", llama, hom("H100", 2), 4 * 1024,
         dict(candidate_Ms=[1, 2, 4], dp_degree=2)),
    ]


@pytest.mark.parametrize("case", _explore_cases(), ids=lambda c: c[0])
def test_explore_matches_jax(case):
    _, (prof, jprof), (cl, jcl), mb, kw = case
    r, jr = TE.explore(prof, cl, mb, **kw), JE.explore(jprof, jcl, mb, **kw)
    assert _t(r) == _t(jr)
    assert r.speedup_over_dp == jr.speedup_over_dp
    if not kw:
        for M in (2, 8):
            assert _t(TE.gpipe_time(prof, cl, mb, M)) == \
                _t(JE.gpipe_time(jprof, jcl, mb, M))
        assert _t(TE.pipedream_time(prof, cl, mb)) == \
            _t(JE.pipedream_time(jprof, jcl, mb))
        assert _t(TE.dp_time_and_memory(prof, cl, mb)) == \
            _t(JE.dp_time_and_memory(jprof, jcl, mb))


def test_explore3d_matches_jax_on_the_skewed_profile():
    prof, jprof = _toy([1.0, 1.0, 1.0, 8.0, 1.0, 1.0, 1.0, 1.0],
                       acts=[1e4] * 8,
                       weights=[1e6, 1e6, 1e6, 8e6, 1e6, 1e6, 1e6, 1e6])
    for name in ("TPU_V5E", "H100"):
        fleet = TH.homogeneous_fleet(getattr(TH, name), 8)
        jfleet = JH.homogeneous_fleet(_jdev(name), 8)
        r, jr = TE.explore3d(prof, fleet, 64), JE.explore3d(jprof, jfleet, 64)
        assert _t(r.candidates) == _t(jr.candidates)
        assert (_t(r.best), _t(r.incumbent), r.speedup_over_1d) == \
            (_t(jr.best), _t(jr.incumbent), jr.speedup_over_1d)
    with pytest.raises(ValueError):
        TE.explore3d(prof, TH.FleetSpec((TH.H100, TH.V100)), 64)
    with pytest.raises(ValueError):
        TE.explore3d(prof, fleet, 64, schedules=("gpipe",))


# ---------------------------------------------------------------------------
# autoplan
# ---------------------------------------------------------------------------

def _cfgs(arch):
    return get_config(arch), jax_get_config(arch)


@pytest.mark.parametrize("pool", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("device", ["H100", "TPU_V5E"])
def test_auto_plan3d_matches_jax(pool, device):
    cfg, jcfg = _cfgs("llama3.2-1b")
    kw = dict(global_batch=8, seq_len=1024, n_devices=pool)
    got = _both(lambda: TA.auto_plan3d(cfg, device=getattr(TH, device), **kw),
                lambda: JA.auto_plan3d(jcfg, device=_jdev(device), **kw))
    assert got is not None and _t(got[0]) == _t(got[1])
    # and the plan applied to the config
    a, b = got[0].apply(cfg), got[1].apply(jcfg)
    assert (a.stages, a.tensor, a.virtual, a.schedule, a.mem_limit) == \
        (b.stages, b.tensor, b.virtual, b.schedule, b.mem_limit)


@pytest.mark.parametrize("device", ["H100", "TPU_V5E", "V100"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b"])
def test_auto_plan_matches_jax(arch, device):
    cfg, jcfg = _cfgs(arch)
    cases = ((4, 1, 2, 8),) if cfg.ssm else (
        (4, 1, None, 8), (8, 1, 2, 8), (16, 2, None, 16), (4, 1, 1, 8))
    for model_axis, data_axis, mem_limit, batch in cases:
        kw = dict(global_batch=batch, seq_len=1024, model_axis=model_axis,
                  data_axis=data_axis, mem_limit=mem_limit)
        got = _both(
            lambda: TA.auto_plan(cfg, device=getattr(TH, device), **kw),
            lambda: JA.auto_plan(jcfg, device=_jdev(device), **kw))
        assert got is not None
        assert _t(got[0]) == _t(got[1]), kw
        a, b = got[0].apply(cfg), got[1].apply(jcfg)
        assert (a.stages, a.tensor, a.virtual, a.schedule, a.mem_limit) == \
            (b.stages, b.tensor, b.virtual, b.schedule, b.mem_limit)


@pytest.mark.parametrize("names", [["V100", "V100"], ["VCU129", "VCU118"],
                                   ["H100"] * 4, ["TPU_V5E", "V100",
                                                  "TPU_V5E", "V100"]])
def test_auto_plan_on_clusters_matches_jax(names):
    cfg, jcfg = _cfgs("llama3.2-1b")
    for mem_limit in (None, 2):
        kw = dict(global_batch=8, seq_len=1024, model_axis=len(names),
                  data_axis=1, mem_limit=mem_limit)
        a = TA.auto_plan(cfg, devices=[getattr(TH, n) for n in names], **kw)
        b = JA.auto_plan(jcfg, devices=[_jdev(n) for n in names], **kw)
        assert _t(a) == _t(b)
        assert a.stages == len(names) and a.tensor == 1


def test_auto_plan_defaults_to_the_port_card():
    cfg, jcfg = _cfgs("llama3.2-1b")
    kw = dict(global_batch=8, seq_len=1024, model_axis=4, data_axis=1)
    assert _t(TA.auto_plan(cfg, **kw)) == \
        _t(JA.auto_plan(jcfg, device=JH100, **kw))
    with pytest.raises(ValueError):
        TA.auto_plan(get_config("mamba2-2.7b"), global_batch=8,
                     seq_len=1024, model_axis=128, data_axis=1)


@pytest.mark.parametrize("slowdown", [(1.0, 1.0, 1.0, 1.0),
                                      (2.0, 1.0, 1.0, 1.0),
                                      (1.0, 1.3, 0.8, 3.0),
                                      (0.5, 0.5, 4.0, 1.0)])
@pytest.mark.parametrize("device", ["H100", "TPU_V5E"])
def test_replan_matches_jax(slowdown, device):
    """A budget that never binds: the result does not depend on the
    clock."""
    cfg, jcfg = _cfgs("llama3.2-1b")
    dev, jdev = getattr(TH, device), _jdev(device)
    kw = dict(global_batch=16, seq_len=1024)
    inc = TA.auto_plan(cfg, model_axis=4, data_axis=1, device=dev,
                       devices=[dev] * 4, **kw)
    jinc = JA.auto_plan(jcfg, model_axis=4, data_axis=1, device=jdev,
                        devices=[jdev] * 4, **kw)
    assert _t(inc) == _t(jinc)
    got = TA.replan(cfg, inc, budget_s=1e9, device=dev, slowdown=slowdown,
                    **kw)
    want = JA.replan(jcfg, jinc, budget_s=1e9, device=jdev,
                     slowdown=slowdown, **kw)
    assert _t(got) == _t(want)
    assert (got is inc) == (want is jinc)
    assert TA.replan(cfg, inc, budget_s=0.0, slowdown=slowdown, **kw) is inc
    with pytest.raises(ValueError):
        TA.replan(cfg, inc, budget_s=1.0, slowdown=(1.0,), **kw)
    with pytest.raises(ValueError):
        TA._derated(dev, 0.0)


# ---------------------------------------------------------------------------
# drift monitor, planned and measured stage costs
# ---------------------------------------------------------------------------

def test_drift_monitor_matches_jax():
    rnd = random.Random(0)
    seqs = [[[p * (1 + rnd.uniform(-0.05, 0.05)) for p in (1.0, 1.2, 0.9,
                                                          1.1)]
             for _ in range(12)],
            [[3.0, 1.0, 1.0, 1.0]] * 6,
            [[10.0, 1.0]] * 4,
            [[1000.0, 2000.0, 1000.0]] * 5]
    planned = [(1.0, 1.2, 0.9, 1.1), (1.0, 1.0, 1.0, 1.0), (1.0, 1.0),
               (1.0, 2.0, 1.0)]
    for seq, pl in zip(seqs, planned):
        for kw in (dict(), dict(alpha=0.5, threshold=0.1, min_samples=1)):
            mon, jmon = TP.DriftMonitor(planned=pl, **kw), \
                JP.DriftMonitor(planned=pl, **kw)
            assert mon.slowdown() == jmon.slowdown()
            for m in seq:
                assert mon.update(m) == jmon.update(m)
                assert (mon.drift(), mon.should_replan(), mon.slowdown(),
                        mon.ema) == (jmon.drift(), jmon.should_replan(),
                                     jmon.slowdown(), jmon.ema)
    mon = TP.DriftMonitor(planned=(1.0, 1.0))
    for bad in ([1.0], [1.0, 0.0]):
        with pytest.raises(ValueError):
            mon.update(bad)
    with pytest.raises(ValueError):
        TP.DriftMonitor(planned=(1.0, 0.0))
    # from a partition plan's cost vector
    prof, jprof = _toy([0.3, 2.0, 1.1, 0.7, 4.0, 0.9, 1.3, 2.2, 0.5])
    tdev, jdev = _devs(_FAST, _SLOW, _FAST)
    plan = TPT.dp_partition(prof, TH.heterogeneous_cluster(tdev), 2)
    jplan = JPT.dp_partition(jprof, JH.heterogeneous_cluster(jdev), 2)
    assert TP.DriftMonitor.from_plan(plan).planned == \
        JP.DriftMonitor.from_plan(jplan).planned


@pytest.mark.parametrize("arch,S,V", [("llama3.2-1b", 4, 1),
                                      ("llama3.2-1b", 3, 1),
                                      ("llama3.2-1b", 4, 2),
                                      ("mamba2-2.7b", 16, 1),
                                      ("mamba2-2.7b", 5, 3)])
def test_planned_stage_costs_match_jax(arch, S, V):
    cfg, jcfg = _cfgs(arch)
    plan = TST.plan_stages(dataclasses.replace(cfg, tensor=1), S, 1, V)
    for seq in (1024, 4096):
        assert TP.planned_stage_costs(cfg, plan, seq=seq) == \
            JP.planned_stage_costs(jcfg, plan, seq=seq)
    assert TP.stage_layer_kinds(cfg, plan) == \
        JP.stage_layer_kinds(jcfg, plan)


def _jax_proxy(jcfg, seq, kind):
    p0, x, ct, block = JP._block_proxy(jcfg, seq, kind)
    full = jax.jit(lambda p, x, ct: jax.vjp(block, p, x)[1](ct))
    x_only = jax.jit(lambda x, ct: jax.vjp(lambda xx: block(p0, xx), x)[1](ct))
    return (p0, x, ct, np.asarray(jax.jit(block)(p0, x)), full(p0, x, ct),
            x_only(x, ct))


@pytest.mark.parametrize("arch,kind", [("llama3.2-1b", "dense"),
                                       ("deepseek-v2-lite-16b", "moe"),
                                       ("mamba2-2.7b", "ssm")])
def test_block_proxy_matches_jax(arch, kind):
    """The port's proxy function and its input-only and full vjps equal
    the JAX proxy's on the JAX proxy's parameters (1e-5 of max |ref|)."""
    jcfg = jax_get_config(arch).reduced(n_layers=2, d_model=64, seq=32)
    cfg = _port_cfg(jcfg)
    seq = 32
    p0, x, ct, y, (jgp, jgx), (jgx_only,) = _jax_proxy(jcfg, seq, kind)
    tp0, tx, tct, block = TP._block_proxy(cfg, seq, kind, device="cpu")
    assert {k: v.shape for k, v in tp0.items()} == \
        {k: tuple(v.shape) for k, v in p0.items()}
    assert tuple(tx.shape) == x.shape and torch.equal(
        tct, torch.from_numpy(np.array(ct)))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p0.items()}
    x_t, ct_t = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(ct))

    def close(a, b):
        b = np.asarray(b)
        err = np.abs(a.detach().numpy() - b).max()
        assert err <= 1e-5 * np.abs(b).max(), err

    close(block(tp, x_t), y)
    full = TP._vjp(block, tp, x_t, ct_t, True)
    close(full[0], jgx)
    for g, k in zip(full[1:], tp):
        close(g, jgp[k])
    (gx,) = TP._vjp(block, tp, x_t, ct_t, False)
    close(gx, jgx_only)


def test_measured_profiler_on_the_cpu():
    """On ``device="cpu"`` the measured paths time the proxies with the
    host clock; the kinds a config lacks give None, as in the JAX
    package."""
    cfg = get_config("llama3.2-1b").reduced(n_layers=4, d_model=64)
    wf = TP.measure_w_frac(cfg, seq=32, iters=3, device="cpu")
    assert wf is None or 0.0 < wf < 1.0
    assert TP.measure_w_frac(cfg, seq=32, kind="moe", device="cpu") is None
    assert TP.measure_w_frac(cfg, seq=32, kind="ssm", device="cpu") is None
    with pytest.raises(ValueError):
        TP.measure_w_frac(cfg, kind="conv", device="cpu")
    plan = TST.plan_stages(cfg, 2, 1, 1)
    t = TP.measure_stage_times(cfg, plan, seq=16, iters=2, device="cpu")
    assert len(t) == 2 and all(x > 0 for x in t)
    assert t[0] == t[1]         # two dense layers each, one proxy timing
    mcfg = get_config("mamba2-2.7b").reduced(n_layers=2, d_model=64)
    assert TP.measure_block_time(mcfg, seq=16, iters=2, kind="ssm",
                                 device="cpu") > 0
    prof = TP.profile_arch(dataclasses.replace(cfg,
                                               profile_w_frac="measured"),
                           seq=32, device="cpu")
    ana = TP.profile_arch(cfg, seq=32)
    for l, a in zip(prof.layers, ana.layers):
        assert 0.0 < l.w_frac < 1.0
        assert (l.flops_fwd, l.bytes_weights) == (a.flops_fwd,
                                                  a.bytes_weights)


def test_measured_profiler_refuses_a_missing_card():
    """A ``cuda`` request without a card raises; nothing falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal is for machines "
                    "without one")
    cfg = get_config("llama3.2-1b").reduced(n_layers=2, d_model=64)
    for call in (lambda: TP.measure_w_frac(cfg, seq=16),
                 lambda: TP.measure_block_time(cfg, seq=16),
                 lambda: TP.measure_stage_times(cfg, TST.plan_stages(cfg)),
                 lambda: TP.profile_arch(dataclasses.replace(
                     cfg, profile_w_frac="measured"), seq=16)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
