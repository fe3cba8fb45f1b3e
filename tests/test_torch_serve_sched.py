"""The port's continuous batching against the JAX package, on the CPU: the
host half of ``core/serve_sched.py`` (exact), ``n_valid`` in the pipelined
serve step, the engine over it and over the single-device step.

``llama3.2-1b`` reduced to 4 layers, d_model 64, 2 kv heads; weights made
by the JAX package and carried over by ``repro_torch.convert``; prompts
from numpy seeds.  Each engine step's logits agree with the JAX
``make_local_serve_step`` fed the same step plans within atol/rtol 2e-4
(the serve slice's tolerance: the same math summed in another order);
tokens are compared with the port's own solo runs, bit for bit.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import serve_sched as JSS
from repro.models import model as JM
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import serve_sched as SS
from repro_torch.models import model as M
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

TOL = 2e-4
N_SLOTS, CHUNK, MAX_LEN = 8, 4, 32
ARCHS = ("llama3.2-1b", "mamba2-2.7b", "gemma3-1b", "qwen3-1.7b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, leaving the other cores to the
    test files that run beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The host half: exactly the JAX package's output.
# ---------------------------------------------------------------------------

def _drive(mod, reqs, n_slots, chunk, seed):
    """Run ``mod``'s scheduler over ``reqs`` with the engine's admission
    loop and tokens drawn from a seeded rng in place of a model; returns
    every step plan and the retired requests, as plain data."""
    rng = np.random.default_rng(seed)
    s = mod.ServeScheduler(n_slots, chunk)
    pending = sorted(copy.deepcopy(reqs), key=lambda r: (r.arrival, r.rid))
    plans, t = [], 0
    while pending or s.active():
        while pending and pending[0].arrival <= t and s.admit(pending[0], t):
            pending.pop(0)
        sp = s.plan_step()
        if sp.busy:
            plans.append((sp.tokens.tolist(), sp.n_valid.tolist(),
                          [dataclasses.astuple(w) for w in sp.work]))
            s.observe(sp, rng.integers(0, 1000, n_slots), t)
        t += 1
    done = [(r.rid, r.generated, r.t_admit, r.t_first, r.t_done, r.pos)
            for r in s.retired]
    return plans, done


def _host_scheduler():
    rng = np.random.default_rng(5)
    mk = lambda mod: [mod.Request(
        rid=i, prompt=rng.integers(1, 99, int(rng.integers(1, 12))).tolist(),
        max_new=int(rng.integers(1, 5)), arrival=int(a))
        for i, a in enumerate(sorted(rng.integers(0, 12, 9)))]
    reqs = mk(SS)
    jreqs = [JSS.Request(rid=r.rid, prompt=list(r.prompt), max_new=r.max_new,
                         arrival=r.arrival) for r in reqs]
    got = _drive(SS, reqs, 3, 4, seed=1)
    assert got == _drive(JSS, jreqs, 3, 4, seed=1)
    assert len(got[1]) == 9 and any(
        len({w[1] for w in plan[2]} - {"idle"}) > 1 for plan in got[0])


def _host_mixed(V):
    kinds = ["prefill", "decode", "decode", "idle", "prefill", "idle"]

    def run(mod):
        work = [mod.SlotWork(i, k, {"prefill": 4, "decode": 1}.get(k, 0),
                             i if k != "idle" else -1)
                for i, k in enumerate(kinds)]
        plan, roles = mod.mixed_op_table(work, M=2, N=2, V=V)
        ops = [[(op.kind, op.m, op.v) for op in dev] for dev in plan.device_ops]
        return ops, roles, mod.format_mixed_table(plan, roles)

    got = run(SS)
    assert got == run(JSS)
    assert ("F0.1[PDD]" if V > 1 else "F0[PDD]") in got[2]


def _host_budget(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for max_len in (1, 640, 4096):
        for itemsize in (2, 4):
            assert SS.kv_bytes_per_slot(cfg, max_len, itemsize) \
                == JSS.kv_bytes_per_slot(jcfg, max_len, itemsize)
    per = SS.kv_bytes_per_slot(cfg, 640) / cfg.n_layers
    for kw in (dict(n_stages=4), dict(n_stages=0), dict(n_stages=3,
               weight_bytes=per * 5, microbatches=4),
               dict(n_stages=2, itemsize=2, microbatches=2)):
        for limit in (per * 0.5, per * 7.5, per * 100, 80e9):
            assert SS.serve_slot_budget(cfg, 640, limit, **kw) \
                == JSS.serve_slot_budget(jcfg, 640, limit, **kw), (kw, limit)


@pytest.mark.parametrize("case", ["scheduler", "mixed-V1", "mixed-V2"]
                         + [f"budget-{a}" for a in ARCHS])
def test_host_half_equals_jax(case):
    """Step plans (tokens, n_valid, work) and retirements for a seeded
    request set with both fed the same observed tokens; mixed op tables
    (ops and roles) at V 1 and 2; the slot budget on every ported
    config."""
    if case == "scheduler":
        _host_scheduler()
    elif case.startswith("mixed"):
        _host_mixed(int(case[-1]))
    else:
        _host_budget(case[len("budget-"):])


# ---------------------------------------------------------------------------
# n_valid and the kv len scope.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_only_kv_len_leaves_move(arch):
    """``_advance_len`` and ``reset_slot_offsets`` touch the ``kv`` len
    leaves and nothing else (an SSM cache has none); the pipelined step
    with ``n_valid`` advances each slot by its own count."""
    cfg = get_config(arch).reduced(n_layers=2, d_model=64)
    plan = ST.plan_stages(cfg, n_stages=2)
    cache = RT.init_pipeline_cache(cfg, plan, 3, 8, device="cpu")
    for a in ST.tree_leaves(cache):
        a.copy_(torch.arange(a.numel()).reshape(a.shape))
    before = {k: a.clone() for k, a in _flat(cache).items()}
    adv = torch.tensor([1, 2, 3], dtype=torch.int32)
    RT._advance_len(cache, adv)
    SS.reset_slot_offsets(cache, np.array([False, True, False]))
    moved = {"kv/len"} if cfg.family == "dense" else set()
    for k, a in _flat(cache).items():
        if k in moved:
            want = before[k] + adv
            want[..., 1] = 0
            assert torch.equal(a, want)
        else:
            assert torch.equal(a, before[k]), k
    if cfg.family != "dense":
        return
    params = ST.init_stacked_params(cfg, 0, plan, device="cpu")
    step = RT.make_serve_step(cfg, plan, RT.PipelineConfig(n_microbatches=1),
                              q_len=4)
    lens = cache["kv"]["len"].clone()
    nv = torch.tensor([4, 0, 1], dtype=torch.int32)
    lg, _ = step(params, cache, dict(tokens=torch.ones(3, 4, dtype=torch.long),
                                     n_valid=nv))
    assert lg.shape == (3, 1, cfg.padded_vocab(1))
    assert torch.equal(cache["kv"]["len"], lens + nv)


def _flat(tree, pre=""):
    out = {}
    for k, a in tree.items():
        if isinstance(a, dict):
            out.update(_flat(a, f"{pre}{k}/"))
        else:
            out[pre + k] = a
    return out


def test_recurrent_families_refused():
    """ssm and hybrid state is polluted by padded slot columns: the engine
    refuses both, the pipelined step refuses ``n_valid`` for ssm."""
    cfg = get_config("mamba2-2.7b").reduced(n_layers=2, d_model=64)
    for c in (cfg, dataclasses.replace(cfg, family="hybrid")):
        with pytest.raises(ValueError, match="attention-family"):
            SS.ContinuousEngine(c, lambda *a: None, {}, {}, 2, 4)
    plan = ST.plan_stages(cfg, n_stages=2)
    step = RT.make_serve_step(cfg, plan, RT.PipelineConfig(n_microbatches=2),
                              q_len=4)
    with pytest.raises(ValueError, match="n_valid"):
        step({}, {}, dict(tokens=torch.zeros(2, 4, dtype=torch.long),
                          n_valid=torch.ones(2, dtype=torch.int32)))


# ---------------------------------------------------------------------------
# The engine: over the pipelined step against the JAX local step, and the
# invariants of the single-device step.
# ---------------------------------------------------------------------------

def _cfgs(virtual=1):
    over = dict(n_kv_heads=2, stages=2, tensor=1, virtual=virtual)
    kw = dict(n_layers=4, d_model=64)
    return (dataclasses.replace(get_config("llama3.2-1b").reduced(**kw),
                                **over),
            dataclasses.replace(jax_get_config("llama3.2-1b").reduced(**kw),
                                **over))


def _weights(jcfg):
    """JAX-made stacked weights (numpy) and the unstaged tree."""
    jplan = JST.plan_stages(jcfg)
    pnp = jax.tree.map(np.asarray, JST.init_stacked_params(
        jcfg, jax.random.PRNGKey(0), jplan))
    flat = dict(pnp, layers=jax.tree.map(
        lambda a: JST.unstack_chunks(a, jplan)[:jcfg.n_layers],
        pnp["layers"]))
    return pnp, flat


def _requests(vocab, shape=((9, 0), (6, 1), (11, 3), (5, 6)), max_new=4,
              seed=7):
    rng = np.random.default_rng(seed)
    return [SS.Request(rid=i, prompt=rng.integers(0, vocab, pl).tolist(),
                       max_new=max_new, arrival=a)
            for i, (pl, a) in enumerate(shape)]


def _solo(cfg, params, req):
    """One-shot prefill + greedy decode of one request (port, one device)."""
    cache = M.init_cache(cfg, 1, MAX_LEN, device="cpu")
    lg, cache = M.decode_step(cfg, params,
                              dict(tokens=torch.tensor([req.prompt])), cache)
    out = [int(lg[0, -1, :cfg.vocab].argmax())]
    while len(out) < req.max_new:
        lg, cache = M.decode_step(cfg, params,
                                  dict(tokens=torch.tensor([[out[-1]]])), cache)
        out.append(int(lg[0, 0, :cfg.vocab].argmax()))
    return out


class _Recorder(SS.ContinuousEngine):
    """The engine, recording each step's admissions and logits."""

    def __init__(self, *a):
        super().__init__(*a)
        self.trace, self._admitted = [], []
        step = self.step

        def rec(p, c, b):
            lg, c = step(p, c, b)
            self.trace.append((self._admitted, b["tokens"].numpy(),
                               b["n_valid"].numpy(), lg[:, 0].numpy()))
            self._admitted = []
            return lg, c
        self.step = rec

    def _reset_slots(self, slot_ids):
        self._admitted = list(slot_ids)
        super()._reset_slots(slot_ids)


@pytest.mark.parametrize("virtual", [1, 2])
def test_engine_over_pipelined_step(virtual):
    """Staggered requests over the pipelined step (2 stages, V 1 or 2):
    tokens equal to each request's solo run, some step mixes prefill and
    decode, and each step's logits equal the JAX single-device step's fed
    the same step plans (offsets rewound at the same admissions)."""
    cfg, jcfg = _cfgs(virtual)
    pnp, flat = _weights(jcfg)
    plan = ST.plan_stages(cfg)
    step = RT.make_serve_step(cfg, plan, RT.PipelineConfig(n_microbatches=2),
                              q_len=CHUNK)
    cache = RT.init_pipeline_cache(cfg, plan, N_SLOTS, MAX_LEN, device="cpu")
    eng = _Recorder(cfg, step, convert.from_jax(pnp, device="cpu"), cache,
                    N_SLOTS, CHUNK)
    reqs = _requests(cfg.vocab)
    done = eng.run(copy.deepcopy(reqs))
    solo_params = convert.from_jax(flat, device="cpu")
    assert {r.rid: r.generated for r in done} \
        == {r.rid: _solo(cfg, solo_params, r) for r in reqs}
    kinds = [{w.kind for w in sp.work} for sp in eng.step_log]
    assert any({"prefill", "decode"} <= k for k in kinds), kinds

    jstep = JSS.make_local_serve_step(jcfg)
    jparams = jax.tree.map(jnp.asarray, flat)
    jcache = JM.init_cache(jcfg, N_SLOTS, max_len=MAX_LEN)
    for admitted, toks, nv, lg in eng.trace:
        if admitted:
            mask = np.zeros(N_SLOTS, bool)
            mask[admitted] = True
            jcache = JSS.reset_slot_offsets(jcache, mask)
        jlg, jcache = jstep(jparams, jcache, dict(tokens=jnp.asarray(toks),
                                                  n_valid=jnp.asarray(nv)))
        busy = nv > 0
        np.testing.assert_allclose(lg[busy], np.asarray(jlg[:, 0])[busy],
                                   atol=TOL, rtol=TOL)


def _local_engine(cfg, params, n_slots, chunk):
    cache = M.init_cache(cfg, n_slots, MAX_LEN, device="cpu")
    return SS.ContinuousEngine(cfg, SS.make_local_serve_step(cfg), params,
                               cache, n_slots, chunk)


def test_local_engine_invariants():
    """The single-device step under the engine (the JAX tests of
    ``tests/test_decode.py``): chunked prefill gives one-shot prefill's
    tokens; tokens do not depend on arrival order or slot; a slot is
    reused after its request retires; ``run`` returns only the requests
    it retired."""
    cfg, jcfg = _cfgs()
    params = convert.from_jax(_weights(jcfg)[1], device="cpu")
    reqs = _requests(cfg.vocab, ((11, 0), (9, 0), (5, 1), (12, 2)),
                     max_new=3, seed=3)
    solo = {r.rid: _solo(cfg, params, r) for r in reqs}

    def tokens(done):
        return {r.rid: r.generated for r in done}

    one = copy.deepcopy(reqs[0])
    (chunked,) = _local_engine(cfg, params, 2, 4).run([one])   # 4 + 4 + 3
    (oneshot,) = _local_engine(cfg, params, 2, 16).run([copy.deepcopy(
        reqs[0])])
    assert chunked.generated == oneshot.generated == solo[0]

    fwd, rev = copy.deepcopy(reqs), copy.deepcopy(reqs[::-1])
    for t, r in enumerate(rev):
        r.arrival = t
    assert tokens(_local_engine(cfg, params, 4, 4).run(fwd)) \
        == tokens(_local_engine(cfg, params, 4, 4).run(rev)) == solo
    assert [r.slot for r in fwd] == [-1] * 4

    eng = _local_engine(cfg, params, 1, 4)
    first = eng.run(copy.deepcopy(reqs[:2]))
    second = eng.run(copy.deepcopy(reqs[2:3]))
    assert first[1].t_admit > first[0].t_done       # rid 1 reused the slot
    assert tokens(first) == {0: solo[0], 1: solo[1]}
    assert [r.rid for r in second] == [2] and second[0].generated == solo[2]
    assert [r.rid for r in eng.sched.retired] == [0, 1, 2]
