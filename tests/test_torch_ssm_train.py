"""The port's ssm training slice against the JAX package, on the CPU.

* ``ssd_chunked_bwd_ref`` (the SSD scan's gradient by the chunk-parallel
  split, the backward kernel's plain version) against ``jax.vjp`` of the
  JAX model's ``layers._ssd_chunked`` and against torch autograd of
  ``ssd_chunked_ref``, on numpy-made inputs: 1, 2 and 4 chunks, with and
  without an initial state and a final-state gradient; every gradient
  within 1e-4 of its max |ref|.
* ``mamba2-2.7b`` reduced to 2 layers, d_model 64 (4 heads of 32, d_state
  16, chunk 16), seq 32; weights made by the JAX package and carried over
  by ``repro_torch.convert``.  The pipelined step at 2 stages under 1f1b,
  zb-h1, 1f1b-interleaved (V 2) and 1f1b under ``remat='full'`` against
  the JAX ``loss_fn`` and ``jax.grad`` at the JAX harness's bar
  (``tests/harness_pipe.py:96-109``); three AdamW steps against the JAX
  loop; ``train.main --auto-plan`` adopts the JAX explorer's plan.

The backward kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import autoplan as JA
from repro.core import hardware as JH
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as JOPT
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import hardware as TH
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw as OPT
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

L, B, SEQ = 2, 4, 32
LR, STEPS = 1e-2, 3
# (B, T, H, P, N, chunk, seeded): 4, 2 and 1 chunks; seeded runs take an
# initial state and a nonzero final-state gradient
SCAN_CASES = ((2, 32, 3, 8, 16, 8, False), (2, 32, 3, 8, 16, 8, True),
              (1, 48, 2, 16, 8, 16, True), (2, 32, 3, 8, 16, 32, False))
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


# ---------------------------------------------------------------------------
# the scan's gradient
# ---------------------------------------------------------------------------

def _scan_inputs(B_, T_, H_, P_, N_):
    rng = np.random.default_rng(B_ * 1000 + T_ + P_)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(B_, T_, H_, P_),
                dt=np.log1p(np.exp(f(B_, T_, H_))).astype(np.float32),
                A=(-np.exp(f(H_) * 0.5)).astype(np.float32),
                Bm=f(B_, T_, N_), Cm=f(B_, T_, N_), init=f(B_, H_, P_, N_),
                dy=f(B_, T_, H_, P_), dfinal=f(B_, H_, P_, N_))


@pytest.fixture(scope="module")
def scan_ref():
    """Each case's numpy inputs and ``jax.vjp`` of ``_ssd_chunked``."""
    out = {}
    for case in SCAN_CASES:
        B_, T_, H_, P_, N_, chunk, seeded = case
        a = _scan_inputs(B_, T_, H_, P_, N_)
        args = [jnp.asarray(a[k]) for k in ("x", "dt", "A", "Bm", "Cm")]
        fn = (lambda *xs: JL._ssd_chunked(*xs[:5], chunk,
                                          init_state=xs[5])) if seeded \
            else (lambda *xs: JL._ssd_chunked(*xs, chunk))
        if seeded:
            args.append(jnp.asarray(a["init"]))
        (_, fin), vjp = jax.vjp(jax.jit(fn), *args)
        cot = (jnp.asarray(a["dy"]), jnp.asarray(a["dfinal"]) if seeded
               else jnp.zeros_like(fin))
        out[case] = (a, [np.asarray(g) for g in vjp(cot)])
    return out


def _torch_bwd(a, chunk, seeded):
    t = torch.from_numpy
    return SSD.ssd_chunked_bwd(
        t(a["x"]), t(a["dt"]), t(a["A"]), t(a["Bm"]), t(a["Cm"]), t(a["dy"]),
        t(a["dfinal"]) if seeded else None, chunk=chunk,
        init_state=t(a["init"]) if seeded else None)


@pytest.mark.parametrize("case", SCAN_CASES)
def test_bwd_ref_matches_jax_vjp(scan_ref, case):
    a, want = scan_ref[case]
    *_, chunk, seeded = case
    got = _torch_bwd(a, chunk, seeded)
    assert (got[-1] is None) == (not seeded)
    errs = {name: _rel(g.numpy(), w)
            for name, g, w in zip(GRADS, got, want) if g is not None}
    assert len(errs) == 5 + seeded
    assert max(errs.values()) < 1e-4, errs
    assert got[0].dtype == torch.float32 and got[0].shape == a["x"].shape


@pytest.mark.parametrize("case", SCAN_CASES)
def test_bwd_ref_matches_torch_autograd(scan_ref, case):
    a, _ = scan_ref[case]
    *_, chunk, seeded = case
    leaves = [torch.from_numpy(a[k]).requires_grad_()
              for k in ("x", "dt", "A", "Bm", "Cm", "init")]
    y, fin = SSD.ssd_chunked_ref(*leaves[:5], chunk=chunk,
                                 init_state=leaves[5] if seeded else None)
    cot = (torch.from_numpy(a["dy"]), torch.from_numpy(a["dfinal"])
           if seeded else torch.zeros_like(fin))
    want = torch.autograd.grad((y, fin), leaves[:5 + seeded], cot)
    got = _torch_bwd(a, chunk, seeded)
    for name, g, w in zip(GRADS, got, want):
        assert _rel(g.numpy(), w.numpy()) < 1e-4, name


def test_bwd_ref_takes_bf16():
    """bf16 x/Bm/Cm/dy: gradients in bf16 (dt, A, init in f32) within
    3e-2 of the f32 gradient of the same (rounded) values."""
    a = _scan_inputs(1, 32, 2, 16, 8)
    t = lambda k: torch.from_numpy(a[k])
    bf = {k: t(k).bfloat16() for k in ("x", "Bm", "Cm", "dy")}
    got = SSD.ssd_chunked_bwd(bf["x"], t("dt"), t("A"), bf["Bm"], bf["Cm"],
                              bf["dy"], t("dfinal"), chunk=16,
                              init_state=t("init"))
    want = SSD.ssd_chunked_bwd(*(bf[k].float() if k in bf else t(k)
                                 for k in ("x", "dt", "A", "Bm", "Cm",
                                           "dy")),
                               t("dfinal"), chunk=16, init_state=t("init"))
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]
    for name, g, w in zip(GRADS, got, want):
        assert _rel(g.float().numpy(), w.numpy()) < 3e-2, name


# ---------------------------------------------------------------------------
# the reduced mamba2 trained through the pipeline
# ---------------------------------------------------------------------------

def _cfgs():
    kw = dict(stages=1, tensor=1)
    return (dataclasses.replace(
                get_config("mamba2-2.7b").reduced(n_layers=L, d_model=64),
                **kw),
            dataclasses.replace(
                jax_get_config("mamba2-2.7b").reduced(n_layers=L,
                                                      d_model=64), **kw))


@pytest.fixture(scope="module")
def ref():
    """JAX-made weights (unstaged, numpy), the JAX loss and gradients on
    the step-0 batch, and a 3-step JAX AdamW loop."""
    _, jcfg = _cfgs()
    jp = JST.init_stacked_params(jcfg, jax.random.PRNGKey(0),
                                 JST.plan_stages(jcfg))
    rp = dict(embed=jp["embed"], final_norm=jp["final_norm"],
              layers=jax.tree.map(lambda a: a[0], jp["layers"]))
    data = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=SEQ, global_batch=B,
                          seed=0)
    vg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(jcfg, p, b)))
    loss0, grads0 = vg(rp, data.batch(0))
    opt = JOPT.AdamW(lr=JOPT.warmup_cosine(LR, 20, STEPS),
                     weight_decay=0.01)
    p, st, losses = rp, opt.init(rp), []
    update = jax.jit(opt.update)
    for step in range(STEPS):
        loss, g = vg(p, data.batch(step))
        p, st = update(p, g, st)
        losses.append(float(loss))
    np_ = lambda t: jax.tree.map(np.asarray, t)
    return dict(params=np_(rp), loss=float(loss0), grads=np_(grads0),
                losses=losses, final=np_(p))


def _jplan(S, V=1):
    return JST.plan_stages(_cfgs()[1], n_stages=S, virtual=V)


def _stacked(params_np, S, V=1):
    plan = _jplan(S, V)

    def stack(a):
        pad = plan.n_layers_padded - a.shape[0]
        if pad:
            a = np.concatenate([a] + [a[-1:]] * pad)
        return JST._stack_chunks(a, plan)
    return convert.from_jax(dict(
        embed=params_np["embed"], final_norm=params_np["final_norm"],
        layers=jax.tree.map(stack, params_np["layers"])), device="cpu")


def _unstacked(layers_np, S=1, V=1):
    return jax.tree.map(
        lambda a: np.asarray(JST.unstack_chunks(a, _jplan(S, V))), layers_np)


# (schedule, V, M, remat)
TRAIN_RUNS = (("1f1b", 1, 2, "stage"), ("zb-h1", 1, 4, "stage"),
              ("1f1b-interleaved", 2, 2, "stage"), ("1f1b", 1, 2, "full"))


@pytest.mark.parametrize("schedule,V,M,remat", TRAIN_RUNS)
def test_train_step_matches_jax_grad(ref, schedule, V, M, remat):
    cfg = dataclasses.replace(_cfgs()[0], stages=2, virtual=V)
    plan = ST.plan_stages(cfg)
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=M, schedule=schedule, remat=remat))
    batch = SyntheticLM(cfg.vocab, SEQ, B, device="cpu").batch(0)
    loss, grads = step(_stacked(ref["params"], 2, V), batch)
    assert abs(float(loss) - ref["loss"]) < 1e-4
    got = _unstacked(convert.to_jax(grads["layers"]), 2, V)
    errs = jax.tree.map(lambda a, b: _rel(a[:L], b), got,
                        ref["grads"]["layers"])
    assert max(jax.tree.leaves(errs)) < 1e-4, errs
    # every ssm parameter (a_log, dt_bias, d_skip, conv, projections)
    # gets a gradient
    assert set(got["ssm"]) == set(ref["grads"]["layers"]["ssm"])
    emb = np.abs(grads["embed"].numpy() - ref["grads"]["embed"]).max()
    assert emb < 1e-4 * (np.abs(ref["grads"]["embed"]).max() + 1)
    assert _rel(grads["final_norm"].numpy(),
                ref["grads"]["final_norm"]) < 1e-4
    assert max(step.stash_slots) == step.lowering.n_x


def test_optimizer_steps_match_jax_loop(ref):
    """Three 1f1b steps with AdamW against the JAX loop: losses 1e-4,
    parameters 1e-5 relative (the tied embedding included).  A leaf that
    starts at zero (the norms' scales, conv_b, dt_bias) is after three
    steps nothing but AdamW's updates m / sqrt(v), which for an element
    whose gradient is near 0 magnify the gradients' 1e-6 relative
    differences (conv_b: 1.2e-4 of its max); those leaves are held at
    1e-3."""
    cfg = dataclasses.replace(_cfgs()[0], stages=2)
    opt = OPT.AdamW(lr=OPT.warmup_cosine(LR, 20, STEPS), weight_decay=0.01)
    step = RT.make_train_step(cfg, ST.plan_stages(cfg), RT.PipelineConfig(
        n_microbatches=2, schedule="1f1b"), optimizer=opt)
    params = _stacked(ref["params"], 2)
    state = opt.init(params)
    data = SyntheticLM(cfg.vocab, SEQ, B, device="cpu")
    losses = []
    for i in range(STEPS):
        params, state, metrics = step(params, state, data.batch(i))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=1e-4)
    got = convert.to_jax(params)
    got = dict(got, layers=_unstacked(got["layers"], 2))
    for a, b, p0 in zip(jax.tree.leaves(got), jax.tree.leaves(ref["final"]),
                        jax.tree.leaves(ref["params"])):
        assert _rel(a, b) < (1e-3 if not np.any(p0) else 1e-5)


def test_train_cli_auto_plan_adopts_the_jax_plan():
    """``--auto-plan --cluster`` on the reduced mamba2: the port's plan
    equals the JAX explorer's (at the port's H100) and trains."""
    argv = ["--arch", "mamba2-2.7b", "--reduced", "--layers", "4",
            "--d-model", "64", "--batch", "8", "--seq", "32", "--steps",
            "2", "--device", "cpu", "--stages", "2", "--auto-plan",
            "--cluster", "h100,h100"]
    out = ttrain.main(argv)
    jcfg = dataclasses.replace(jax_get_config("mamba2-2.7b").reduced(
        n_layers=4, d_model=64, seq=32), stages=2)
    jh100 = JH.DeviceSpec(**dataclasses.asdict(TH.H100))
    want = JA.auto_plan(jcfg, global_batch=8, seq_len=32, model_axis=2,
                        data_axis=1, devices=[jh100] * 2)
    fields = lambda p: (p.stages, p.tensor, p.n_microbatches, p.schedule,
                        p.virtual, p.data_axis, p.predicted_step_time)
    assert fields(out["plan"]) == fields(want)
    applied = want.apply(jcfg)
    assert (out["stages"], out["virtual"], out["schedule"],
            out["microbatches"]) == (applied.stages, applied.virtual,
                                     applied.schedule, want.n_microbatches)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    # the CPU takes the plain versions: no kernel launches
    assert all(v == 0 for d in out["launches"] for v in d.values())
