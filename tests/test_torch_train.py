"""The port's training slice against the JAX package, on the CPU.

``llama3.2-1b`` reduced to 4 layers, d_model 64, 4/2 heads; weights made
by the JAX package and carried over by ``repro_torch.convert``; batches
from both packages' ``SyntheticLM`` (bit-identical).  The bar is the JAX
harness's (``tests/harness_pipe.py:96-109``): loss within 1e-4, worst
layer-gradient error (max-abs over max-abs) below 1e-4, the embedding
gradient within 1e-4 (max |ref| + 1).  The port's pipelined step, for
every schedule builder at 1, 2 and 3 stages (3 stages pad the 4 layers to
6; the interleaved builders run V = 2 chunks a stage, which pads 4 layers
to 6 virtual stages at 3 stages), ``zb-auto`` under a ``mem_limit`` and
``remat='full'`` under three of them, is held against the JAX package's
non-pipelined ``loss_fn`` and ``jax.grad``; three AdamW steps against a
JAX loop of ``value_and_grad`` and ``AdamW.update`` (losses 1e-4,
parameters 1e-5 relative).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import schedplan as JSP
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.optim import adamw as JOPT
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import schedplan as SP
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.optim import adamw as OPT
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

L, B, SEQ, M_ = 4, 4, 16, 2
LR, STEPS = 1e-2, 3
# "name:K" is zb-auto under mem_limit K (the JAX harness's suffix),
# "name+full" the schedule under remat='full'
SCHEDULES = ("gpipe", "1f1b", "dapple", "zb-h1", "zb-h2", "zb-auto",
             "zb-auto:2", "1f1b-interleaved", "1f1b-interleaved-memlean",
             "1f1b+full", "zb-h1+full", "1f1b-interleaved+full")


def _case(schedule: str, S: int):
    """(PipelineConfig, V, batch) of a SCHEDULES entry at S stages: V 2
    for the interleaved builders with M >= S (and M % S == 0 for
    memlean), M 4 for the zero-bubble ones, M 2 otherwise; the batch is
    2 rows a micro-batch up to 4 rows, 6 rows for M 3."""
    name, _, remat = schedule.partition("+")
    name, _, cap = name.partition(":")
    V = 2 if "interleaved" in name else 1
    M = max(M_, S) if V > 1 else 4 if name.startswith("zb") else M_
    pcfg = RT.PipelineConfig(n_microbatches=M, schedule=name,
                             mem_limit=int(cap or 0),
                             remat=remat or "stage")
    return pcfg, V, 6 if M == 3 else B


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    kw = dict(n_kv_heads=2, stages=1, tensor=1)
    return (dataclasses.replace(
                get_config("llama3.2-1b").reduced(n_layers=L, d_model=64),
                **kw),
            dataclasses.replace(
                jax_get_config("llama3.2-1b").reduced(n_layers=L,
                                                      d_model=64), **kw))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.fixture(scope="module")
def ref():
    """JAX-made weights (unstaged, numpy), the JAX loss and gradients on
    the step-0 batch of B rows (and of 6 rows, ``by_batch``), and a
    3-step JAX AdamW loop."""
    _, jcfg = _cfgs()
    jp = JST.init_stacked_params(jcfg, jax.random.PRNGKey(0),
                                 JST.plan_stages(jcfg))
    rp = dict(embed=jp["embed"], final_norm=jp["final_norm"],
              layers=jax.tree.map(lambda a: a[0], jp["layers"]))
    data = JaxSyntheticLM(vocab=jcfg.vocab, seq_len=SEQ, global_batch=B,
                          seed=0)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b)))
    loss0, grads0 = vg(rp, data.batch(0))
    loss6, grads6 = vg(rp, JaxSyntheticLM(vocab=jcfg.vocab, seq_len=SEQ,
                                          global_batch=6, seed=0).batch(0))
    opt = JOPT.AdamW(lr=JOPT.warmup_cosine(LR, 20, STEPS),
                     weight_decay=0.01)
    p, st, losses = rp, opt.init(rp), []
    for step in range(STEPS):
        loss, g = vg(p, data.batch(step))
        p, st = opt.update(p, g, st)
        losses.append(float(loss))
    np_ = lambda t: jax.tree.map(np.asarray, t)
    return dict(params=np_(rp), loss=float(loss0), grads=np_(grads0),
                by_batch={B: (float(loss0), np_(grads0)),
                          6: (float(loss6), np_(grads6))},
                losses=losses, final=np_(p), opt=np_(st))


def _jplan(S, V=1):
    return JST.plan_stages(_cfgs()[1], n_stages=S, virtual=V)


def _stacked(params_np, S, V=1):
    """The unstaged JAX weights stacked [S, Lps, ...] (or [S, V, Lc, ...])
    for the port by the JAX package's stacking; padded slots repeat the
    last layer (the ``active`` mask skips them)."""
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


# ---------------------------------------------------------------------------
# the schedule-plan IR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("gpipe", "1f1b", "1f1b-2x", "dapple",
                                  "zb-h1", "ZB-H1", "DAPPLE"))
@pytest.mark.parametrize("M,N", [(1, 1), (2, 1), (4, 2), (2, 4), (4, 4),
                                 (8, 3)])
def test_tick_tables_match_jax(name, M, N):
    got = SP.lower_to_ticks(SP.build_schedule(name, M, N))
    want = JSP.lower_to_ticks(JSP.build_schedule(name, M, N))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    plan = SP.build_schedule(name, M, N)
    assert plan.has_w == (SP.canonical_name(name) == "zb-h1")


@pytest.mark.parametrize("schedule", ["zb-h2", "zb-auto", "zb-auto:2",
                                      "1f1b-interleaved",
                                      "1f1b-interleaved-memlean"])
def test_train_step_replays_the_jax_tables(schedule):
    """The builders the port once refused: the train step replays the
    JAX package's table for its config (V 2 for the interleaved ones,
    the cap for zb-auto)."""
    pcfg, V, _ = _case(schedule, 2)
    cfg = dataclasses.replace(_cfgs()[0], stages=2, virtual=V)
    step = RT.make_train_step(cfg, ST.plan_stages(cfg), pcfg)
    want = JSP.lower_to_ticks(JSP.build_schedule(
        pcfg.schedule, pcfg.n_microbatches, 2, V,
        mem_limit=pcfg.mem_limit or None))
    assert dataclasses.asdict(step.lowering) == dataclasses.asdict(want)
    assert step.lowering.V == V


# ---------------------------------------------------------------------------
# data and optimizer
# ---------------------------------------------------------------------------

def test_synthetic_batches_bit_identical():
    jd = JaxSyntheticLM(vocab=1000, seq_len=33, global_batch=5, seed=7)
    td = SyntheticLM(vocab=1000, seq_len=33, global_batch=5, seed=7,
                     device="cpu")
    for step in range(3):
        a, b = td.batch(step), jd.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == torch.int32
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_adamw_matches_jax():
    """warmup_cosine, global-norm clipping (active: the norm is > 1) and
    three AdamW updates on numpy-made trees, rel 1e-6."""
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = dict(a=f(3, 4), b=dict(c=f(5), d=f(2, 2, 2)))
    grads = [dict(a=f(3, 4) * 3, b=dict(c=f(5), d=f(2, 2, 2) * 0.1))
             for _ in range(3)]
    jopt = JOPT.AdamW(lr=JOPT.warmup_cosine(0.1, 2, 3))
    topt = OPT.AdamW(lr=OPT.warmup_cosine(0.1, 2, 3))
    jp, jst = params, jopt.init(params)
    tp = convert.from_jax(params, device="cpu")
    tst = topt.init(tp)
    for g in grads:
        jp, jst = jopt.update(jp, g, jst)
        tp, tst = topt.update(tp, convert.from_jax(g, device="cpu"), tst)
    assert int(tst["step"]) == int(jst["step"]) == 3
    got, want = convert.to_jax(dict(p=tp, m=tst["m"], v=tst["v"])), \
        jax.tree.map(np.asarray, dict(p=jp, m=jst["m"], v=jst["v"]))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert _rel(a, b) < 1e-6
    for step in (0, 1, 2, 5):
        s = torch.tensor(step, dtype=torch.int32)
        assert abs(float(OPT.warmup_cosine(0.1, 2, 5)(s))
                   - float(JOPT.warmup_cosine(0.1, 2, 5)(step))) < 1e-8
    n_t = OPT.global_norm(convert.from_jax(grads[0], device="cpu"))
    assert abs(float(n_t) - float(JOPT.global_norm(grads[0]))) < 1e-5
    clipped, _ = OPT.clip_by_global_norm(convert.from_jax(grads[0], device="cpu"), 1.0)
    assert abs(float(OPT.global_norm(clipped)) - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# the pipelined train step against loss_fn and jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("S", [1, 2, 3])
def test_train_step_matches_jax_grad(ref, schedule, S):
    pcfg, V, rows = _case(schedule, S)
    cfg = dataclasses.replace(_cfgs()[0], stages=S, virtual=V)
    plan = ST.plan_stages(cfg)
    step = RT.make_train_step(cfg, plan, pcfg)
    batch = SyntheticLM(cfg.vocab, SEQ, rows, device="cpu").batch(0)
    loss, grads = step(_stacked(ref["params"], S, V), batch)
    ref_loss, ref_grads = ref["by_batch"][rows]
    assert abs(float(loss) - ref_loss) < 1e-4
    got = _unstacked(convert.to_jax(grads["layers"]), S, V)
    errs = jax.tree.map(lambda a, b: _rel(a[:L], b), got,
                        ref_grads["layers"])
    assert max(jax.tree.leaves(errs)) < 1e-4, errs
    pads = [a[L:] for a in jax.tree.leaves(got)]
    assert all(not np.any(p) for p in pads)          # padded slots: zeros
    emb = np.abs(grads["embed"].numpy() - ref_grads["embed"]).max()
    assert emb < 1e-4 * (np.abs(ref_grads["embed"]).max() + 1)
    assert _rel(grads["final_norm"].numpy(),
                ref_grads["final_norm"]) < 1e-4
    # the stash holds the schedule's peak-live residuals
    assert max(step.stash_slots) == step.lowering.n_x
    assert step.stash_slots == [max(row) + 1 for row in step.lowering.xw]


def test_optimizer_steps_match_jax_loop(ref):
    """Three steps of the pipelined step with AdamW (1f1b, 2 stages)
    against the JAX loop; the final parameters and moments carried back
    through convert.  Losses 1e-4, parameters 1e-5 relative."""
    cfg = dataclasses.replace(_cfgs()[0], stages=2)
    plan = ST.plan_stages(cfg)
    opt = OPT.AdamW(lr=OPT.warmup_cosine(LR, 20, STEPS), weight_decay=0.01)
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=M_, schedule="1f1b"), optimizer=opt)
    params = _stacked(ref["params"], 2)
    state = opt.init(params)
    data = SyntheticLM(cfg.vocab, SEQ, B, device="cpu")
    losses = []
    for i in range(STEPS):
        params, state, metrics = step(params, state, data.batch(i))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=1e-4)
    got = convert.to_jax(dict(params=params, m=state["m"], v=state["v"],
                              step=state["step"]))
    assert int(got["step"]) == int(ref["opt"]["step"]) == STEPS
    for key, want in (("params", ref["final"]), ("m", ref["opt"]["m"]),
                      ("v", ref["opt"]["v"])):
        tree = dict(got[key], layers=_unstacked(got[key]["layers"]))
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
            assert _rel(a, b) < 1e-5, key
    # and the state goes back to the port unchanged
    back = convert.from_jax(got, device="cpu")
    assert back["step"].dtype == torch.int32
    assert torch.equal(back["m"]["embed"], state["m"]["embed"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_cli_loss_falls(tmp_path):
    out = tmp_path / "losses.json"
    res = ttrain.main(["--arch", "llama3.2-1b", "--reduced", "--layers", "2",
                       "--d-model", "64", "--stages", "2", "--microbatches",
                       "2", "--batch", "4", "--seq", "32", "--steps", "30",
                       "--lr", "6e-3", "--log-every", "10", "--device",
                       "cpu", "--losses-out", str(out)])
    losses = res["losses"]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert json.loads(out.read_text())["losses"] == losses
    assert res["stash_slots"] == [2, 1] and res["n_x"] == 2
    assert res["peak_gib"] is None          # no device number on the CPU


_TINY = ["--arch", "llama3.2-1b", "--reduced", "--layers", "4",
         "--d-model", "64", "--stages", "2", "--batch", "4", "--seq", "16",
         "--device", "cpu"]


def test_train_cli_interleaved_loss_falls():
    """``--virtual 2`` (once refused): the streaming interleave trains
    and its loss falls; the stash is the table's n_x."""
    res = ttrain.main(_TINY + ["--virtual", "2", "--schedule",
                               "1f1b-interleaved", "--microbatches", "2",
                               "--steps", "30", "--lr", "6e-3",
                               "--log-every", "10"])
    losses = res["losses"]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    want = JSP.lower_to_ticks(JSP.build_schedule("1f1b-interleaved", 2, 2, 2))
    assert max(res["stash_slots"]) == res["n_x"] == want.n_x


@pytest.mark.parametrize("argv", [
    ["--mem-limit", "3"], ["--schedule", "1f1b", "--mem-limit", "3"],
    ["--schedule", "zb-h2", "--mem-limit", "2"]])
def test_train_cli_mem_limit_needs_zb_auto_as_jax(argv):
    """``--mem-limit`` (once refused) without ``--schedule zb-auto`` is a
    usage error in both CLIs, before anything is built."""
    base = ["--arch", "llama3.2-1b", "--reduced", "--steps", "1"]
    with pytest.raises(SystemExit) as jexit:
        jtrain.main(base + argv)
    with pytest.raises(SystemExit) as texit:
        ttrain.main(base + ["--device", "cpu"] + argv)
    assert texit.value.code == jexit.value.code == 2


def test_train_cli_zb_auto_mem_limit_runs():
    """``--schedule zb-auto --mem-limit 2``: the capped table runs, each
    stage holds at most 2 residuals, and the losses are the 1f1b run's."""
    common = _TINY + ["--microbatches", "4", "--steps", "2"]
    capped = ttrain.main(common + ["--schedule", "zb-auto", "--mem-limit",
                                   "2"])
    plain = ttrain.main(common + ["--schedule", "1f1b"])
    assert capped["n_x"] == 2 and max(capped["stash_slots"]) == 2
    want = JSP.lower_to_ticks(JSP.build_schedule("zb-auto", 4, 2,
                                                 mem_limit=2))
    assert capped["n_x"] == want.n_x
    np.testing.assert_allclose(capped["losses"], plain["losses"], rtol=0,
                               atol=1e-5)


def test_train_cli_remat_full_and_unknown_remat():
    """``--remat full`` (once refused) trains to the losses of the stage
    recompute; an unknown value raises ValueError, as in the JAX
    runtime."""
    common = _TINY + ["--microbatches", "2", "--steps", "2"]
    full = ttrain.main(common + ["--remat", "full"])
    stage = ttrain.main(common + ["--remat", "stage"])
    np.testing.assert_allclose(full["losses"], stage["losses"], rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="unknown remat"):
        ttrain.main(common + ["--remat", "bogus"])


@pytest.mark.parametrize("schedule,per_layer_mb", [
    ("1f1b", (1, 1, 0)), ("1f1b+full", (1, 2, 0)),
    ("zb-h1", (1, 1, 1)), ("zb-h1+full", (1, 2, 2))])
def test_remat_full_attention_calls(monkeypatch, schedule, per_layer_mb):
    """The attention calls a step makes, per layer and micro-batch: F
    ticks once, B ticks once, plus once more under remat='full' (the
    layer's forward re-runs inside the backward); W ticks the same
    again.  On the card each call is one flash forward launch (the F
    ticks' without statistics, the others' with them)."""
    f, b, w = per_layer_mb
    calls = []
    attend = TL.attend
    monkeypatch.setattr(TL, "attend",
                        lambda *a, **k: calls.append(1) or attend(*a, **k))
    pcfg, V, rows = _case(schedule, 2)
    cfg = dataclasses.replace(_cfgs()[0], stages=2)
    step = RT.make_train_step(cfg, ST.plan_stages(cfg), pcfg)
    params = ST.init_stacked_params(cfg, 0, ST.plan_stages(cfg),
                                    device="cpu")
    step(params, SyntheticLM(cfg.vocab, SEQ, rows, device="cpu").batch(0))
    assert len(calls) == L * pcfg.n_microbatches * (f + b + w)


@pytest.mark.parametrize("flag", [
    ["--data", "2"], ["--tensor", "2"],
    ["--grad-sync", "overlap"],
    ["--grad-sync", "2bw"], ["--ar-groups", "2"],
    ["--ckpt", "x"], ["--ckpt-every", "2"],
    ["--resume", "x"], ["--die-at", "3"], ["--drift-every", "2"],
    ["--drift-threshold", "0.5"], ["--drift-inject", "1,2"],
    ["--replan-budget", "1"],
    # planner runs whose plans need tensor or data parallelism (the
    # planner itself is ported: tests/test_torch_planner.py)
    ["--auto-plan", "--stages", "4"], ["--auto-plan3d", "--pool", "4"],
    ["--auto-plan3d", "--pool", "8"], ["--auto-plan", "--stages", "2"]])
def test_train_cli_refuses_unported_flags(flag):
    """The flags of items still to port raise by their ROADMAP item.  The
    data and tensor axes are ported (tests/test_torch_data.py,
    tests/test_torch_tensor.py): in one process ``--data 2``,
    ``--tensor 2`` and the planner's data and tensor plans name the
    ranks they need, the sync knobs raise as the JAX runtime does where
    they cannot run (overlap and ar_groups need the stream runtime), and
    ``--grad-sync 2bw`` trains."""
    argv = ["--arch", "llama3.2-1b", "--reduced", "--steps", "1",
            "--device", "cpu"] + flag
    if flag == ["--grad-sync", "2bw"]:
        assert len(ttrain.main(argv)["losses"]) == 1
        return
    tensor = (ValueError, "tensor parallelism runs only as ranks")
    err, match = {("--data", "2"): (ValueError, "runs only as ranks"),
                  ("--tensor", "2"): tensor,
                  ("--auto-plan", "--stages", "4"): tensor,
                  ("--auto-plan", "--stages", "2"): tensor,
                  ("--auto-plan3d", "--pool", "8"): tensor,
                  ("--grad-sync", "overlap"): (ValueError,
                                               "requires runtime='stream'"),
                  ("--ar-groups", "2"): (ValueError, "OVERLAPPED AR"),
                  ("--auto-plan3d", "--pool", "4"): (
                      ValueError, "data 4 x 1 stages: the data axis runs "
                                  "only as ranks")}.get(
        tuple(flag), (NotImplementedError, "ROADMAP"))
    with pytest.raises(err, match=match):
        ttrain.main(argv)


def test_train_step_refuses_unported_configs():
    cfg = dataclasses.replace(_cfgs()[0], stages=2)
    plan = ST.plan_stages(cfg)
    # the scheduled sync needs the stream runtime (as in the JAX runtime);
    # tensor parallelism runs only as ranks; fsdp is still to port
    for kw in (dict(grad_sync="overlap"), dict(ar_groups=2)):
        with pytest.raises(ValueError, match="runtime='stream'"):
            RT.make_train_step(cfg, plan, RT.PipelineConfig(**kw))
    with pytest.raises(ValueError, match="runs only as ranks"):
        RT.make_train_step(cfg, dataclasses.replace(plan, tensor=2),
                           RT.PipelineConfig())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RT.make_train_step(dataclasses.replace(cfg, fsdp=True), plan,
                           RT.PipelineConfig())
    # the SSD kernel has its backward: mamba2's step builds (and trains:
    # tests/test_torch_ssm_train.py)
    mcfg = get_config("mamba2-2.7b").reduced(n_layers=2, d_model=64)
    step = RT.make_train_step(mcfg, ST.plan_stages(mcfg), RT.PipelineConfig())
    assert step.lowering.n_x >= 1


def test_train_step_takes_mem_limit_and_virtual():
    """What the port once refused, taken as the JAX runtime takes it:
    ``mem_limit`` caps zb-auto and is ignored by other schedules; V 2
    resolves ``auto`` to the streaming interleave and refuses a
    non-interleaved schedule."""
    cfg = dataclasses.replace(_cfgs()[0], stages=2)
    plan = ST.plan_stages(cfg)
    capped = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=4, schedule="zb-auto", mem_limit=2))
    assert capped.lowering.n_x == 2
    plain = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=4, schedule="1f1b", mem_limit=2))
    assert dataclasses.asdict(plain.lowering) == dataclasses.asdict(
        JSP.lower_to_ticks(JSP.build_schedule("1f1b", 4, 2)))
    iplan = ST.plan_stages(cfg, virtual=2)
    auto = RT.make_train_step(cfg, iplan, RT.PipelineConfig(
        n_microbatches=2))
    assert (auto.lowering.schedule, auto.lowering.V) == \
        ("1f1b-interleaved", 2)
    with pytest.raises(ValueError, match="interleaved"):
        RT.make_train_step(cfg, iplan, RT.PipelineConfig(
            n_microbatches=2, schedule="1f1b"))
