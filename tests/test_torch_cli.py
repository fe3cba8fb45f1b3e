"""The port's CLIs build the reference CLIs' model from the same argv, and
the port's attention switches RoPE off as the reference does, on the CPU.

* ``repro_torch.launch.serve`` and ``repro_torch.launch.train`` in one
  process refuse a tensor degree above 1 (the config's own, llama3.2-1b's
  2, or ``--tensor``), naming the world of ranks it needs (data x stages
  x tensor processes), before anything is allocated; ``--tensor 1`` runs
  in one process (the tensor axis on ranks: tests/test_torch_tensor.py).
* ``--layers``/``--d-model`` cut the model only under ``--reduced``, as in
  ``repro.launch.train``; the parsed config is checked, nothing is run.
* With ``rope_theta = 0`` (the reference's static off-switch for learned
  absolute positions) the port's ``gqa_attention`` equals the JAX
  package's on the same numpy-made inputs and weights (f32, 1e-4 as in
  tests/test_torch_layers.py) and has no NaN.
* ``--auto-plan`` (with ``--cluster``, ``--mem-limit``) and
  ``--auto-plan3d --pool`` adopt exactly the plan the JAX package's
  planner makes on the same inputs (the port's ``H100`` handed to it
  field by field) and train under it with the losses of a run given the
  same stages, micro-batches, schedule and V explicitly, bit for bit; a
  plan with tensor or data above 1 is printed, then refused in one
  process before anything is allocated, naming the ranks it needs; the
  reference CLI's usage errors are SystemExit 2.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import autoplan as JA
from repro.core import hardware as JH
from repro.models import layers as L
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import hardware as TH
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_allocation(monkeypatch):
    """Any model set-up after the refusal point fails the test loudly."""
    def boom(*a, **k):
        raise AssertionError("the CLI allocated before refusing")
    for mod, name in ((ST, "init_stacked_params"), (ST, "plan_stages"),
                      (RT, "make_serve_step"), (RT, "make_train_step"),
                      (RT, "init_pipeline_cache")):
        monkeypatch.setattr(mod, name, boom)


_SERVE = ["--arch", "llama3.2-1b", "--stages", "8", "--microbatches", "2",
          "--batch", "8", "--prompt-len", "512", "--gen", "32",
          "--device", "cpu"]
_TRAIN = ["--arch", "llama3.2-1b", "--stages", "4", "--schedule", "1f1b",
          "--microbatches", "4", "--batch", "8", "--seq", "1024",
          "--steps", "3", "--device", "cpu"]


@pytest.mark.parametrize("cli,argv,world", [
    pytest.param(tserve, _SERVE, 16, id="serve"),
    pytest.param(ttrain, _TRAIN, 8, id="train"),
    pytest.param(tserve, _SERVE + ["--tensor", "2"], 16, id="serve-tensor2"),
    pytest.param(ttrain, _TRAIN + ["--tensor", "2"], 8, id="train-tensor2"),
    pytest.param(tserve, ["--arch", "llama3.2-1b", "--reduced", "--tensor",
                          "2", "--device", "cpu"], 2,
                 id="serve-reduced-tensor2"),
    pytest.param(ttrain, ["--arch", "llama3.2-1b", "--reduced", "--tensor",
                          "2", "--steps", "1", "--device", "cpu"], 2,
                 id="train-reduced-tensor2")])
def test_clis_refuse_tensor_parallel_configs(no_allocation, cli, argv,
                                             world):
    """In one process a tensor degree above 1 (the config's own, or
    ``--tensor 2``) raises before anything is allocated, naming the
    world of ranks it needs: data 1 x stages x tensor 2."""
    assert get_config("llama3.2-1b").tensor == 2
    with pytest.raises(ValueError, match=f"tensor 2 = {world} processes on "
                                         f"a \\(data, stage, tensor\\) grid"):
        cli.main(argv)


def test_tensor_1_keeps_the_config_on_one_card():
    cfg = ttrain.build_config(ttrain._parser().parse_args(
        _TRAIN + ["--tensor", "1"]))
    assert (cfg.tensor, cfg.stages, cfg.schedule) == (1, 4, "1f1b")
    assert (cfg.n_layers, cfg.d_model) == (16, 2048)


@pytest.mark.parametrize("extra,want", [
    pytest.param(["--tensor", "1", "--layers", "2", "--d-model", "64"],
                 (16, 2048), id="without-reduced"),
    pytest.param(["--reduced", "--layers", "2", "--d-model", "64"],
                 (2, 64), id="reduced"),
    pytest.param(["--reduced"], (4, 256), id="reduced-defaults")])
def test_train_cli_cuts_depth_and_width_only_when_reduced(extra, want):
    """The JAX CLI applies --layers/--d-model only under --reduced
    (repro/launch/train.py); so does the port's."""
    args = ttrain._parser().parse_args(["--arch", "llama3.2-1b"] + extra)
    cfg = ttrain.build_config(args)
    assert (cfg.n_layers, cfg.d_model) == want
    assert cfg.tensor == 1


def _gqa_params(rng, cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    f = lambda *s: (rng.standard_normal(s) * d ** -0.5).astype(np.float32)
    return dict(wq=f(d, cfg.n_heads * hd), wk=f(d, cfg.n_kv_heads * hd),
                wv=f(d, cfg.n_kv_heads * hd), wo=f(cfg.n_heads * hd, d))


@pytest.mark.parametrize("cached", [False, True])
def test_gqa_attention_without_rope_matches_jax(cached):
    kw = dict(n_kv_heads=2, rope_theta=0.0)
    cfg = dataclasses.replace(
        get_config("llama3.2-1b").reduced(n_layers=2, d_model=128), **kw)
    jcfg = dataclasses.replace(
        jax_get_config("llama3.2-1b").reduced(n_layers=2, d_model=128), **kw)
    rng = np.random.default_rng(7)
    p = _gqa_params(rng, cfg)
    B, T, S = 2, 5, 12
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    length = np.array([0, 4], np.int32)
    pos = (length[:, None] + np.arange(T)[None]).astype(np.int32)
    hd = cfg.resolved_head_dim
    ck, cv = (rng.standard_normal((B, S, cfg.n_kv_heads, hd))
              .astype(np.float32) for _ in range(2))
    jc = (dict(k=jnp.asarray(ck), v=jnp.asarray(cv), len=jnp.asarray(length))
          if cached else None)
    # the port writes the new keys into its cache in place: a fresh copy
    # for every call
    tc = lambda: (dict(k=torch.from_numpy(ck.copy()),
                       v=torch.from_numpy(cv.copy()),
                       len=torch.from_numpy(length)) if cached else None)
    want, _ = L.gqa_attention(p, jnp.asarray(x), jcfg, pos=jnp.asarray(pos),
                              is_global=True, rope_theta=0.0, cache=jc)
    got, _ = TL.gqa_attention(convert.from_jax(p, device="cpu"), torch.from_numpy(x), cfg,
                              pos=torch.from_numpy(pos), rope_theta=0.0,
                              cache=tc())
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # RoPE does act when it is on: the same inputs with the config's theta
    # give another output
    on, _ = TL.gqa_attention(
        convert.from_jax(p, device="cpu"), torch.from_numpy(x),
        dataclasses.replace(cfg, rope_theta=500000.0),
        pos=torch.from_numpy(pos), rope_theta=500000.0, cache=tc())
    assert (on - got).abs().max().item() > 1e-3


# ---------------------------------------------------------------------------
# the planner flags
# ---------------------------------------------------------------------------

_RED = ["--arch", "llama3.2-1b", "--reduced", "--layers", "4", "--d-model",
        "64", "--batch", "8", "--seq", "32", "--steps", "2", "--device",
        "cpu"]
_JH100 = JH.DeviceSpec(**dataclasses.asdict(TH.H100))


def _jax_cfg(stages=0):
    cfg = jax_get_config("llama3.2-1b").reduced(n_layers=4, d_model=64,
                                                seq=32)
    return dataclasses.replace(cfg, stages=stages) if stages else cfg


def _plan_fields(p):
    return (p.stages, p.tensor, p.n_microbatches, p.schedule, p.virtual,
            p.data_axis, p.predicted_step_time)


def _explicit(out) -> list:
    """The flags that give the adopted plan without the planner."""
    return ["--stages", str(out["stages"]), "--virtual", str(out["virtual"]),
            "--schedule", out["schedule"], "--microbatches",
            str(out["microbatches"])]


def test_auto_plan_on_a_cluster_adopts_the_jax_plan():
    out = ttrain.main(_RED + ["--stages", "2", "--auto-plan", "--cluster",
                              "v100,v100"])
    want = JA.auto_plan(_jax_cfg(2), global_batch=8, seq_len=32,
                        model_axis=2, data_axis=1,
                        devices=[JH.V100, JH.V100])
    assert _plan_fields(out["plan"]) == _plan_fields(want)
    applied = want.apply(_jax_cfg(2))
    assert (out["stages"], out["virtual"], out["schedule"],
            out["microbatches"]) == (applied.stages, applied.virtual,
                                     applied.schedule, want.n_microbatches)
    again = ttrain.main(_RED + _explicit(out))
    assert out["losses"] == again["losses"]


def test_auto_plan_takes_mem_limit():
    args = ttrain._parser().parse_args(
        _RED + ["--stages", "2", "--auto-plan", "--cluster", "h100,h100",
                "--mem-limit", "2"])
    cfg = ttrain.build_config(args)
    want = JA.auto_plan(_jax_cfg(2), global_batch=8, seq_len=32,
                        model_axis=2, data_axis=1, devices=[_JH100] * 2,
                        mem_limit=2)
    assert _plan_fields(args.plan) == _plan_fields(want)
    assert args.plan.mem_limit == 2
    assert cfg.mem_limit == want.apply(_jax_cfg(2)).mem_limit


def test_homogeneous_auto_plan_with_tensor_parallel_is_printed_then_refused(
        no_allocation, capsys):
    """The homogeneous ``--auto-plan`` at ``--stages 4`` plans tensor 4:
    in one process it is printed, then refused before anything is
    allocated, naming the 4 ranks it trains on (as it does:
    tests/test_torch_tensor.py)."""
    want = JA.auto_plan(_jax_cfg(4), global_batch=8, seq_len=32,
                        model_axis=4, data_axis=1, device=_JH100)
    assert want.tensor > 1
    with pytest.raises(ValueError, match=f"tensor {want.tensor} = "
                                         f"{want.stages * want.tensor} "
                                         f"processes"):
        ttrain.main(_RED + ["--stages", "4", "--auto-plan"])
    assert (f"auto-plan: stages={want.stages} tensor={want.tensor} "
            f"M={want.n_microbatches} sched={want.schedule}"
            in capsys.readouterr().out)


@pytest.mark.parametrize("pool", [1, 2, 3, 4])
def test_auto_plan3d_trains_its_plan_or_refuses_it(pool, request, capsys):
    """The pool's plan, read from the JAX planner: a one-card plan trains
    with the losses of the same flags given explicitly; a plan with
    tensor or data above 1 is printed, then refused in one process with
    the ranks it needs (it trains as ranks: tests/test_torch_data.py,
    tests/test_torch_tensor.py), before anything is allocated (at the port's H100, pools 2 and 4 buy
    data parallelism, pools 1 and 3 a pipeline)."""
    want = JA.auto_plan3d(_jax_cfg(), global_batch=8, seq_len=32,
                          n_devices=pool, device=_JH100)
    argv = _RED + ["--auto-plan3d", "--pool", str(pool)]
    if want.tensor > 1 or want.data_axis > 1:
        request.getfixturevalue("no_allocation")
        if want.tensor > 1:
            err, match = ValueError, "tensor parallelism runs only as ranks"
        else:
            err, match = ValueError, (f"data {want.data_axis} x "
                                      f"{want.stages} stages: the data axis "
                                      f"runs only as ranks")
        with pytest.raises(err, match=match):
            ttrain.main(argv)
        assert (f"auto-plan3d: stages={want.stages} data={want.data_axis} "
                f"tensor={want.tensor}" in capsys.readouterr().out)
        return
    out = ttrain.main(argv)
    assert _plan_fields(out["plan"]) == _plan_fields(want)
    assert out["plan"].stage_widths == want.stage_widths
    applied = want.apply(_jax_cfg())
    assert (out["stages"], out["schedule"], out["microbatches"]) == \
        (applied.stages, applied.schedule, want.n_microbatches)
    assert out["losses"] == ttrain.main(_RED + _explicit(out))["losses"]


@pytest.mark.parametrize("extra", [
    pytest.param(["--cluster", "v100,v100"], id="cluster-alone"),
    pytest.param(["--auto-plan", "--auto-plan3d", "--pool", "2"],
                 id="both-planners"),
    pytest.param(["--auto-plan", "--stages", "2", "--cluster", "v100,a100"],
                 id="unknown-device"),
    pytest.param(["--auto-plan3d"], id="plan3d-cpu-without-pool"),
    pytest.param(["--auto-plan3d", "--pool", "2", "--mem-limit", "2"],
                 id="mem-limit-without-zb-auto")])
def test_planner_usage_errors_exit_2(extra, no_allocation):
    with pytest.raises(SystemExit) as e:
        ttrain.main(_RED + extra)
    assert e.value.code == 2


def test_drift_flags_stay_refused_under_the_planner(no_allocation):
    with pytest.raises(NotImplementedError,
                       match="checkpoints, reshard and elastic"):
        ttrain.main(_RED + ["--stages", "2", "--auto-plan", "--cluster",
                            "v100,v100", "--drift-every", "2"])
