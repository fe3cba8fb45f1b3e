"""The port's CLIs build the reference CLIs' model from the same argv, and
the port's attention switches RoPE off as the reference does, on the CPU.

* ``repro_torch.launch.serve`` and ``repro_torch.launch.train`` refuse a
  config whose tensor degree is above 1 (llama3.2-1b's is 2) unless
  ``--tensor 1`` is given, by the ROADMAP item's name, before anything is
  allocated.
* ``--layers``/``--d-model`` cut the model only under ``--reduced``, as in
  ``repro.launch.train``; the parsed config is checked, nothing is run.
* With ``rope_theta = 0`` (the reference's static off-switch for learned
  absolute positions) the port's ``gqa_attention`` equals the JAX
  package's on the same numpy-made inputs and weights (f32, 1e-4 as in
  tests/test_torch_layers.py) and has no NaN.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as L
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

_NCCL = "tensor and data parallel over NCCL"


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


@pytest.mark.parametrize("cli,argv", [
    pytest.param(tserve, _SERVE, id="serve"),
    pytest.param(ttrain, _TRAIN, id="train"),
    pytest.param(tserve, _SERVE + ["--tensor", "2"], id="serve-tensor2"),
    pytest.param(ttrain, _TRAIN + ["--tensor", "2"], id="train-tensor2"),
    pytest.param(tserve, ["--arch", "llama3.2-1b", "--reduced", "--tensor",
                          "2", "--device", "cpu"], id="serve-reduced-tensor2"),
    pytest.param(ttrain, ["--arch", "llama3.2-1b", "--reduced", "--tensor",
                          "2", "--steps", "1", "--device", "cpu"],
                 id="train-reduced-tensor2")])
def test_clis_refuse_tensor_parallel_configs(no_allocation, cli, argv):
    assert get_config("llama3.2-1b").tensor == 2
    with pytest.raises(NotImplementedError, match=_NCCL):
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
    got, _ = TL.gqa_attention(convert.from_jax(p), torch.from_numpy(x), cfg,
                              pos=torch.from_numpy(pos), rope_theta=0.0,
                              cache=tc())
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # RoPE does act when it is on: the same inputs with the config's theta
    # give another output
    on, _ = TL.gqa_attention(
        convert.from_jax(p), torch.from_numpy(x),
        dataclasses.replace(cfg, rope_theta=500000.0),
        pos=torch.from_numpy(pos), rope_theta=500000.0, cache=tc())
    assert (on - got).abs().max().item() > 1e-3
