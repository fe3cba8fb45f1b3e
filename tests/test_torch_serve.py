"""The port's whole serving slice against the JAX package, on the CPU,
plus the port's import isolation.

``llama3.2-1b`` reduced to 4 layers, d_model 128, 2 kv heads; weights made
by the JAX package and carried over by ``repro_torch.convert``; prompts
and teacher-forced decode tokens made with numpy.  f32 logits agree
within atol/rtol 2e-4: the same math, but XLA and PyTorch sum the
matmuls, norms and softmax in a different order, and the error grows
through 4 layers and the vocab-wide head.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_mesh
from repro.models import model as M
from repro.pipeline import runtime as JRT
from repro.pipeline import stage as JST
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve as tserve
from repro_torch.pipeline import runtime as RT
from repro_torch.pipeline import stage as ST

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-4
B, PROMPT, GEN = 4, 8, 4
MAX_LEN = PROMPT + GEN


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, leaving the other cores to the
    test files that run beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(stages):
    base = dict(n_kv_heads=2, stages=stages, tensor=1)
    cfg = dataclasses.replace(
        get_config("llama3.2-1b").reduced(n_layers=4, d_model=128), **base)
    jcfg = dataclasses.replace(
        jax_get_config("llama3.2-1b").reduced(n_layers=4, d_model=128), **base)
    return cfg, jcfg


def _tokens(cfg):
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, (B, GEN)).astype(np.int32)
    return prompt, forced


def _port_serve(cfg, params_np, prompt, forced, schedule="auto"):
    """Prefill, then GEN teacher-forced decode steps through the port's
    pipelined serve step; the logits of every step [B, V]."""
    plan = ST.plan_stages(cfg)
    pcfg = RT.PipelineConfig(n_microbatches=2, schedule=schedule)
    prefill = RT.make_serve_step(cfg, plan, pcfg, q_len=PROMPT)
    decode = RT.make_serve_step(cfg, plan, pcfg, q_len=1)
    params = convert.from_jax(params_np, device="cpu")
    cache = RT.init_pipeline_cache(cfg, plan, B, MAX_LEN, device="cpu")
    lg, cache = prefill(params, cache, dict(tokens=torch.from_numpy(prompt)))
    out = [lg[:, 0]]
    for t in range(GEN):
        tok = torch.from_numpy(forced[:, t:t + 1])
        lg, cache = decode(params, cache, dict(tokens=tok))
        out.append(lg[:, 0])
    assert lg.shape == (B, 1, cfg.padded_vocab(1)) and lg.dtype == torch.float32
    assert (cache["kv"]["len"] == PROMPT + GEN).all()
    return [o.numpy() for o in out]


def _stacked_np(jcfg):
    jplan = JST.plan_stages(jcfg)
    params = JST.init_stacked_params(jcfg, jax.random.PRNGKey(0), jplan)
    return jplan, jax.tree.map(np.asarray, params)


def test_pipelined_serve_matches_jax_decode_step():
    """Port at stages = 2 (the ring executor) vs the JAX single-device
    M.decode_step: prefill + 4 decode steps."""
    cfg, jcfg = _cfgs(stages=2)
    jplan, pnp = _stacked_np(jcfg)
    prompt, forced = _tokens(cfg)
    got = _port_serve(cfg, pnp, prompt, forced)

    unstack = lambda a: JST.unstack_chunks(a, jplan)[:jcfg.n_layers]
    rp = dict(pnp, layers=jax.tree.map(unstack, pnp["layers"]))
    step = jax.jit(lambda p, b, c: M.decode_step(jcfg, p, b, c))
    cache = M.init_cache(jcfg, B, max_len=MAX_LEN)
    lg, cache = step(rp, dict(tokens=jnp.asarray(prompt)), cache)
    want = [np.asarray(lg[:, -1])]
    for t in range(GEN):
        lg, cache = step(rp, dict(tokens=jnp.asarray(forced[:, t:t + 1])),
                         cache)
        want.append(np.asarray(lg[:, 0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


def test_serve_step_matches_jax_serve_step():
    """Port at stages = 1 vs JAX RT.make_serve_step on a 1x1x1 mesh."""
    cfg, jcfg = _cfgs(stages=1)
    jplan, pnp = _stacked_np(jcfg)
    prompt, forced = _tokens(cfg)
    got = _port_serve(cfg, pnp, prompt, forced)

    mesh = make_mesh((1, 1, 1), ("data", "stage", "tensor"))
    pcfg = JRT.PipelineConfig(n_microbatches=2)
    kw = dict(max_len=MAX_LEN, global_batch=B)
    prefill, _, _, _ = JRT.make_serve_step(jcfg, mesh, jplan, pcfg,
                                           q_len=PROMPT, **kw)
    decode, _, _, _ = JRT.make_serve_step(jcfg, mesh, jplan, pcfg, **kw)
    params = jax.tree.map(jnp.asarray, pnp)
    cache = JRT.init_pipeline_cache(jcfg, jplan, B, MAX_LEN)
    lg, cache = prefill(params, cache, dict(tokens=jnp.asarray(prompt)))
    want = [np.asarray(lg[:, 0])]
    for t in range(GEN):
        lg, cache = decode(params, cache,
                           dict(tokens=jnp.asarray(forced[:, t:t + 1])))
        want.append(np.asarray(lg[:, 0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


def test_schedules_and_depths_agree():
    """gpipe and 1f1b orders, and 1, 2 or 4 stages, give the same logits
    (the ring only reorders the same per-row work)."""
    _, jcfg = _cfgs(stages=1)
    _, pnp = _stacked_np(jcfg)
    cfg1, _ = _cfgs(stages=1)
    prompt, forced = _tokens(cfg1)
    ref = _port_serve(cfg1, pnp, prompt, forced)
    flat = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), pnp["layers"])
    for stages, sched in ((2, "gpipe"), (4, "1f1b")):
        cfg, _ = _cfgs(stages)
        plan = ST.plan_stages(cfg)
        p = dict(pnp, layers=jax.tree.map(
            lambda a: ST._stack_chunks(a, plan), flat))
        for g, w in zip(_port_serve(cfg, p, prompt, forced, sched), ref):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_serve_cli_counts_attention_calls():
    """The CLI on the CPU: tokens of the right shape, and the attention
    wrapper's kernel counter untouched (a CPU tensor takes the plain
    version, never the kernel).  ``--virtual 2`` (interleaved prefill,
    then the restack handoff) gives the V = 1 run's tokens."""
    before = FA.flash_attend.launches
    argv = ["--arch", "llama3.2-1b", "--reduced", "--stages", "2",
            "--batch", "4", "--prompt-len", "8", "--gen", "3",
            "--device", "cpu"]
    out = tserve.main(argv)
    assert out["tokens"].shape == (4, 3)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 1024)).all()
    assert torch.isfinite(out["last_logits"]).all()
    assert out["handoff"] is None
    out2 = tserve.main(argv + ["--virtual", "2"])
    assert torch.equal(out2["tokens"], out["tokens"])
    assert out2["lowerings"]["prefill"].V == 2
    assert out2["lowerings"]["decode"] == out["lowerings"]["decode"]
    assert out2["handoff"]["seconds"] >= 0
    assert FA.flash_attend.launches == before
    # tensor 2 runs only as ranks: in one process it names the 2 it needs
    with pytest.raises(ValueError, match="= 2 processes"):
        tserve.main(["--arch", "llama3.2-1b", "--reduced", "--tensor", "2",
                     "--device", "cpu"])


# ---------------------------------------------------------------------------
# import isolation
# ---------------------------------------------------------------------------

_ISOLATED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["repro"] = None        # and any import of the JAX package
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import torch
from repro_torch.configs import get_config
from repro_torch.pipeline import runtime as RT, stage as ST
for arch in ("llama3.2-1b", "mamba2-2.7b"):
    cfg = get_config(arch).reduced(n_layers=2, d_model=64)
    plan = ST.plan_stages(cfg, n_stages=2)
    step = RT.make_serve_step(cfg, plan, RT.PipelineConfig(n_microbatches=2),
                              q_len=3)
    params = ST.init_stacked_params(cfg, 0, plan, device="cpu")
    cache = RT.init_pipeline_cache(cfg, plan, 2, 4, device="cpu")
    lg, _ = step(params, cache,
                 dict(tokens=torch.zeros(2, 3, dtype=torch.long)))
    assert lg.shape == (2, 1, 1024) and torch.isfinite(lg).all()
import contextlib, io
from repro_torch.launch import train
with contextlib.redirect_stdout(io.StringIO()):
    out = train.main(["--arch", "llama3.2-1b", "--reduced", "--layers", "2",
                      "--d-model", "64", "--stages", "2", "--schedule",
                      "zb-auto", "--microbatches", "2", "--batch", "2",
                      "--seq", "8", "--steps", "2", "--device", "cpu"])
assert len(out["losses"]) == 2 and all(x == x for x in out["losses"])
# zb-auto's portfolio step replays its tables through the simulator
assert "repro_torch.core.simulator" in sys.modules
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            if sys.modules[m] is not None]
print("OK", len(names))
"""


def test_port_imports_and_serves_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _ISOLATED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK"), res.stdout
    assert int(res.stdout.split()[1]) >= 23      # every module was imported


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


def test_port_sources_never_name_jax_or_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)
    assert _FORBIDDEN.search("from repro.models import layers")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from repro_torch.models import layers")
