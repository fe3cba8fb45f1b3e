"""The port's flash attention (repro_torch.kernels) against the JAX
package: the Pallas kernel in interpret mode, its oracle
``flash_attention_ref``, and the model's ``layers.attend``.

On the CPU the port's wrappers take their plain versions (the CUDA kernel
runs only on the card: see tests/test_torch_cuda.py and chip_smoke.py).
Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the JAX kernel tests' own: f32 2e-5, bf16 3e-2 (f32
accumulation in both, summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models import layers as L
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as TL

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, leaving the other cores to the
    test files that run beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rng, shape, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


# the shapes of tests/test_kernels.py::test_flash_attention_matches_ref;
# the first three go through the Pallas kernel in interpret mode
PALLAS_SHAPES = [(4, 128, 128, 64, True), (2, 100, 100, 32, True),
                 (2, 1, 256, 64, False)]
REF_SHAPES = [(2, 256, 256, 64, True), (3, 64, 256, 128, False),
              (1, 512, 512, 128, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oracle,BH,T,S,D,causal",
                         [("pallas",) + s for s in PALLAS_SHAPES]
                         + [("ref",) + s for s in REF_SHAPES])
def test_flash_attention_matches_jax(oracle, BH, T, S, D, causal, dtype):
    rng = np.random.default_rng(BH * 1000 + T + S + D)
    qj, qt = _pair(rng, (BH, T, D), dtype)
    kj, kt = _pair(rng, (BH, S, D), dtype)
    vj, vt = _pair(rng, (BH, S, D), dtype)
    if oracle == "pallas":
        want = jax_flash(qj, kj, vj, scale=D ** -0.5, causal=causal,
                         interpret=True)
    else:
        want = jax_flash_ref(qj, kj, vj, scale=D ** -0.5, causal=causal)
    got = FA.flash_attention(qt, kt, vt, scale=D ** -0.5, causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == (BH, T, D)
    _close(got, want, TOL[dtype])


def test_flash_attention_kv_len_masking():
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (2, 1, 64), "float32")
    kj, kt = _pair(rng, (2, 128, 64), "float32")
    vj, vt = _pair(rng, (2, 128, 64), "float32")
    want = jax_flash(qj, kj, vj, scale=0.125, causal=False, kv_len=40,
                     interpret=True)
    got = FA.flash_attention(qt, kt, vt, scale=0.125, causal=False, kv_len=40)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_gqa_per_row_offsets(dtype):
    """GQA (Hq/Hkv = 2), per-row q_start and kv_len, and one idle row with
    kv_len = 0: the same answer as L.attend, no NaN (the idle row averages
    V over all S keys, as the -1e30 mask gives)."""
    rng = np.random.default_rng(7)
    B, T, S, Hq, Hkv, D = 3, 4, 24, 4, 2, 32
    qj, qt = _pair(rng, (B, T, Hq, D), dtype)
    kj, kt = _pair(rng, (B, S, Hkv, D), dtype)
    vj, vt = _pair(rng, (B, S, Hkv, D), dtype)
    q_start = np.array([0, 9, 3], np.int32)
    kv_len = np.array([4, 13, 0], np.int32)
    want = L.attend(qj, kj, vj, scale=D ** -0.5, causal=True,
                    q_start=jnp.asarray(q_start), kv_len=jnp.asarray(kv_len))
    got = TL.attend(qt, kt, vt, scale=D ** -0.5, causal=True,
                    q_start=torch.from_numpy(q_start),
                    kv_len=torch.from_numpy(kv_len))
    assert torch.isfinite(got.float()).all()
    _close(got, want, TOL[dtype])
    idle = vt[2].float().mean(0).repeat_interleave(Hq // Hkv, dim=0)
    np.testing.assert_allclose(got[2, 0].float().numpy(), idle.numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_attend_scalar_offsets_and_defaults():
    """Scalar q_start / kv_len and the kv_len=None default (prefill)."""
    rng = np.random.default_rng(8)
    B, T, S, Hq, Hkv, D = 2, 6, 10, 4, 1, 16
    qj, qt = _pair(rng, (B, T, Hq, D), "float32")
    kj, kt = _pair(rng, (B, S, Hkv, D), "float32")
    vj, vt = _pair(rng, (B, S, Hkv, D), "float32")
    _close(TL.attend(qt, kt, vt, scale=0.25, causal=True, q_start=3, kv_len=9),
           L.attend(qj, kj, vj, scale=0.25, causal=True, q_start=3, kv_len=9),
           2e-5)
    _close(TL.attend(qt, kt, vt, scale=0.25, causal=False),
           L.attend(qj, kj, vj, scale=0.25, causal=False), 2e-5)


#: (B, T, S, q_start, kv_len) of the window cases: per-row offsets with a
#: row that sees no key (kv_len 0), a cached T = 1 step, a prompt longer
#: than every window (scalar defaults), rows past the window's reach
#: (q_start beyond kv_len + window: with a window they see no key)
WINDOW_CASES = {
    "per-row": (3, 4, 24, [0, 9, 3], [4, 13, 0]),
    "cached": (3, 1, 20, [19, 12, 5], [20, 13, 6]),
    "prompt": (2, 20, 20, 0, None),
    "past-reach": (2, 4, 24, [20, 0], [6, 24])}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("window", [0, 3, 8])
def test_attend_window_matches_jax(window, D, case):
    """layers.attend with a sliding window (0: global) against the JAX
    package's, GQA 4/2 heads, at head dims 64 and 256: 2e-5, no NaN."""
    B, T, S, q_start, kv_len = WINDOW_CASES[case]
    rng = np.random.default_rng(window * 100 + D)
    qj, qt = _pair(rng, (B, T, 4, D), "float32")
    kj, kt = _pair(rng, (B, S, 2, D), "float32")
    vj, vt = _pair(rng, (B, S, 2, D), "float32")
    arr = lambda x, mod: x if x is None or np.isscalar(x) else mod(
        np.array(x, np.int32))
    want = L.attend(qj, kj, vj, scale=D ** -0.5, causal=True,
                    q_start=arr(q_start, jnp.asarray),
                    kv_len=arr(kv_len, jnp.asarray), window=window)
    got = TL.attend(qt, kt, vt, scale=D ** -0.5, causal=True,
                    q_start=arr(q_start, torch.from_numpy),
                    kv_len=arr(kv_len, torch.from_numpy), window=window)
    assert torch.isfinite(got).all()
    _close(got, want, 2e-5)


@pytest.mark.parametrize("bad", ["heads", "kv_len_dtype", "kv_len_shape",
                                 "rank", "window_negative", "window_tensor"])
def test_flash_attend_rejects_bad_inputs(bad):
    q, k = torch.zeros(2, 3, 4, 16), torch.zeros(2, 5, 2, 16)
    qs = torch.zeros(2, dtype=torch.int32)
    kl = torch.full((2,), 5, dtype=torch.int32)
    window = {"window_negative": -1,
              "window_tensor": torch.tensor(3)}.get(bad, 0)
    if bad == "heads":
        k = torch.zeros(2, 5, 3, 16)
    elif bad == "kv_len_dtype":
        kl = kl.long()
    elif bad == "kv_len_shape":
        kl = torch.full((3,), 5, dtype=torch.int32)
    elif bad == "rank":
        q = q[0]
    with pytest.raises(ValueError):
        FA.flash_attend(q, k, k, scale=1.0, causal=True, q_start=qs,
                        kv_len=kl, window=window)


def test_nvcc_command_targets_hopper():
    cmd = build.nvcc_command("flash_attention", build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1] == str(build.CSRC / "flash_attention.cu")
    lib = build.library_path("flash_attention")
    assert lib.parent == build.BUILD_DIR and lib.parent.parent.name == "build"
    with pytest.raises(FileNotFoundError):
        build.library_path("no_such_kernel")
