"""The SSD kernel's algorithm in plain torch, on the CPU.

* Mamba-2's chunk-parallel split (``ssd_chunked_split_ref``: every chunk's
  own state at once, the short pass over chunks, then every chunk's
  output from its passed-in state) against the JAX model's
  ``layers._ssd_chunked``, on numpy-made inputs, with 1, 2 and 4 chunks,
  with and without an initial state: y and the final state within 1e-5
  of max |ref| (f32; only the order of the sums and the double scan of
  dt*A differ).
* The kernel's split-precision TF32 products, with TF32 rounding emulated
  in torch (the helpers of tests/test_torch_flash_split.py): the whole
  scan with its four products in 3xTF32 stays within the f32 tolerance
  (2e-5 of max |y|) at serving-like magnitudes, where one TF32 pass does
  not; and for bf16 operands, which TF32 holds exactly, two passes give
  the three-pass result bit for bit.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as L
from repro_torch.kernels import ssd_scan as SSD
from test_torch_flash_split import _mm_tf32, _tf32

B, T, H, P, N = 2, 32, 3, 8, 16
CHUNKS = (32, 16, 8)                    # 1, 2 and 4 chunks
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B_, T_, H_, P_, N_):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, dt, a, Bm, Cm = f(B_, T_, H_, P_), f(B_, T_, H_), f(H_), \
        f(B_, T_, N_), f(B_, T_, N_)
    return (x, np.log1p(np.exp(dt)).astype(np.float32),
            (-np.exp(a * 0.5)).astype(np.float32), Bm, Cm,
            f(B_, H_, P_, N_))


@pytest.fixture(scope="module")
def jax_case():
    """numpy inputs and the JAX model's ``_ssd_chunked`` of them at every
    chunk size, from a zero and from a random initial state."""
    x, dt, A, Bm, Cm, init = _inputs(5, B, T, H, P, N)
    want = {}
    for chunk in CHUNKS:
        fn = jax.jit(functools.partial(L._ssd_chunked, chunk=chunk))
        for seeded in (False, True):
            y, fin = fn(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                        init_state=jnp.asarray(init) if seeded else None)
            want[chunk, seeded] = (np.asarray(y), np.asarray(fin))
    return (x, dt, A, Bm, Cm, init), want


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(got.double().numpy() - want).max() / np.abs(want).max()


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_matches_jax_ssd_chunked(jax_case, chunk, seeded):
    (x, dt, A, Bm, Cm, init), want = jax_case
    t = lambda a: torch.from_numpy(a)
    init_t = t(init) if seeded else None
    y, fin = SSD.ssd_chunked_split_ref(t(x), t(dt), t(A), t(Bm), t(Cm),
                                       chunk=chunk, init_state=init_t)
    y_want, fin_want = want[chunk, seeded]
    assert y.shape == (B, T, H, P) and y.dtype == torch.float32
    assert fin.shape == (B, H, P, N) and fin.dtype == torch.float32
    assert _rel(y, y_want) < TOL, (chunk, seeded, _rel(y, y_want))
    assert _rel(fin, fin_want) < TOL, (chunk, seeded, _rel(fin, fin_want))
    if seeded:                          # the state passed in is not touched
        np.testing.assert_array_equal(init_t.numpy(), init)
    # and the sequential chunk loop, the CPU path of the wrapper
    y_seq, fin_seq = SSD.ssd_chunked_ref(t(x), t(dt), t(A), t(Bm), t(Cm),
                                         chunk=chunk, init_state=init_t)
    torch.testing.assert_close(y, y_seq, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(fin, fin_seq, atol=1e-5, rtol=1e-5)


def _mm_2pass(exact: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exact @ b with ``exact`` already a TF32 value (a widened bf16): the
    kernel's two passes, exact*big + exact*small, sums in f64 then f32."""
    bb = _tf32(b)
    return (exact.double() @ (bb.double()
                              + _tf32(b - bb, False).double())).float()


def _scan_tf32(x, dt, A, Bm, Cm, init, chunk, passes):
    """One (row, head) of the scan as the kernel splits it, with its four
    products (scores, chunk state, readout, intra-chunk) fed to the tensor
    core in ``passes`` TF32 passes (None: exact f64 products)."""
    mm = ((lambda a, b: (a.double() @ b.double()).float()) if passes is None
          else functools.partial(_mm_tf32, passes=passes))
    state, ys = init, []
    for k in range(x.shape[0] // chunk):
        sl = slice(k * chunk, (k + 1) * chunk)
        xc, dtc, Bc, Cc = x[sl], dt[sl], Bm[sl], Cm[sl]
        cum = torch.cumsum(dtc.double() * A, 0)
        G = mm(Cc, Bc.T)
        wend = torch.exp((cum[-1] - cum).float()) * dtc
        S = mm((xc * wend[:, None]).T, Bc)
        seg = cum[:, None] - cum[None, :]
        causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
        W = G * torch.exp(torch.where(causal, seg, SSD.NEG_INF).float()) \
            * dtc[None, :]
        ys.append(mm(W, xc) + mm(Cc, state.T) * torch.exp(cum.float())[:, None])
        state = state * torch.exp(cum[-1].float()) + S
    return torch.cat(ys), state


def test_3xtf32_products_meet_the_f32_tolerance():
    """Serving-like magnitudes (N = 128, chunk 64, 4 chunks, dt =
    softplus(randn), A = -exp(randn / 2), a random initial state): the
    scan in 3xTF32 stays within 2e-5 of max |y| and of max |state|; in one
    TF32 pass it does not."""
    x, dt, A, Bm, Cm, init = (torch.from_numpy(a[0]) if a.ndim > 1 else
                              torch.from_numpy(a)
                              for a in _inputs(11, 1, 256, 1, 32, 128))
    x, dt, init = x[:, 0], dt[:, 0], init[0]
    want_y, want_s = _scan_tf32(x, dt, A[0].double(), Bm, Cm, init, 64, None)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    err = {}
    for passes in (1, 3):
        y, s = _scan_tf32(x, dt, A[0].double(), Bm, Cm, init, 64, passes)
        err[passes] = max(rel(y, want_y), rel(s, want_s))
    assert err[3] <= 2e-5 < err[1], err
    assert err[1] > 10 * err[3], err


def test_two_passes_are_exact_for_bf16_operands():
    """A bf16 operand is a TF32 value: its small part is 0, so the bf16
    path's two passes give the three-pass product bit for bit, within
    2e-5 of the exact product."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)
                         ).bfloat16().float()
    b = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32)
                         * np.exp(rng.standard_normal((1, 64))).astype(
                             np.float32))
    assert torch.equal(_tf32(a), a) and torch.equal(_tf32(a, False), a)
    two = _mm_2pass(a, b)
    torch.testing.assert_close(two, _mm_tf32(a, b, 3), atol=0, rtol=0)
    exact = (a.double() @ b.double()).float()
    assert ((two - exact).abs().max() / exact.abs().max()).item() < 2e-5
    one = _mm_tf32(a, b, 1)
    assert ((one - exact).abs().max() / exact.abs().max()).item() > 2e-5


def test_copies_16b_reads_alignment_from_the_tensors():
    """The wrapper allows the kernel's 16-byte copies only when every row
    of x, Bm, Cm and of its own scratch starts on 16 bytes: views of the
    model's in_proj output qualify; a view one element off, an N of 6 f32
    or 12 bf16, or a chunk that is not a multiple of 4 do not."""
    for dtype, n_ok, n_bad in ((torch.float32, 8, 6),
                               (torch.bfloat16, 16, 12)):
        for N, off, chunk, want in ((n_ok, 0, 16, True), (n_ok, 1, 16, False),
                                    (n_bad, 0, 16, False),
                                    (n_ok, 0, 6, False)):
            wide = torch.zeros(2, 12, off + 4 * 16 + 2 * N, dtype=dtype)
            x = wide[..., off:off + 64].reshape(2, 12, 4, 16)
            Bm = wide[..., off + 64:off + 64 + N]
            Cm = wide[..., off + 64 + N:]
            assert SSD.copies_16b(x, Bm, Cm, chunk) == want, \
                (dtype, N, off, chunk)
