"""The flash-attention backward's plain version against torch autograd and
against the JAX package, on the CPU.

``attend_bwd_ref`` is the math the CUDA backward kernel computes (P from
the saved statistics, D = rowsum(dO o O), dS = P o (dP - D), zero where
the forward masked).  It must equal torch autograd of ``attend_ref`` and
the gradient of ``repro.models.layers.attend`` through ``jax.vjp``: GQA,
causal and not, per-row offsets, and rows that see no key (kv_len = 0, or
q_start + i < 0 under the causal mask), whose output is the mean of V
over all S keys.  Inputs are made with numpy; f32, relative to max |ref|:
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as LYR

TOL = 1e-5

# (B, T, S, Hq, Hkv, D, causal, q_start, kv_len)
CASES = [
    (2, 8, 8, 4, 2, 16, True, [0, 0], [8, 8]),
    (2, 8, 8, 4, 4, 16, False, [0, 0], [8, 8]),
    (3, 4, 12, 4, 1, 8, True, [8, 2, 0], [12, 6, 0]),     # idle row
    (3, 5, 9, 6, 2, 8, False, [0, 0, 0], [9, 3, 0]),      # kv_len = 0
    (2, 6, 6, 2, 2, 8, True, [-3, 0], [6, 6]),            # q_start + i < 0
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0):
    B, T, S, Hq, Hkv, D, causal, q_start, kv_len = case
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(B, T, Hq, D), f(B, S, Hkv, D), f(B, S, Hkv, D), f(B, T, Hq, D),
            np.asarray(q_start, np.int32), np.asarray(kv_len, np.int32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _port_bwd(case, q, k, v, do, qs, kl):
    t = torch.from_numpy
    kw = dict(scale=case[5] ** -0.5, causal=case[6], q_start=t(qs),
              kv_len=t(kl))
    out, lse = FA.flash_attend(t(q), t(k), t(v), return_lse=True, **kw)
    grads = FA.flash_attend_bwd(t(q), t(k), t(v), out, lse, t(do), **kw)
    return out, lse, grads, kw


@pytest.fixture(scope="module")
def jax_grads():
    """jax.vjp of repro.models.layers.attend for every case."""
    out = []
    for case in CASES:
        q, k, v, do, qs, kl = _inputs(case)
        fn = lambda q_, k_, v_: JL.attend(
            q_, k_, v_, scale=case[5] ** -0.5, causal=case[6],
            q_start=jnp.asarray(qs), kv_len=jnp.asarray(kl))
        y, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        out.append((np.asarray(y), [np.asarray(g) for g in
                                    vjp(jnp.asarray(do))]))
    return out


@pytest.mark.parametrize("i", range(len(CASES)))
def test_bwd_ref_matches_torch_autograd(i):
    case = CASES[i]
    q, k, v, do, qs, kl = _inputs(case)
    _, _, grads, kw = _port_bwd(case, q, k, v, do, qs, kl)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ref = FA.attend_ref(*leaves, **kw)
    auto = torch.autograd.grad(ref, leaves, torch.from_numpy(do))
    for name, a, b in zip("qkv", grads, auto):
        assert _rel(a, b) < TOL, (name, case)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_bwd_ref_matches_jax_vjp(jax_grads, i):
    case = CASES[i]
    q, k, v, do, qs, kl = _inputs(case)
    out, _, grads, _ = _port_bwd(case, q, k, v, do, qs, kl)
    y_ref, g_ref = jax_grads[i]
    assert _rel(out, y_ref) < TOL
    for name, a, b in zip("qkv", grads, g_ref):
        assert _rel(a, b) < TOL, (name, case)


def test_fully_masked_row_statistics_and_gradient():
    """Trap of the saved statistics: a row that sees no key has lse
    -1e30 (-1e30 + log S rounds to it), so exp(s - lse) would give 1, not
    1/S.  The backward picks such rows out: dV gets 1/S of their dO at
    every key, and they give dQ and dK nothing."""
    case = (1, 2, 4, 1, 1, 8, False, [0], [0])
    q, k, v, do, qs, kl = _inputs(case, seed=3)
    out, lse, (dq, dk, dv), _ = _port_bwd(case, q, k, v, do, qs, kl)
    assert torch.all(lse == -1e30)
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(
        v.mean(1, keepdims=True), out.shape), rtol=1e-6, atol=1e-6)
    assert torch.all(dq == 0) and torch.all(dk == 0)
    want_dv = np.broadcast_to(do.sum(1, keepdims=True) / 4, dv.shape)
    np.testing.assert_allclose(dv.numpy(), want_dv, rtol=1e-6, atol=1e-6)


def test_flash_attention_function_and_attend_under_autograd():
    """FlashAttention (forward with statistics, backward through
    flash_attend_bwd) and layers.attend under autograd give autograd's
    gradients of the plain version on CPU tensors."""
    case = CASES[2]
    q, k, v, do, qs, kl = _inputs(case, seed=5)
    kw = dict(scale=case[5] ** -0.5, causal=case[6])
    t = torch.from_numpy
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    ref = FA.attend_ref(*leaves, q_start=t(qs), kv_len=t(kl), **kw)
    want = torch.autograd.grad(ref, leaves, t(do))
    out = FA.FlashAttention.apply(*leaves, kw["scale"], kw["causal"], t(qs),
                                  t(kl))
    for a, b in zip(torch.autograd.grad(out, leaves, t(do)), want):
        assert _rel(a, b) < TOL
    out = LYR.attend(*leaves, q_start=t(qs), kv_len=t(kl), **kw)
    for a, b in zip(torch.autograd.grad(out, leaves, t(do)), want):
        assert _rel(a, b) < TOL


def test_bwd_refuses_mismatched_statistics():
    case = CASES[0]
    q, k, v, do, qs, kl = _inputs(case)
    out, lse, _, kw = _port_bwd(case, q, k, v, do, qs, kl)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attend_bwd(t(q), t(k), t(v), out, lse[:, :, :1], t(do),
                            **kw)
    with pytest.raises(ValueError, match="dout"):
        FA.flash_attend_bwd(t(q), t(k), t(v), out, lse, t(do)[:, :1], **kw)


# The D = 256 kernels' split of dK/dV over the query heads of a group:
# (B, T, S, Hq, Hkv, D, causal, q_start, kv_len, window), G = 1, 2, 4
PART_CASES = [
    (2, 6, 9, 2, 2, 8, True, [0, 3], [6, 9], 0),                # G = 1
    (2, 7, 7, 4, 2, 8, True, [0, -2], [7, 7], 3),               # G = 2
    (3, 5, 12, 4, 1, 8, True, [7, 0, 2], [12, 0, 9], 0),        # G = 4
    (2, 9, 9, 4, 1, 8, True, [0, 0], [9, 4], 2),                # G = 4
]


@pytest.mark.parametrize("D", [128, 256])
def test_bwd_parts_plan(D):
    """The workspace of the dK/dV split: at D = 256 one f32 part per query
    head of a group, [dV, dK] x G x B x S x Hkv x D; none below (those
    kernels sum a group in one block)."""
    B, S, Hkv, G = 2, 40, 3, 4
    plan = FA.bwd_parts(B, S, G * Hkv, Hkv, D)
    assert plan == ((2, G, B, S, Hkv, D) if D == 256 else None)


@pytest.mark.parametrize("i", range(len(PART_CASES)))
def test_bwd_parts_sum_in_order_matches_ref_and_autograd(i):
    """dK/dV from G per-head parts added in order 0 .. G - 1
    (attend_bwd_parts_ref, the D = 256 kernels' split) equals
    attend_bwd_ref and torch autograd of attend_ref, window on and off,
    with rows that see no key (attend_bwd_ref is held to jax.vjp above)."""
    case = PART_CASES[i]
    q, k, v, do, qs, kl = _inputs(case[:9], seed=7)
    t = torch.from_numpy
    kw = dict(scale=case[5] ** -0.5, causal=case[6], q_start=t(qs),
              kv_len=t(kl), window=case[9])
    out, lse = FA.flash_attend(t(q), t(k), t(v), return_lse=True, **kw)
    got = FA.attend_bwd_parts_ref(t(q), t(k), t(v), out, lse, t(do), **kw)
    want = FA.attend_bwd_ref(t(q), t(k), t(v), out, lse, t(do), **kw)
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    auto = torch.autograd.grad(FA.attend_ref(*leaves, **kw), leaves, t(do))
    for name, a, b, c in zip("qkv", got, want, auto):
        assert _rel(a, b) < 1e-6, (name, case)
        assert _rel(a, c) < TOL, (name, case)
