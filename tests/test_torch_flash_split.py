"""The flash kernel's two algorithms in plain torch, on the CPU.

* The decode route's split-KV algorithm (``attend_split_ref``: per-split
  max / sum / unnormalised partials and their log-sum-exp merge) against
  the JAX model's ``layers.attend`` and the port's ``attend_ref``, on
  numpy-made inputs.  Only the summation order differs, so f32 holds to
  1e-6.
* The route and split rules, which read static shapes only.
* The prefill route's split-precision TF32 ("3xTF32") products, with TF32
  rounding emulated in torch: they stay within the f32 tolerance (2e-5)
  where one TF32 pass does not.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as L
from repro_torch.kernels import flash_attention as FA

S, HKV, D = 24, 2, 8
N_SPLITS = (1, 2, 3, 4, 6, 24)          # ranges of 24, 12, 8, 6, 4, 1 keys
G_MAX, T_MAX = 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# per batch row: kv_len 12 on the boundary of most splits, 7 off every
# boundary, 3 with most splits wholly past it, 0 (an idle row: averages V
# over all S keys), and the full S; q_start puts the T_MAX rows at the end
KV_LEN = [12, 7, 3, 0, S]
Q_START = [max(0, kl - T_MAX) for kl in KV_LEN]


@pytest.fixture(scope="module")
def jax_case():
    """numpy inputs at the widest case (GQA group 8, T = 4) and the JAX
    model's ``attend`` of them, causal and not, in one jitted call each.
    A narrower case is a slice: query row i depends only on its own head,
    q_start + i and kv_len, and query heads {j * 8 + h : h < g} of kv
    head j are a group-g problem over the same K/V."""
    rng = np.random.default_rng(13)
    B = len(KV_LEN)
    q = rng.standard_normal((B, T_MAX, G_MAX * HKV, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    want = {}
    for causal in (True, False):
        fn = jax.jit(functools.partial(L.attend, scale=D ** -0.5,
                                       causal=causal))
        want[causal] = np.asarray(fn(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_start=jnp.asarray(Q_START, jnp.int32),
            kv_len=jnp.asarray(KV_LEN, jnp.int32)))
    return q, k, v, want


# (GQA group, T): groups 1, 4 and 8, T from 1 to 4, all on the decode route
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups,T", [(1, 3), (4, 1), (4, 4), (8, 2)])
def test_split_merge_matches_jax_attend(jax_case, groups, T, causal):
    assert FA.route(T, groups * HKV, HKV) == "decode"
    q_np, k_np, v_np, want_all = jax_case
    heads = [j * G_MAX + h for j in range(HKV) for h in range(groups)]
    want = want_all[causal][:, :T][:, :, heads]
    B, Hq = len(KV_LEN), groups * HKV
    kw = dict(scale=D ** -0.5, causal=causal,
              q_start=torch.tensor(Q_START, dtype=torch.int32),
              kv_len=torch.tensor(KV_LEN, dtype=torch.int32))
    q = torch.from_numpy(np.ascontiguousarray(q_np[:, :T][:, :, heads]))
    k, v = torch.from_numpy(k_np), torch.from_numpy(v_np)
    plain = FA.attend_ref(q, k, v, **kw)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-6, rtol=1e-6)
    for n_split in N_SPLITS:
        got = FA.attend_split_ref(q, k, v, n_split=n_split, **kw)
        assert got.shape == (B, T, Hq, D) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6,
                                   err_msg=f"n_split={n_split}")
        torch.testing.assert_close(got, plain, atol=1e-6, rtol=1e-6)
    # the idle row is V's mean over all S keys, per kv head
    vbar = v[3].mean(0).repeat_interleave(groups, 0)           # [Hq, D]
    torch.testing.assert_close(got[3], vbar.expand(T, Hq, D), atol=1e-6,
                               rtol=1e-6)


def test_route_rule_both_sides():
    """decode iff T * Hq / Hkv <= DECODE_MAX_ROWS (16)."""
    assert FA.DECODE_MAX_ROWS == 16
    assert FA.route(1, 32, 8) == "decode"          # serving decode: 4 rows
    assert FA.route(4, 32, 8) == "decode"          # 16 rows
    assert FA.route(5, 32, 8) == "prefill"         # 20 rows
    assert FA.route(16, 8, 8) == "decode"
    assert FA.route(17, 8, 8) == "prefill"
    assert FA.route(2, 64, 8) == "decode"
    assert FA.route(3, 64, 8) == "prefill"
    assert FA.route(1, 32, 1) == "prefill"         # 32 heads on one kv head
    assert FA.route(512, 32, 8) == "prefill"       # serving prefill


@pytest.mark.parametrize("B,S,Hkv", [(4, 544, 8), (4, 4096, 8), (2, 1000, 8),
                                     (1, 100000, 1), (8, 64, 8), (3, 1, 2)])
def test_decode_splits_cover_s_in_tiles(B, S, Hkv):
    n_split, split_len = FA.decode_splits(B, S, Hkv)
    assert split_len % FA.DECODE_TILE == 0
    assert n_split * split_len >= S > (n_split - 1) * split_len
    assert 1 <= n_split <= FA.DECODE_MAX_SPLITS
    if (B, S, Hkv) == (4, 544, 8):                 # the serving decode
        assert (n_split, split_len) == (9, 64)
        assert B * Hkv * n_split == 288


def _tf32(x: torch.Tensor, nearest: bool = True) -> torch.Tensor:
    """f32 to TF32 (10-bit mantissa): to nearest with ties away from zero
    (the kernel's rounding of the big part), or truncated (how the tensor
    core reads a register that holds more bits, the small part)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (0x1000 if nearest else 0)) & -0x2000).view(
        torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with TF32 operands as the prefill route feeds them: products
    exact, sums in f64, then f32 (the tensor core's f32 accumulation is at
    least as fine as f32 itself).  ``passes`` 1: tf32(a) tf32(b); 3:
    big*big + big*small + small*big with small = x - big truncated."""
    ab, bb = _tf32(a), _tf32(b)
    out = ab.double() @ bb.double()
    if passes == 3:
        sa, sb = _tf32(a - ab, False), _tf32(b - bb, False)
        out = out + ab.double() @ sb.double() + sa.double() @ bb.double()
    return out.float()


def test_3xtf32_products_meet_the_f32_tolerance():
    """Causal attention, T = S = 64, D = 64, with Q.K^T and P.V in TF32:
    3xTF32 stays within 2e-5 of f32; one TF32 pass does not."""
    rng = np.random.default_rng(7)
    T, Dh = 64, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((T, Dh)).astype(
        np.float32)) for _ in range(3))
    scale = Dh ** -0.5
    want = FA.flash_attention_ref(q[None], k[None], v[None], scale=scale,
                                  causal=True)[0]
    mask = torch.ones(T, T, dtype=torch.bool).tril()
    err = {}
    for passes in (1, 3):
        s = _mm_tf32(q, k.T, passes) * scale
        p = torch.softmax(torch.where(mask, s, FA.NEG_INF), dim=-1)
        err[passes] = (_mm_tf32(p, v, passes) - want).abs().max().item()
    assert err[3] <= 2e-5 < err[1], err
    assert err[1] > 10 * err[3], err
