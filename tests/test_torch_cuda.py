"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA card (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips.  Tolerances are the JAX kernel
tests' own: f32 2e-5, bf16 3e-2.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as FA

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    """The CUDA kernel against its plain version at the serving shapes
    (prefill and per-row decode) and with an idle row (kv_len = 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    for B, T, S, q_start, kv_len in ((4, 512, 544, [0] * 4, [512] * 4),
                                     (4, 1, 544, [512, 40, 0, 300],
                                      [513, 41, 1, 301]),
                                     (3, 4, 544, [0, 9, 3], [4, 13, 0])):
        q = torch.randn(B, T, 32, 64, generator=g).to(dev, TDT[dtype])
        k = torch.randn(B, S, 8, 64, generator=g).to(dev, TDT[dtype])
        v = torch.randn(B, S, 8, 64, generator=g).to(dev, TDT[dtype])
        qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
        kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        got = FA.flash_attend(q, k, v, scale=0.125, causal=True,
                              q_start=qs, kv_len=kl)
        want = FA.attend_ref(q, k, v, scale=0.125, causal=True,
                             q_start=qs, kv_len=kl)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


# the shapes of tests/test_kernels.py's SSD sweep (B, T, H, P, N, chunk),
# then the serving path's (mamba2-2.7b: 80 heads of 64, d_state 128,
# chunk 256, a micro-batch of 4 rows, prompt 512)
SSD_SHAPES = [(2, 64, 8, 32, 16, 16), (1, 128, 4, 64, 32, 32),
              (2, 256, 8, 32, 128, 64), (2, 32, 6, 16, 8, 32),
              (4, 512, 80, 64, 128, 256)]


def _ssd_inputs(g, B, T, H, P, N, dtype, dev):
    rnd = lambda *s: torch.randn(*s, generator=g)
    x = rnd(B, T, H, P).to(dev, TDT[dtype])
    dt = torch.nn.functional.softplus(rnd(B, T, H)).to(dev)
    A = -torch.exp(rnd(H) * 0.5).to(dev)
    Bm, Cm = rnd(B, T, N).to(dev, TDT[dtype]), rnd(B, T, N).to(dev, TDT[dtype])
    return x, dt, A, Bm, Cm


def _rel_err(got, want):
    scale = want.float().abs().max().item() + 1e-9
    return (got.float() - want.float()).abs().max().item() / scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain_on_card(dtype):
    """The CUDA SSD kernel against its plain version (ssd_chunked_ref) on
    the card: the JAX kernel tests' shapes, the serving shape, and a
    nonzero initial state (y and the final state), with the JAX kernel
    tests' error measure, max |y - y_ref| / max |y_ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import ssd_scan as SSD
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    for B, T, H, P, N, chunk in SSD_SHAPES:
        x, dt, A, Bm, Cm = _ssd_inputs(g, B, T, H, P, N, dtype, dev)
        init = torch.randn(B, H, P, N, generator=g).to(dev)
        for state in (None, init):
            y, fin = SSD.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                                     init_state=state)
            yr, fr = SSD.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                         init_state=state)
            assert y.dtype == x.dtype and fin.dtype == torch.float32
            assert _rel_err(y, yr) < TOL[dtype], (B, T, H, P, N, chunk)
            assert _rel_err(fin, fr) < TOL[dtype], (B, T, H, P, N, chunk)
        y = SSD.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        yr, _ = SSD.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=min(chunk, T))
        assert _rel_err(y, yr) < TOL[dtype]


@pytest.mark.cuda
def test_ssd_kernel_rejects_partial_chunk():
    """T not a multiple of chunk raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import ssd_scan as SSD
    dev = torch.device("cuda")
    x, dt, A, Bm, Cm = _ssd_inputs(torch.Generator().manual_seed(1),
                                   1, 24, 2, 16, 8, "float32", dev)
    before = SSD.ssd_chunked.launches
    with pytest.raises(ValueError, match="multiple"):
        SSD.ssd_chunked(x, dt, A, Bm, Cm, chunk=16)
    assert SSD.ssd_chunked.launches == before


@pytest.mark.cuda
def test_ssd_kernel_random_cases_match_sequential_ref():
    """The JAX hypothesis case's draws (B 1, P 16, N 8, chunk 32; T in
    32/64/128, H in 2/4, random inputs) against the sequential recurrence
    ``ssd_scan_ref``, at its tolerance 5e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import ssd_scan as SSD
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    for case in range(8):
        T, H = (32, 64, 128)[case % 3], (2, 4)[case % 2]
        x, dt, A, Bm, Cm = _ssd_inputs(g, 1, T, H, 16, 8, "float32", dev)
        y = SSD.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
        yr, _ = SSD.ssd_scan_ref(x, dt, A, Bm, Cm)
        torch.testing.assert_close(y, yr, atol=5e-4, rtol=5e-4)
