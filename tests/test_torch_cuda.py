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
