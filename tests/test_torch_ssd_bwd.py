"""The SSD backward kernel's scratch contract and its decomposition, on the
CPU (the kernel itself runs only on the card: tests/test_torch_cuda.py).

* ``ssd_scan.bwd_scratch`` at mamba2-2.7b's training shape holds no
  per-head [c x c] or [c x N] buffer and stays under a stated size; its
  buffers follow ``ssd_scan_bwd``'s parameters in csrc/ssd_scan.cu and
  its head groups the source's ``HG``.
* The kernel's decomposition in float64 plain torch (:func:`_split_bwd`):
  the scores' gradient summed over head groups, then over the groups; dB
  and dC as one part per group along K = heads x P plus the intra-chunk
  part from that sum; each head's dy . y_off read off its own partial
  product; each head's row and column sums of dWL G from its dW tile; dx
  formed as dt_j times (G o L)^T dy plus the state term over dt_j.  It
  must give ``ssd_chunked_bwd_ref``'s gradients (1e-5 of max |ref|) with
  one, two and a ragged last head group.
"""
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan as SSD

# mamba2-2.7b's training call (a micro-batch of 2 rows, seq 1024) and the
# first backward's scratch there, ~362 MB: dWL [B,nc,H,c,c] and dB, dC per
# head [B,nc,H,c,N]
TRAIN = dict(B=2, T=1024, H=80, P=64, N=128, chunk=256)
#: the scratch of one backward call at TRAIN, bytes: the state gradients
#: [B,nc,H,P,N] (21 MB, as the first version), dG's group parts and sum
#: (19 MB), dB's and dC's parts (19 MB) and per-position sums (~7 MB)
SCRATCH_LIMIT = 72e6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nbytes(scratch: dict) -> int:
    return sum(math.prod(shape) * (8 if name == "dapart" else 4)
               for name, shape in scratch.items())


def test_bwd_scratch_has_no_per_head_tiles():
    B, T, H, P, N, c = TRAIN.values()
    nc = T // c
    scratch = SSD.bwd_scratch(B, T, H, P, N, c)
    shapes = set(scratch.values())
    assert (B, nc, H, c, c) not in shapes
    assert (B, nc, H, c, N) not in shapes
    # no buffer is per head and per pair of positions or (position, state)
    for name, shape in scratch.items():
        if H in shape:
            assert math.prod(shape) <= B * nc * H * max(P * N, 8 * c), name
    assert _nbytes(scratch) < SCRATCH_LIMIT, _nbytes(scratch)


@pytest.mark.parametrize("H", [1, 7, 10, 13, 80])
def test_bwd_scratch_head_groups(H):
    B, T, P, N, c = 2, 256, 32, 24, 64
    ng = -(-H // SSD.HEAD_GROUP)
    s = SSD.bwd_scratch(B, T, H, P, N, c)
    assert s["dgp"] == (B, T // c, ng, c, c)
    assert s["dg"] == (B, T // c, c, c)
    assert s["dbcp"] == (2, B, T // c, ng + 1, c, N)


def test_bwd_scratch_follows_the_c_interface():
    """The wrapper passes its scratch in dict order: the same names, in
    the same order, as ssd_scan_bwd's scratch parameters; and its head
    group is the source's."""
    src = SSD.build.source("ssd_scan").read_text()
    sig = re.search(r"int ssd_scan_bwd\((.*?)\)\s*{", src, re.S).group(1)
    params = re.findall(r"void\*\s*(\w+)", sig)
    scratch = params[params.index("cum") + 1:params.index("dx")]
    assert scratch == list(SSD.bwd_scratch(1, 64, 2, 16, 8, 32))
    hg = re.search(r"constexpr int HG = (\d+);", src).group(1)
    assert int(hg) == SSD.HEAD_GROUP


def _split_bwd(x, dt, A, Bm, Cm, dy, dfinal, *, chunk, init_state, hg):
    """The backward kernel's decomposition (csrc/ssd_scan.cu, its eight
    launches) in float64 plain torch, one chunk at a time."""
    f = lambda t: t.double()
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    nc, c = T // chunk, chunk
    xf = f(x).reshape(Bsz, nc, c, H, P)
    dyf = f(dy).reshape(Bsz, nc, c, H, P)
    dtf = f(dt).reshape(Bsz, nc, c, H)
    Bf, Cf = f(Bm).reshape(Bsz, nc, c, N), f(Cm).reshape(Bsz, nc, c, N)
    A = f(A)
    cum = torch.cumsum(dtf * A, dim=2)
    e_in, e_out = torch.exp(cum), torch.exp(cum[:, :, -1:] - cum)
    e_chunk = torch.exp(cum[:, :, -1])
    # the forward's passed-in states; 1. the gradient's readout state
    S_own = torch.einsum("bkjhp,bkjh,bkjn->bkhpn", xf, e_out * dtf, Bf)
    state = torch.zeros(Bsz, H, P, N, dtype=torch.float64) \
        if init_state is None else f(init_state)
    S_in = []
    for k in range(nc):
        S_in.append(state)
        state = state * e_chunk[:, k, :, None, None] + S_own[:, k]
    Z = torch.einsum("bkihp,bkih,bkin->bkhpn", dyf, e_in, Cf)
    # 2. the reverse pass over chunks
    g = torch.zeros(Bsz, H, P, N, dtype=torch.float64) \
        if dfinal is None else f(dfinal)
    dS, gpart = [None] * nc, [None] * nc
    for k in reversed(range(nc)):
        dS[k] = g
        gpart[k] = e_chunk[:, k] * (g * S_in[k]).sum((-1, -2))
        g = g * e_chunk[:, k, :, None, None] + Z[:, k]
    causal = torch.tril(torch.ones(c, c, dtype=torch.bool))
    groups = [range(h0, min(h0 + hg, H)) for h0 in range(0, H, hg)]
    dx = torch.empty_like(xf)
    ddt = torch.empty_like(dtf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros(H, dtype=torch.float64)
    for k in range(nc):
        xk, dyk, dtk, Bk, Ck = xf[:, k], dyf[:, k], dtf[:, k], Bf[:, k], \
            Cf[:, k]
        L = torch.exp(torch.where(causal[None, :, :, None],
                                  cum[:, k, :, None] - cum[:, k, None],
                                  -torch.inf))                 # [B,i,j,H]
        G = torch.einsum("bin,bjn->bij", Ck, Bk)
        # 3./4. per head group: dWL dt_j summed over its heads, each head's
        # row and column sums; then the groups' parts summed in group order
        dWL = torch.einsum("bihp,bjhp->bijh", dyk, xk) * L
        rs = (dWL * (G[..., None] * dtk[:, None])).sum(2)     # [B,i,H]
        cs = (dWL * G[..., None]).sum(1)                      # [B,j,H]
        dG = sum((dWL[..., list(hs)] * dtk[:, None, :, list(hs)]).sum(-1)
                 for hs in groups)
        # 5. dx: acc = exp(cum_end - cum_j) U_j + (G o L)^T dy = dx / dt_j
        U = torch.einsum("bhpn,bjn->bjhp", dS[k], Bk)
        acc = e_out[:, k, ..., None] * U \
            + torch.einsum("bij,bijh,bihp->bjhp", G, L, dyk)
        r = e_out[:, k] * (xk * U).sum(-1)
        dx[:, k] = dtk[..., None] * acc
        # 6. dB, dC: one part per head group along K = heads x P, each
        # head's dy . y_off off its own product; one part from dG
        dC_off = torch.einsum("bih,bihp,bhpn->bihn", e_in[:, k], dyk,
                              S_in[k])
        yo = (dC_off * Ck[:, :, None]).sum(-1)                # [B,i,H]
        dB_st = torch.einsum("bjh,bjhp,bhpn->bjhn", e_out[:, k] * dtk, xk,
                             dS[k])
        dC[:, k] = sum(dC_off[:, :, list(hs)].sum(2) for hs in groups) \
            + torch.einsum("bij,bjn->bin", dG, Bk)
        dB[:, k] = sum(dB_st[:, :, list(hs)].sum(2) for hs in groups) \
            + torch.einsum("bij,bin->bjn", dG, Ck)
        # 7. dcum, its reverse scan
        dcum = rs - dtk * cs + yo - dtk * r
        dcum[:, -1] += (dtk * r).sum(1) + gpart[k]
        R = dcum.flip(1).cumsum(1).flip(1)
        ddt[:, k] = cs + r + A * R
        dA += (dtk * R).sum((0, 1))
    return (dx.reshape(Bsz, T, H, P), ddt.reshape(Bsz, T, H), dA,
            dB.reshape(Bsz, T, N), dC.reshape(Bsz, T, N),
            None if init_state is None else g)


# (B, T, H, P, N, chunk, seeded): one head group, two (the last ragged),
# and a group of one head behind a full one
SPLIT_CASES = ((2, 32, 3, 8, 16, 8, True), (1, 48, 13, 8, 8, 16, True),
               (2, 32, 11, 4, 8, 16, False))


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_kernel_split_matches_bwd_ref(case):
    B, T, H, P, N, chunk, seeded = case
    rng = np.random.default_rng(B * 100 + T + H)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    x, dy = t(B, T, H, P), t(B, T, H, P)
    dt = torch.nn.functional.softplus(t(B, T, H))
    A = -torch.exp(t(H) * 0.5)
    Bm, Cm = t(B, T, N), t(B, T, N)
    init = t(B, H, P, N) if seeded else None
    dfinal = t(B, H, P, N) if seeded else None
    want = SSD.ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk,
                                   init_state=init)
    got = _split_bwd(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk,
                     init_state=init, hg=SSD.HEAD_GROUP)
    assert (got[-1] is None) == (not seeded)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dinit"), got,
                          want):
        if b is None:
            continue
        err = ((a - b.double()).abs().max() / b.double().abs().max()).item()
        assert err < 1e-5, (name, err)
