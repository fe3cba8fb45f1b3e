"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA card (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips.  Forward tolerances are the JAX
kernel tests' own: f32 2e-5, bf16 3e-2; the backward's are relative to
max |ref|: f32 1e-4 (the harness's gradient bar), bf16 3e-2.
"""
import dataclasses

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


def _flash_inputs(g, B, T, S, Hq, Hkv, D, q_start, kv_len, dtype, dev):
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(dev, TDT[dtype])
    return (rnd(B, T, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D),
            torch.tensor(q_start, dtype=torch.int32, device=dev),
            torch.tensor(kv_len, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_routes_match_plain_on_card(dtype, D):
    """Both routes of the kernel against its plain version: GQA groups
    1/4/8, T on both sides of the decode rule (T * groups <= 16), a ragged
    T = 100, per-row offsets with a full prefix, kv_len = 40 and an idle
    row (kv_len = 0), causal and not; then the decode route over S = 4096
    (many key splits) and an S that is not a multiple of its split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(D)
    S, Hkv, seen = 160, 2, set()
    for groups in (1, 4, 8):
        Hq = Hkv * groups
        edge = FA.DECODE_MAX_ROWS // groups
        for T in sorted({1, 2, edge, edge + 1, 100}):
            seen.add(FA.route(T, Hq, Hkv))
            for causal in (True, False):
                # rows: a prompt from 0, a prefix of 40 keys, an idle row,
                # the last T positions of a full cache
                q_start = [0, max(0, 40 - T), 0, S - T]
                kv_len = [T, 40, 0, S]
                q, k, v, qs, kl = _flash_inputs(g, 4, T, S, Hq, Hkv, D,
                                                q_start, kv_len, dtype, dev)
                kw = dict(scale=D ** -0.5, causal=causal, q_start=qs,
                          kv_len=kl)
                got = FA.flash_attend(q, k, v, **kw)
                want = FA.attend_ref(q, k, v, **kw)
                torch.testing.assert_close(
                    got.float(), want.float(), atol=TOL[dtype],
                    rtol=TOL[dtype], msg=lambda m: f"groups {groups} T {T} "
                    f"causal {causal}: {m}")
    assert seen == {"decode", "prefill"}
    for B, S, q_start, kv_len in ((2, 4096, [4000, 1000], [4001, 1001]),
                                  (3, 1000, [999, 64, 0], [1000, 65, 0])):
        q, k, v, qs, kl = _flash_inputs(g, B, 1, S, 32, 8, D, q_start,
                                        kv_len, dtype, dev)
        assert FA.decode_splits(B, S, 8)[0] > 1
        kw = dict(scale=D ** -0.5, causal=True, q_start=qs, kv_len=kl)
        torch.testing.assert_close(
            FA.flash_attend(q, k, v, **kw).float(),
            FA.attend_ref(q, k, v, **kw).float(), atol=TOL[dtype],
            rtol=TOL[dtype])


@pytest.mark.cuda
def test_flash_route_counters_on_card():
    """One call counts one launch, and one on the route its static shapes
    pick: the serving decode (T = 1, 4 query heads per kv head) on the
    decode route, the serving prefill (T = 512) on the prefill route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    fa = FA.flash_attend
    for T, route in ((1, "decode"), (512, "prefill")):
        q, k, v, qs, kl = _flash_inputs(g, 4, T, 544, 32, 8, 64, [0] * 4,
                                        [T] * 4, "float32", dev)
        before = (fa.launches, fa.launches_prefill, fa.launches_decode)
        fa(q, k, v, scale=0.125, causal=True, q_start=qs, kv_len=kl)
        after = (fa.launches, fa.launches_prefill, fa.launches_decode)
        assert FA.route(T, 32, 8) == route
        assert after[0] == before[0] + 1
        assert after[1] == before[1] + (route == "prefill")
        assert after[2] == before[2] + (route == "decode")
    torch.cuda.synchronize()


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


def _ssd_view_inputs(g, B, T, H, P, N, dtype, dev, offset=0):
    """x, Bm and Cm as views into one wider [B, T, offset + H*P + 2N]
    tensor, as the model's in_proj split passes them (unit last stride,
    row stride of the wide tensor); ``offset`` 1 leaves them unaligned."""
    wide = torch.randn(B, T, offset + H * P + 2 * N, generator=g).to(
        dev, TDT[dtype])
    x = wide[..., offset:offset + H * P].reshape(B, T, H, P)
    Bm = wide[..., offset + H * P:offset + H * P + N]
    Cm = wide[..., offset + H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn(B, T, H, generator=g)).to(dev)
    A = -torch.exp(torch.randn(H, generator=g) * 0.5).to(dev)
    return x, dt, A, Bm, Cm


# (B, T, H, P, N, chunk): 4 chunks (state passing over three hops), chunks
# of 16 and 32 (below the 64-row tile), N = 8, P = 128 with N = 256 (the
# largest scratch and tiles), a chunk of 96 (a partial 64-row tile)
SSD_EDGES = [(2, 256, 4, 64, 128, 64), (2, 64, 3, 32, 16, 16),
             (2, 96, 3, 16, 32, 32), (1, 128, 2, 64, 8, 64),
             (1, 256, 2, 128, 256, 128), (2, 192, 2, 64, 64, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_split_kernels_edges_on_card(dtype):
    """The SSD kernel's four CUDA kernels at their edges (SSD_EDGES), with
    x/Bm/Cm as strided views of one wider tensor, aligned (16-byte copies)
    and offset by one element (plain loads), each from a zero and from a
    random initial state: y and the final state against ssd_chunked_ref,
    the initial state left unchanged, one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import ssd_scan as SSD
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    for B, T, H, P, N, chunk in SSD_EDGES:
        for offset in (0, 1):
            x, dt, A, Bm, Cm = _ssd_view_inputs(g, B, T, H, P, N, dtype, dev,
                                                offset)
            assert not x.is_contiguous()
            assert SSD.copies_16b(x, Bm, Cm, chunk) == (offset == 0)
            init = torch.randn(B, H, P, N, generator=g).to(dev)
            kept = init.clone()
            for state in (None, init):
                before = SSD.ssd_chunked.launches
                y, fin = SSD.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                                         init_state=state)
                assert SSD.ssd_chunked.launches == before + 1
                yr, fr = SSD.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                             init_state=state)
                case = (B, T, H, P, N, chunk, offset, state is not None)
                assert y.dtype == x.dtype and fin.dtype == torch.float32
                assert _rel_err(y, yr) < TOL[dtype], case
                assert _rel_err(fin, fr) < TOL[dtype], case
                assert fin.data_ptr() != init.data_ptr()
            torch.testing.assert_close(init, kept, atol=0, rtol=0)
    torch.cuda.synchronize()


# the backward: tolerances relative to max |ref| (f32 1e-4, bf16 3e-2)
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _bwd_case(g, B, T, S, Hq, Hkv, D, q_start, kv_len, dtype, dev):
    q, k, v, qs, kl = _flash_inputs(g, B, T, S, Hq, Hkv, D, q_start, kv_len,
                                    dtype, dev)
    dout = torch.randn(B, T, Hq, D, generator=g).to(dev, TDT[dtype])
    return q, k, v, dout, qs, kl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_bwd_matches_plain_on_card(dtype, D):
    """The backward kernel against attend_bwd_ref (same output and
    statistics) and, in f32, against torch autograd of attend_ref: GQA
    groups 1/4/8, T = 1, 16, 100 (ragged) and 130 over S = 160, causal
    and not, rows from 0, a 40-key prefix, an idle row (kv_len = 0), a
    row whose first positions see no key (q_start < 0) and a full cache.
    The statistics the forward saves match attend_lse_ref."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(10 + D)
    S, Hkv = 160, 2
    rel = lambda a, b: _rel_err(a, b)
    for groups in (1, 4, 8):
        Hq = Hkv * groups
        for T in (1, 16, 100, 130):
            for causal in (True, False):
                q_start = [0, max(0, 40 - T), 0, -5, S - T]
                kv_len = [T, 40, 0, S, S]
                q, k, v, do, qs, kl = _bwd_case(g, 5, T, S, Hq, Hkv, D,
                                                q_start, kv_len, dtype, dev)
                kw = dict(scale=D ** -0.5, causal=causal, q_start=qs,
                          kv_len=kl)
                out, lse = FA.flash_attend(q, k, v, return_lse=True, **kw)
                lse_ref = FA.attend_lse_ref(q, k, **kw)
                case = (groups, T, causal)
                assert (lse - lse_ref).abs().max().item() < 1e-3, case
                got = FA.flash_attend_bwd(q, k, v, out, lse, do, **kw)
                want = FA.attend_bwd_ref(q, k, v, out, lse, do, **kw)
                for name, a, b in zip("qkv", got, want):
                    assert a.dtype == b.dtype and a.shape == b.shape
                    assert rel(a, b) < BWD_TOL[dtype], (name, case)
                if dtype == "float32":
                    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                    ref = FA.attend_ref(*leaves, **kw)
                    auto = torch.autograd.grad(ref, leaves, do)
                    for name, a, b in zip("qkv", got, auto):
                        assert rel(a, b) < BWD_TOL[dtype], (name, case)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_bitwise_reproducible_on_card(dtype):
    """No atomics: two calls on the same inputs give the same bits, at the
    training shape (B 2, T = S 1024, 32/8 heads, D 64, causal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    q, k, v, do, qs, kl = _bwd_case(g, 2, 1024, 1024, 32, 8, 64, [0, 0],
                                    [1024, 1024], dtype, dev)
    kw = dict(scale=0.125, causal=True, q_start=qs, kv_len=kl)
    out, lse = FA.flash_attend(q, k, v, return_lse=True, **kw)
    before = FA.flash_attend.launches_bwd
    first = FA.flash_attend_bwd(q, k, v, out, lse, do, **kw)
    second = FA.flash_attend_bwd(q, k, v, out, lse, do, **kw)
    assert FA.flash_attend.launches_bwd == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    want = FA.attend_bwd_ref(q, k, v, out, lse, do, **kw)
    for a, b in zip(first, want):
        assert _rel_err(a, b) < BWD_TOL[dtype]


@pytest.mark.cuda
def test_attend_under_autograd_launches_both_kernels_on_card():
    """layers.attend with q/k/v that require grad goes through
    FlashAttention: one forward launch (prefill route, statistics written,
    even at a decode shape) and one backward launch; without grad it is
    one forward launch on its route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.models import layers as LYR
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(6)
    fa = FA.flash_attend
    for T in (1, 64):
        q, k, v, do, qs, kl = _bwd_case(g, 2, T, 64, 8, 2, 64, [0, 0],
                                        [64, 64], "float32", dev)
        leaves = [t.requires_grad_() for t in (q, k, v)]
        before = (fa.launches_prefill, fa.launches_decode, fa.launches_bwd)
        out = LYR.attend(*leaves, scale=0.125, causal=False)
        grads = torch.autograd.grad(out, leaves, do)
        assert (fa.launches_prefill, fa.launches_decode, fa.launches_bwd) \
            == (before[0] + 1, before[1], before[2] + 1)
        ref = FA.attend_ref(*leaves, scale=0.125, causal=False, q_start=qs,
                            kv_len=kl)
        for a, b in zip(grads, torch.autograd.grad(ref, leaves, do)):
            assert _rel_err(a, b) < BWD_TOL["float32"]
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["1f1b", "zb-h1"])
def test_reduced_train_step_card_matches_cpu(schedule):
    """A reduced llama (2 layers, d 128, head_dim 32, 2 stages, M 2)
    through the pipelined train step on the card and on the CPU with the
    same weights and batch: loss within 1e-4, every gradient within 1e-4
    of max |cpu|; the card step launches the forward 2 x 2 x (1 +
    recomputes) times and the backward once per layer and B/W tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.pipeline import runtime as RT
    from repro_torch.pipeline import stage as ST
    cfg = dataclasses.replace(
        get_config("llama3.2-1b").reduced(n_layers=2, d_model=128),
        n_kv_heads=2, stages=2)
    plan = ST.plan_stages(cfg)
    step = RT.make_train_step(cfg, plan, RT.PipelineConfig(
        n_microbatches=2, schedule=schedule))
    params = ST.init_stacked_params(cfg, 0, plan, device="cpu")
    batch = SyntheticLM(cfg.vocab, 64, 4, device="cpu").batch(0)
    to = lambda tree: {k: to(v) if isinstance(v, dict) else v.cuda()
                       for k, v in tree.items()}
    fa = FA.flash_attend
    before = (fa.launches, fa.launches_bwd)
    loss_c, grads_c = step(to(params), to(batch))
    n_bw = 2 if schedule == "zb-h1" else 1
    assert (fa.launches - before[0], fa.launches_bwd - before[1]) == \
        (2 * 2 * (1 + n_bw), 2 * 2 * n_bw)
    loss, grads = step(params, batch)
    assert abs(loss_c.item() - loss.item()) < 1e-4
    flat = lambda t: [x for v in t.values()
                      for x in (flat(v) if isinstance(v, dict) else [v])]
    for a, b in zip(flat(grads_c), flat(grads)):
        assert _rel_err(a.cpu(), b) < 1e-4
