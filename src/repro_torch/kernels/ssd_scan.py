"""Mamba-2 SSD chunked scan: the hand-written Hopper kernel
(``csrc/ssd_scan.cu``), its wrappers, and its plain versions.

Port of the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (and of its
oracle ``repro/kernels/ref.py::ssd_scan_ref``), grown to the function the
JAX model's ``repro/models/layers.py::_ssd_chunked`` computes: an optional
initial state, and the final state beside y (the cached prefill needs
both).

* :func:`ssd_chunked` — ``(x, dt, A, Bm, Cm, chunk, init_state) ->
  (y, final_state)``; what the model calls.
* :func:`ssd_scan` — the Pallas function's signature: y only, zero
  initial state, ``chunk`` clipped to T.
* :func:`ssd_chunked_split_ref` — the kernel's algorithm (Mamba-2's
  chunk-parallel split) in plain torch, for the tests.
* :func:`ssd_chunked_bwd` — its gradient, ``(x, dt, A, Bm, Cm, dy,
  dfinal) -> (dx, ddt, dA, dBm, dCm, dinit)``: the backward kernel on a
  CUDA tensor, :func:`ssd_chunked_bwd_ref` on a CPU tensor.
* :class:`SSDChunked` — :func:`ssd_chunked` with that gradient, for
  autograd on the card.

Shapes: x [B,T,H,P], dt [B,T,H], A [H] (negative), Bm/Cm [B,T,N] (one
group shared by all heads), states [B,H,P,N].  x/Bm/Cm are float32 or
bfloat16 of one dtype and y comes back in it; dt, A and the states are
float32.  T must be a multiple of ``chunk``.

A tensor on the CPU takes the plain version (:func:`ssd_chunked_ref`); a
CUDA tensor launches the kernel or raises.  ``ssd_chunked.launches``
counts kernel launches, one per wrapper call (each launch issues the
kernel's four CUDA kernels: scores, chunk states, state passing, chunk
outputs); ``ssd_chunked.launches_bwd`` counts the backward's launches,
one per :func:`ssd_chunked_bwd` call (eight CUDA kernels each: the
gradient's readout state, the reverse pass over chunks, the scores'
gradient summed over head groups and then over the groups, dx, dB and dC
along their reduction axis, dcum's reverse scan, the parts' sum).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
MAX_STATE = 256                  # d_state the kernel is built and tested for
MAX_CHUNK = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's reference in chip_smoke.py).
# ---------------------------------------------------------------------------

def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, *,
                 init_state: Optional[torch.Tensor] = None):
    """Sequential SSD recurrence, one position at a time.  Returns
    (y [B,T,H,P] in x's dtype, final_state [B,H,P,N] f32)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    st = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    A = A.float()
    ys = []
    for t in range(T):
        dtt = dt[:, t].float()                                 # [B,H]
        dA = torch.exp(dtt * A[None, :])
        upd = (dtt[:, :, None] * x[:, t].float())[..., None] \
            * Bm[:, t].float()[:, None, None, :]               # [B,H,P,N]
        st = st * dA[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), st))
    return torch.stack(ys, dim=1).to(x.dtype), st


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                    init_state: Optional[torch.Tensor] = None):
    """The chunked math of the JAX model's ``_ssd_chunked``, one chunk at
    a time, every contraction pairwise (no [B,c,c,H,P] intermediate).
    Returns (y [B,T,H,P] in x's dtype, final_state [B,H,P,N] f32).  In
    f32, as the JAX model computes it; float64 inputs are computed, and
    the final state returned, in float64 (a reference for the f32
    rounding of the long in-chunk sums of dt*A)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    nc = T // chunk
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(ct).reshape(Bsz, nc, chunk, H, P)
    dtf = dt.to(ct).reshape(Bsz, nc, chunk, H)
    Bf = Bm.to(ct).reshape(Bsz, nc, chunk, N)
    Cf = Cm.to(ct).reshape(Bsz, nc, chunk, N)
    A = A.to(ct)
    state = (torch.zeros((Bsz, H, P, N), dtype=ct, device=x.device)
             if init_state is None else init_state.to(ct))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for ci in range(nc):
        xc, dtc, Bc, Cc = xf[:, ci], dtf[:, ci], Bf[:, ci], Cf[:, ci]
        dA_cum = torch.cumsum(dtc * A[None, None, :], dim=1)   # [B,c,H]
        # intra-chunk; the mask goes before exp
        seg = dA_cum[:, :, None, :] - dA_cum[:, None, :, :]    # [B,c,s,H]
        Lmat = torch.exp(torch.where(causal[None, :, :, None], seg, NEG_INF))
        scores = torch.einsum("bcn,bsn->bcs", Cc, Bc)
        w = scores[..., None] * Lmat * dtc[:, None, :, :]      # [B,c,s,H]
        y_diag = torch.einsum("bcsh,bshp->bchp", w, xc)
        # carried-state readout
        y_off = torch.einsum("bcn,bhpn->bchp", Cc, state) \
            * torch.exp(dA_cum)[..., None]
        # state update
        decay_to_end = torch.exp(dA_cum[:, -1:, :] - dA_cum)   # [B,c,H]
        wx = (decay_to_end * dtc)[..., None] * xc              # [B,s,H,P]
        chunk_state = torch.einsum("bshp,bsn->bhpn", wx, Bc)
        state = state * torch.exp(dA_cum[:, -1, :])[..., None, None] \
            + chunk_state
        ys.append((y_diag + y_off).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, T, H, P)
    return y, state


def ssd_chunked_split_ref(x: torch.Tensor, dt: torch.Tensor,
                          A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                          *, chunk: int,
                          init_state: Optional[torch.Tensor] = None):
    """The CUDA kernel's algorithm, Mamba-2's chunk-parallel split, in
    plain torch: the scores C.B^T of every chunk, every chunk's own state
    from a zero start, then the short pass over chunks that hands each
    chunk its passed-in state, then every chunk's output from its
    passed-in state.  dt*A is scanned in double and each decay exponent
    formed in double, as the kernel does.  Holds [B, nc, c, c, H]
    intermediates: tests only.  Returns (y [B,T,H,P] in x's dtype,
    final_state [B,H,P,N] f32)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    nc, c = T // chunk, chunk
    xf = x.float().reshape(Bsz, nc, c, H, P)
    dtf = dt.float().reshape(Bsz, nc, c, H)
    Bf = Bm.float().reshape(Bsz, nc, c, N)
    Cf = Cm.float().reshape(Bsz, nc, c, N)
    cum = torch.cumsum(dtf.double() * A.double(), dim=2)       # [B,nc,c,H]
    # 1. scores, shared by every head
    G = torch.einsum("bkin,bkjn->bkij", Cf, Bf)
    # 2. each chunk's own state
    wend = torch.exp((cum[:, :, -1:] - cum).float()) * dtf     # [B,nc,c,H]
    S = torch.einsum("bkjhp,bkjh,bkjn->bkhpn", xf, wend, Bf)
    # 3. state passing
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    passed = []
    for k in range(nc):
        passed.append(state)
        state = state * torch.exp(cum[:, k, -1].float())[..., None, None] \
            + S[:, k]
    S_in = torch.stack(passed, dim=1)                          # [B,nc,H,P,N]
    # 4. outputs; the mask goes before exp
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [B,nc,i,j,H]
    Lmat = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                 NEG_INF).float())
    W = G[..., None] * Lmat * dtf[:, :, None, :, :]
    y = torch.einsum("bkijh,bkjhp->bkihp", W, xf) \
        + torch.einsum("bkin,bkhpn->bkihp", Cf, S_in) \
        * torch.exp(cum.float())[..., None]
    return y.reshape(Bsz, T, H, P).to(x.dtype), state


def ssd_chunked_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                        dfinal: Optional[torch.Tensor] = None, *, chunk: int,
                        init_state: Optional[torch.Tensor] = None):
    """The gradient of :func:`ssd_chunked_ref` (y and the final state) in
    plain torch, by the chunk-parallel split the backward kernel runs, one
    chunk's [B, c, c, H] intermediates at a time.  ``dfinal`` None means a
    zero gradient of the final state.  dt*A is scanned in double and each
    decay exponent formed in double, as in the forward.  Returns (dx
    [B,T,H,P] and dBm, dCm [B,T,N] in x's dtype; ddt [B,T,H], dA [H] and
    dinit [B,H,P,N] f32; dinit None without ``init_state``).

    Per row, chunk and head, with cum the in-chunk scan of dt*A, L[i,j] =
    exp(cum_i - cum_j) (j <= i), G = C.B^T, W = G L dt_j, S_in the state
    passed in and e = exp(cum_end):

    * the state gradient runs backwards: g = dfinal, then per chunk
      dS_own = g and g <- e g + sum_i exp(cum_i) dy_i (x) C_i; dinit = g;
    * dx_j = sum_i W[i,j] dy_i + exp(cum_end - cum_j) dt_j dS_own B_j;
    * with dW[i,j] = dy_i . x_j, the scores' gradient dG = sum_h dW L dt_j
      gives dC_i += sum_j dG B_j and dB_j += sum_i dG C_i; each head adds
      dC_i += exp(cum_i) S_in^T dy_i and dB_j += exp(cum_end - cum_j) dt_j
      dS_own^T x_j;
    * dcum gathers sum_j dW W at i and minus it at j, dy_i . y_off_i,
      -q_j at j and sum_j q_j at the chunk's end (q_j = exp(cum_end -
      cum_j) dt_j x_j . dS_own B_j), and e sum g.S_in at the end; its
      reverse cumsum R gives ddt += A R and dA = sum dt R, beside ddt's
      direct terms sum_i dW G L and q_j / dt_j.  The pairs i = j, which
      the first two terms hold once each and which cancel exactly, are
      left out of both: where the decay is steep their two rounded
      copies would be most of dcum, and their rounding would set dA's
      (a_log's gradient) and ddt's error."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    nc, c = T // chunk, chunk
    dev = x.device
    xf = x.float().reshape(Bsz, nc, c, H, P)
    dtf = dt.float().reshape(Bsz, nc, c, H)
    Bf = Bm.float().reshape(Bsz, nc, c, N)
    Cf = Cm.float().reshape(Bsz, nc, c, N)
    dyf = dy.float().reshape(Bsz, nc, c, H, P)
    cum = torch.cumsum(dtf.double() * A.double(), dim=2)       # [B,nc,c,H]
    e_in = torch.exp(cum.float())                              # exp(cum_i)
    e_out = torch.exp((cum[:, :, -1:] - cum).float())          # to the end
    e_chunk = torch.exp(cum[:, :, -1].float())                 # [B,nc,H]
    wend = e_out * dtf
    # the forward's passed-in states
    S_own = torch.einsum("bkjhp,bkjh,bkjn->bkhpn", xf, wend, Bf)
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
             if init_state is None else init_state.float())
    S_in = []
    for k in range(nc):
        S_in.append(state)
        state = state * e_chunk[:, k, :, None, None] + S_own[:, k]
    # the state gradient, carried backwards over the chunks
    Z = torch.einsum("bkihp,bkih,bkin->bkhpn", dyf, e_in, Cf)
    g = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
         if dfinal is None else dfinal.float())
    dS, g_end = [None] * nc, [None] * nc
    for k in reversed(range(nc)):
        dS[k] = g
        g_end[k] = e_chunk[:, k] * (g * S_in[k]).sum((-1, -2))  # [B,H]
        g = g * e_chunk[:, k, :, None, None] + Z[:, k]
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    eye = torch.eye(c, dtype=torch.bool, device=dev)
    dx = torch.empty_like(xf)
    ddt = torch.empty_like(dtf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros((H,), dtype=torch.float64, device=dev)
    for k in range(nc):
        xk, dyk, dtk, Bk, Ck = xf[:, k], dyf[:, k], dtf[:, k], Bf[:, k], \
            Cf[:, k]
        seg = cum[:, k, :, None, :] - cum[:, k, None, :, :]    # [B,i,j,H]
        Lm = torch.exp(torch.where(causal[None, :, :, None], seg,
                                   NEG_INF).float())
        GL = torch.einsum("bin,bjn->bij", Ck, Bk)[..., None] * Lm
        dW = torch.einsum("bihp,bjhp->bijh", dyk, xk)
        U = torch.einsum("bhpn,bjn->bjhp", dS[k], Bk)          # dS_own B_j
        dx[:, k] = torch.einsum("bijh,bihp->bjhp",
                                GL * dtk[:, None], dyk) \
            + wend[:, k, ..., None] * U
        r = e_out[:, k] * (xk * U).sum(-1)                     # q_j / dt_j
        dG = (dW * Lm * dtk[:, None]).sum(-1)                  # [B,i,j]
        dC_off = torch.einsum("bih,bihp,bhpn->bihn", e_in[:, k], dyk,
                              S_in[k])
        dC[:, k] = torch.einsum("bij,bjn->bin", dG, Bk) + dC_off.sum(2)
        dB[:, k] = torch.einsum("bij,bin->bjn", dG, Ck) \
            + torch.einsum("bjh,bjhp,bhpn->bjn", wend[:, k], xk, dS[k])
        E = dW * GL                                            # dW G L
        col = E.sum(1)                                         # at j
        Eo = E.masked_fill(eye[None, :, :, None], 0.0)         # i != j
        q = dtk * r
        dcum = ((Eo * dtk[:, None]).sum(2) - dtk * Eo.sum(1)
                + (dC_off * Ck[:, :, None, :]).sum(-1) - q).double()
        dcum[:, -1] += q.sum(1) + g_end[k]
        R = dcum.flip(1).cumsum(1).flip(1)                     # [B,c,H]
        ddt[:, k] = (col + r + A.double() * R).float()
        dA += (dtk.double() * R).sum((0, 1))
    return (dx.reshape(Bsz, T, H, P).to(x.dtype),
            ddt.reshape(Bsz, T, H).to(dt.dtype), dA.to(A.dtype),
            dB.reshape(Bsz, T, N).to(Bm.dtype),
            dC.reshape(Bsz, T, N).to(Cm.dtype),
            None if init_state is None else g)


# ---------------------------------------------------------------------------
# The kernel's wrappers.
# ---------------------------------------------------------------------------

def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_fwd.argtypes = [p] * 11 + [i] * 8 + [ll] * 15 + [p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [p] * 26 + [i] * 8 + [ll] * 13 + [p]
    lib.ssd_scan_bwd.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [i]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


def _check_shapes(x, dt, A, Bm, Cm, chunk, init_state):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or Cm.dim() != 3:
        raise ValueError(f"want x [B,T,H,P], dt [B,T,H], A [H], Bm/Cm "
                         f"[B,T,N]; got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (B, T, H) or A.shape != (H,) or Bm.shape != (B, T, N) \
            or Cm.shape != (B, T, N):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if chunk <= 0 or T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")
    if init_state is not None and init_state.shape != (B, H, P, N):
        raise ValueError(f"init_state {tuple(init_state.shape)}, want "
                         f"{(B, H, P, N)}")


def _check_cuda(x, dt, A, Bm, Cm, chunk, init_state):
    tensors = dict(dt=dt, A=A, Bm=Bm, Cm=Cm)
    if init_state is not None:
        tensors["init_state"] = init_state
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise TypeError(f"the kernel takes float32 or bfloat16 x/Bm/Cm of "
                        f"one dtype; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    for name in ("dt", "A", "init_state"):
        t = tensors.get(name)
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if P not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {P}")
    if N > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(f"the kernel takes d_state <= {MAX_STATE} and "
                         f"chunk <= {MAX_CHUNK}; got {N}, {chunk}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit last stride, strides "
                             f"{t.stride()}")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    if init_state is not None and init_state.stride()[2:] != (N, 1):
        raise ValueError(f"init_state's [P,N] rows must be contiguous, "
                         f"strides {init_state.stride()}")


def copies_16b(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
               chunk: int, *more: torch.Tensor) -> bool:
    """Whether the kernel may load x, Bm, Cm (and ``more`` of x's dtype,
    the backward's dy; and its own scratch rows of N states and c scores)
    by 16-byte copies: every pointer and row stride 16-byte aligned (a
    size-1 dim's stride moves nothing), N and 4 * chunk whole multiples of
    16 bytes.  Otherwise it fills the same tiles by plain loads."""
    el = x.element_size()
    if Bm.shape[-1] * el % 16 or chunk % 4:
        return False
    return all(t.data_ptr() % 16 == 0
               and all(st * el % 16 == 0
                       for st, n in zip(t.stride()[:-1], t.shape[:-1])
                       if n > 1)
               for t in (x, Bm, Cm) + more)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """The chunked SSD scan seeded with ``init_state`` (zero if None).
    Returns (y [B,T,H,P] in x's dtype, final_state [B,H,P,N] f32).  The
    final state is a new tensor (never ``init_state``'s storage)."""
    _check_shapes(x, dt, A, Bm, Cm, chunk, init_state)
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk,
                               init_state=init_state)
    y, final, _ = _launch_fwd(x, dt, A, Bm, Cm, chunk, init_state)
    return y, final


def ssd_chunked_saved(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                      init_state: Optional[torch.Tensor] = None):
    """:func:`ssd_chunked` on a CUDA tensor that also returns the forward
    kernel's scratch, which :func:`ssd_chunked_bwd` takes as ``saved``:
    (y, final_state, (scores [B,nc,c,c] f32, the passed-in states
    [B,nc,H,P,N] f32, cum [B,nc,H,c] f64)).  One forward launch."""
    _check_shapes(x, dt, A, Bm, Cm, chunk, init_state)
    return _launch_fwd(x, dt, A, Bm, Cm, chunk, init_state)


def _launch_fwd(x, dt, A, Bm, Cm, chunk, init_state, lib=None):
    """One forward launch (``lib``: the built library, by default this
    source's; ``tools/ssd_ab.py`` passes another version's)."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked runs on cuda or cpu, not {x.device}")
    _check_cuda(x, dt, A, Bm, Cm, chunk, init_state)
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    dev = x.device
    y = torch.empty((B, T, H, P), dtype=x.dtype, device=dev)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    nc = T // chunk
    # scratch: C.B^T once per (batch row, chunk), shared by every head;
    # each chunk's own state, then (in place) its passed-in state; the
    # chunk's dt*A scan in double
    scores = torch.empty((B, nc, chunk, chunk), dtype=torch.float32,
                         device=dev)
    states = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=dev)
    cum = torch.empty((B, nc, H, chunk), dtype=torch.float64, device=dev)
    lib = lib or build.load("ssd_scan", _declare)
    si = (0, 0) if init_state is None else init_state.stride()[:2]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), final.data_ptr(), scores.data_ptr(),
            states.data_ptr(), cum.data_ptr(),
            B, T, H, P, N, chunk, _DTYPE_CODE[x.dtype],
            int(copies_16b(x, Bm, Cm, chunk)), *x.stride()[:3],
            *dt.stride(), *Bm.stride()[:2],
            *Cm.stride()[:2], *y.stride()[:3], *si, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_fwd failed: CUDA error {rc} "
                           f"({lib.ssd_scan_error_string(rc).decode()})")
    ssd_chunked.launches += 1
    return y, final, (scores, states, cum)


ssd_chunked.launches = 0
ssd_chunked.launches_bwd = 0


#: heads a block of the backward's dG and dB/dC kernels sums (``HG`` in
#: csrc/ssd_scan.cu)
HEAD_GROUP = 10


def bwd_scratch(B: int, T: int, H: int, P: int, N: int,
                chunk: int) -> dict:
    """The shapes of the backward kernel's scratch (f32; ``dapart`` f64),
    in the order of ``ssd_scan_bwd``'s parameters in csrc/ssd_scan.cu: nt
    64-row tiles of a chunk, nnb 64-column blocks of N, npass blocks of
    the reverse pass, ng groups of :data:`HEAD_GROUP` heads.  Only the
    state gradients and small per-position sums are per head: the scores'
    gradient is summed over each group's heads (``dgp``) and then over the
    groups (``dg``), and dB, dC are summed along their reduction axis into
    one part per group and one for the intra-chunk term (``dbcp``); the
    column sums' last slot holds the diagonal of dW G L, which ``dcum``
    leaves out (``cs``)."""
    nc, c = T // chunk, chunk
    nt, nnb, npass = -(-c // 64), -(-N // 64), -(-(P * N // 4) // 256)
    ng = -(-H // HEAD_GROUP)
    return dict(dstates=(B, nc, H, P, N), dgp=(B, nc, ng, c, c),
                dg=(B, nc, c, c), rs=(B, nc, H, nt, c),
                cs=(B, nc, H, nt + 1, c), yoff=(B, nc, H, nnb, c),
                r=(B, nc, H, c),
                gpart=(B, nc, H, npass), dbcp=(2, B, nc, ng + 1, c, N),
                dapart=(B, nc, H))


def ssd_chunked_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                    dfinal: Optional[torch.Tensor] = None, *, chunk: int,
                    init_state: Optional[torch.Tensor] = None,
                    saved: Optional[tuple] = None):
    """The gradient of :func:`ssd_chunked`: from dy [B,T,H,P] (x's dtype)
    and dfinal [B,H,P,N] (None: zero), returns (dx, ddt, dA, dBm, dCm,
    dinit) as :func:`ssd_chunked_bwd_ref` does (dinit None without
    ``init_state``).  On a CUDA tensor one launch of the backward kernel
    (counted in ``ssd_chunked.launches_bwd``), from ``saved``, the forward
    kernel's scratch of the same inputs (:func:`ssd_chunked_saved`; None
    runs the forward first, one more forward launch); on a CPU tensor
    :func:`ssd_chunked_bwd_ref`."""
    _check_shapes(x, dt, A, Bm, Cm, chunk, init_state)
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must match x "
                         f"{tuple(x.shape)}")
    if dfinal is not None and dfinal.shape != (B, H, P, N):
        raise ValueError(f"dfinal {tuple(dfinal.shape)}, want "
                         f"{(B, H, P, N)}")
    if x.device.type == "cpu":
        return ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk,
                                   init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked_bwd runs on cuda or cpu, not "
                         f"{x.device}")
    _check_cuda(x, dt, A, Bm, Cm, chunk, init_state)
    if dy.device != x.device or dy.dtype != x.dtype or dy.stride(-1) != 1:
        raise ValueError(f"dy must be {x.dtype} on {x.device} with a unit "
                         f"last stride")
    if dfinal is not None:
        if dfinal.device != x.device or dfinal.dtype != torch.float32:
            raise TypeError(f"dfinal must be float32 on {x.device}")
        dfinal = dfinal.contiguous()
    if saved is None:
        saved = _launch_fwd(x, dt, A, Bm, Cm, chunk, init_state)[2]
    out = _launch_bwd(build.load("ssd_scan", _declare), x, dt, A, Bm, Cm,
                      dy, dfinal, chunk, init_state, saved)
    ssd_chunked.launches_bwd += 1
    return out


def _launch_bwd(lib, x, dt, A, Bm, Cm, dy, dfinal, chunk, init_state, saved,
                scratch=bwd_scratch):
    """One backward launch of ``lib`` on checked CUDA inputs, with the
    scratch whose shapes ``scratch`` gives (``tools/ssd_ab.py`` passes an
    earlier version's)."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    scores, states, cum = saved
    nc = T // chunk
    if (scores.shape != (B, nc, chunk, chunk)
            or states.shape != (B, nc, H, P, N)
            or cum.shape != (B, nc, H, chunk)):
        raise ValueError("saved is not the forward's scratch of these shapes")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    work = [torch.empty(shape, **(dict(f32, dtype=torch.float64)
                                  if k == "dapart" else f32))
            for k, shape in scratch(B, T, H, P, N, chunk).items()]
    dx = torch.empty((B, T, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, T, H), **f32)
    dA = torch.empty((H,), **f32)
    dB = torch.empty((B, T, N), dtype=x.dtype, device=dev)
    dC = torch.empty((B, T, N), dtype=x.dtype, device=dev)
    dinit = (None if init_state is None
             else torch.empty((B, H, P, N), **f32))
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(), ptr(dfinal), scores.data_ptr(),
            states.data_ptr(), cum.data_ptr(),
            *(t.data_ptr() for t in work),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), ptr(dinit),
            B, T, H, P, N, chunk, _DTYPE_CODE[x.dtype],
            int(copies_16b(x, Bm, Cm, chunk, dy)), *x.stride()[:3],
            *dt.stride(), *Bm.stride()[:2], *Cm.stride()[:2],
            *dy.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd failed: CUDA error {rc} "
                           f"({lib.ssd_scan_error_string(rc).decode()})")
    return dx, ddt, dA, dB, dC, dinit


class SSDChunked(torch.autograd.Function):
    """:func:`ssd_chunked` with a gradient on the card: the forward is one
    forward launch that keeps its scratch (scores, passed-in states, the
    double cum); the backward is one :func:`ssd_chunked_bwd` launch.  x,
    dt, A, Bm, Cm and init_state get gradients; a missing output gradient
    (y's or the final state's) counts as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int, init_state=None):
        y, final, saved = ssd_chunked_saved(x, dt, A, Bm, Cm, chunk=chunk,
                                            init_state=init_state)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state, *saved)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, init_state, *saved = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dx, ddt, dA, dB, dC, dinit = ssd_chunked_bwd(
            x, dt, A, Bm, Cm, dy, dfinal, chunk=ctx.chunk,
            init_state=init_state, saved=tuple(saved))
        return dx, ddt, dA, dB, dC, None, dinit


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 256) -> torch.Tensor:
    """The Pallas function's interface: y [B,T,H,P] from a zero state;
    ``chunk`` is clipped to T, dt and A are taken in float32."""
    y, _ = ssd_chunked(x, dt.float(), A.float(), Bm, Cm,
                       chunk=min(chunk, x.shape[1]))
    return y
