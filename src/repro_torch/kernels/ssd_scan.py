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

Shapes: x [B,T,H,P], dt [B,T,H], A [H] (negative), Bm/Cm [B,T,N] (one
group shared by all heads), states [B,H,P,N].  x/Bm/Cm are float32 or
bfloat16 of one dtype and y comes back in it; dt, A and the states are
float32.  T must be a multiple of ``chunk``.

A tensor on the CPU takes the plain version (:func:`ssd_chunked_ref`); a
CUDA tensor launches the kernel or raises.  ``ssd_chunked.launches``
counts kernel launches, one per wrapper call (each launch issues the
kernel's four CUDA kernels: scores, chunk states, state passing, chunk
outputs).
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
    Returns (y [B,T,H,P] in x's dtype, final_state [B,H,P,N] f32)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    nc = T // chunk
    xf = x.float().reshape(Bsz, nc, chunk, H, P)
    dtf = dt.float().reshape(Bsz, nc, chunk, H)
    Bf = Bm.float().reshape(Bsz, nc, chunk, N)
    Cf = Cm.float().reshape(Bsz, nc, chunk, N)
    A = A.float()
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
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


# ---------------------------------------------------------------------------
# The kernel's wrappers.
# ---------------------------------------------------------------------------

def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_fwd.argtypes = [p] * 11 + [i] * 8 + [ll] * 15 + [p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
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
               chunk: int) -> bool:
    """Whether the kernel may load x, Bm, Cm (and its own scratch rows of
    N states and c scores) by 16-byte copies: every pointer and row stride
    16-byte aligned (a size-1 dim's stride moves nothing), N and 4 * chunk
    whole multiples of 16 bytes.  Otherwise it fills the same tiles by
    plain loads."""
    el = x.element_size()
    if Bm.shape[-1] * el % 16 or chunk % 4:
        return False
    return all(t.data_ptr() % 16 == 0
               and all(st * el % 16 == 0
                       for st, n in zip(t.stride()[:-1], t.shape[:-1])
                       if n > 1)
               for t in (x, Bm, Cm))


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
    lib = build.load("ssd_scan", _declare)
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
    return y, final


ssd_chunked.launches = 0


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 256) -> torch.Tensor:
    """The Pallas function's interface: y [B,T,H,P] from a zero state;
    ``chunk`` is clipped to T, dt and A are taken in float32."""
    y, _ = ssd_chunked(x, dt.float(), A.float(), Bm, Cm,
                       chunk=min(chunk, x.shape[1]))
    return y
