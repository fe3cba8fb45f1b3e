"""DNN profiling for BaPipe (the port's copy of ``repro/core/profiler.py``;
its measured mode times in torch).

The paper profiles every layer of the network to obtain (a) FP/BP compute
time per accelerator type, (b) weights size, (c) output-feature size
(paper Fig. 3, "DNN profile").  On GPU clusters it measures a 1000-minibatch
run; for FPGA clusters it *derives* the profile analytically from the DNN
configuration and the hardware constraints.  The analytic route is the
default here, as in the JAX package; the measured mode times a reduced
block proxy on a device the caller names (the card by default, with CUDA
events; the CPU only when asked).

Units: ``flops_*``  are FLOPs per *unit* (one token for sequence models, one
sample for conv nets); ``bytes_*`` are bytes at the profile dtype.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.hardware import DeviceSpec
from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    name: str
    flops_fwd: float            # per unit
    bytes_weights: float        # parameter bytes
    bytes_act_out: float        # boundary activation bytes per unit
    flops_bwd: float = 0.0      # default: 2x fwd (dL/dx and dL/dw matmuls)
    # Fraction of the backward spent in the weight-gradient (W) half —
    # the zero-bubble split the cost-shaped schedules consume.  0.5 is
    # the pure-weight-matmul point (dL/dx and dL/dw are the same GEMM
    # transposed); attention/scan work has no dL/dw, so its layers sit
    # below 0.5.  Analytic by default; :func:`measure_w_frac` measures
    # it from real vjp timings on a representative layer.
    w_frac: float = 0.5

    def __post_init__(self):
        if self.flops_bwd == 0.0:
            object.__setattr__(self, "flops_bwd", 2.0 * self.flops_fwd)
        if not 0.0 < self.w_frac < 1.0:
            raise ValueError(f"w_frac must be in (0, 1), got {self.w_frac}")


@dataclasses.dataclass(frozen=True)
class NetworkProfile:
    """Per-layer profile of a network, at a fixed sequence length."""

    name: str
    layers: tuple[LayerProfile, ...]
    unit: str                   # "token" | "sample"
    bytes_per_param: int = 2    # bf16
    # embed / head live outside the partitioned layer sequence but count
    # toward stage-0 / stage-(N-1) load and memory.
    embed: LayerProfile | None = None
    head: LayerProfile | None = None

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def total_flops_fwd(self) -> float:
        return sum(l.flops_fwd for l in self.layers)

    def total_bytes_weights(self) -> float:
        return sum(l.bytes_weights for l in self.layers)


# ---------------------------------------------------------------------------
# Analytic time model (per micro-batch of ``units`` tokens/samples).
# ---------------------------------------------------------------------------

def fwd_time(layer: LayerProfile, dev: DeviceSpec, units: int) -> float:
    """Roofline per layer: compute-bound or weight-streaming-bound."""
    compute = units * layer.flops_fwd / dev.effective_flops
    memory = layer.bytes_weights / dev.hbm_bandwidth
    return max(compute, memory)


def bwd_time(layer: LayerProfile, dev: DeviceSpec, units: int) -> float:
    compute = units * layer.flops_bwd / dev.effective_flops
    memory = 2.0 * layer.bytes_weights / dev.hbm_bandwidth   # read W, write dW
    return max(compute, memory)


def bwd_split_time(layer: LayerProfile, dev: DeviceSpec,
                   units: int) -> tuple[float, float]:
    """(input-gradient, weight-gradient) split of :func:`bwd_time` by
    the layer's ``w_frac`` — the per-layer form of the zero-bubble B/W
    durations the cost-shaped schedules consume."""
    t = bwd_time(layer, dev, units)
    return t * (1.0 - layer.w_frac), t * layer.w_frac


def comm_time(act_bytes: float, link_bandwidth: float) -> float:
    return act_bytes / link_bandwidth


# Megatron-style tensor parallelism all-reduces the block's activation
# twice per forward pass (attention out-proj + MLP out-proj) and twice
# per backward pass; each is a ring AR of the boundary activation over
# the stage's tp chips on the ``tensor`` axis.
TP_COLLECTIVES_FWD = 2
TP_COLLECTIVES_BWD = 2


def tp_collective_time(layer: LayerProfile, dev: DeviceSpec, units: int,
                       tp: int, n_collectives: int = TP_COLLECTIVES_FWD
                       ) -> float:
    """Per-micro-batch tensor-parallel collective cost of one layer:
    ``n_collectives`` ring all-reduces of the layer's activation over
    ``tp`` chips, priced at the device's ``tensor`` axis bandwidth —
    NOT the stage link (see :meth:`DeviceSpec.axis_bandwidth`)."""
    if tp <= 1:
        return 0.0
    bw = dev.axis_bandwidth("tensor")
    return n_collectives * 2.0 * (tp - 1) / tp \
        * units * layer.bytes_act_out / bw


def fwd_time_tp(layer: LayerProfile, dev: DeviceSpec, units: int,
                tp: int) -> float:
    """TP-sharded forward roofline: flops and weight streaming both
    shard 1/tp (Megatron column/row splits), plus the per-layer TP
    collective — the explicit price of buying width."""
    if tp <= 1:
        return fwd_time(layer, dev, units)
    compute = units * layer.flops_fwd / tp / dev.effective_flops
    memory = layer.bytes_weights / tp / dev.hbm_bandwidth
    return max(compute, memory) \
        + tp_collective_time(layer, dev, units, tp, TP_COLLECTIVES_FWD)


def bwd_time_tp(layer: LayerProfile, dev: DeviceSpec, units: int,
                tp: int) -> float:
    if tp <= 1:
        return bwd_time(layer, dev, units)
    compute = units * layer.flops_bwd / tp / dev.effective_flops
    memory = 2.0 * layer.bytes_weights / tp / dev.hbm_bandwidth
    return max(compute, memory) \
        + tp_collective_time(layer, dev, units, tp, TP_COLLECTIVES_BWD)


def bwd_split_time_tp(layer: LayerProfile, dev: DeviceSpec, units: int,
                      tp: int) -> tuple[float, float]:
    """(input-gradient, weight-gradient) split of :func:`bwd_time_tp`.
    The backward's TP collectives sit on the input-gradient (B) half —
    dL/dx is what crosses the shards; dL/dw is shard-local — so the
    collective term lands on B, keeping W a pure local GEMM the
    zero-bubble schedules can float freely."""
    if tp <= 1:
        return bwd_split_time(layer, dev, units)
    compute = units * layer.flops_bwd / tp / dev.effective_flops
    memory = 2.0 * layer.bytes_weights / tp / dev.hbm_bandwidth
    t = max(compute, memory)
    coll = tp_collective_time(layer, dev, units, tp, TP_COLLECTIVES_BWD)
    return t * (1.0 - layer.w_frac) + coll, t * layer.w_frac


# ---------------------------------------------------------------------------
# Transformer-family analytic profiles (the 10 assigned architectures).
# ---------------------------------------------------------------------------

def _attn_flops(cfg: ArchConfig, seq: int,
                layer_idx: int) -> tuple[float, float, float]:
    """(flops_per_token, weight_params, weight_matmul_flops) for the
    attention sub-block — the third element is the projection share
    (flops with a dL/dw counterpart; the QK^T/PV span work has none)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    # effective attended length (causal average; window caps it)
    span = seq / 2
    if cfg.window > 0 and not cfg.is_global_layer(layer_idx):
        span = min(span, cfg.window)
    if cfg.attn_kind == "mla":
        m = cfg.mla
        qk_dim = m.qk_nope_dim + m.qk_rope_dim
        w = 0.0
        if m.q_lora_rank:
            w += d * m.q_lora_rank + m.q_lora_rank * nh * qk_dim
        else:
            w += d * nh * qk_dim
        w += d * (m.kv_lora_rank + m.qk_rope_dim)
        w += m.kv_lora_rank * nh * (m.qk_nope_dim + m.v_head_dim)
        w += nh * m.v_head_dim * d
        proj_flops = 2.0 * w
        attn_flops = 2.0 * span * nh * (qk_dim + m.v_head_dim)
        return proj_flops + attn_flops, w, proj_flops
    else:
        w = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        proj_flops = 2.0 * w
        attn_flops = 2.0 * span * nh * hd * 2     # QK^T and PV
        return proj_flops + attn_flops, w, proj_flops


def _ffn_flops(cfg: ArchConfig,
               layer_idx: int) -> tuple[float, float, float]:
    d = cfg.d_model
    if cfg.moe is not None and layer_idx >= cfg.moe.first_k_dense:
        m = cfg.moe
        w_active = (m.n_shared + m.top_k) * 3 * d * m.d_ff_expert + d * m.n_routed
        w_total = (m.n_shared + m.n_routed) * 3 * d * m.d_ff_expert + d * m.n_routed
        return 2.0 * w_active, w_total, 2.0 * w_active
    w = 3 * d * cfg.d_ff
    return 2.0 * w, w, 2.0 * w


def _ssm_flops(cfg: ArchConfig) -> tuple[float, float, float]:
    d = cfg.d_model
    s = cfg.ssm
    d_inner = s.expand * d
    nh = s.n_heads(d)
    w = (d * (2 * d_inner + 2 * s.d_state + nh)   # in_proj (x,z,B,C,dt)
         + s.d_conv * (d_inner + 2 * s.d_state)   # conv1d
         + d_inner * d)                            # out_proj
    proj = 2.0 * w
    scan = 6.0 * d_inner * s.d_state               # state update + readout
    return proj + scan, w, proj


def _analytic_w_frac(flops_fwd: float, flops_wgrad: float) -> float:
    """Weight-gradient share of the backward from the analytic model:
    the backward is 2x the forward, of which the dL/dw GEMMs redo
    exactly the weight-matmul share of the forward (attention/scan work
    has no weight gradient)."""
    if flops_fwd <= 0:
        return 0.5
    return min(0.95, max(0.05, 0.5 * flops_wgrad / flops_fwd))


def layer_kind(cfg: ArchConfig, layer_idx: int) -> str:
    """Timing kind of layer ``layer_idx`` for the measured B/W split:
    ``"moe"`` for expert-FFN layers (past ``first_k_dense``), ``"ssm"``
    for pure state-space trunks (associative-scan recurrence in place of
    attention), ``"dense"`` otherwise.  Hybrid trunks time as
    ``"dense"`` — their attention dominates the no-dL/dw share and the
    dense proxy's softmax term stands in for the scan."""
    if cfg.moe is not None and layer_idx >= cfg.moe.first_k_dense:
        return "moe"
    if cfg.family == "ssm":
        return "ssm"
    return "dense"


def profile_arch(cfg: ArchConfig, seq: int = 4096,
                 device="cuda") -> NetworkProfile:
    """Analytic per-layer profile at sequence length ``seq``.

    Each layer carries its B/W backward split (``LayerProfile.w_frac``):
    analytic by default (weight-matmul share of the layer's flops), or —
    when ``cfg.profile_w_frac == "measured"`` — measured from real vjp
    timings of one representative layer PER DISTINCT LAYER KIND
    (:func:`measure_w_frac`; a mixed dense+MoE trunk times both proxies,
    where it used to time one block and smear its split over every
    layer), falling back to the per-layer analytic split for any kind
    whose timing is unavailable.  ``device`` is where the measured mode
    times (unused by the analytic one)."""
    bpp = 2
    d = cfg.d_model
    act_out = float(d * bpp)
    if cfg.profile_w_frac not in ("analytic", "measured"):
        raise ValueError(f"profile_w_frac must be 'analytic' or "
                         f"'measured', got {cfg.profile_w_frac!r}")
    measured: dict[str, float | None] = {}
    if cfg.profile_w_frac == "measured":
        kinds = {layer_kind(cfg, i) for i in range(cfg.n_layers)}
        measured = {k: measure_w_frac(cfg, seq=min(seq, 128), kind=k,
                                      device=device)
                    for k in sorted(kinds)}
    layers = []
    for i in range(cfg.n_layers):
        f, w, fw = 0.0, 0.0, 0.0
        is_enc = i < cfg.n_enc_layers
        if cfg.family == "ssm":
            fs, ws, ps = _ssm_flops(cfg)
            f, w, fw = f + fs, w + ws, fw + ps
        else:
            if cfg.attn_kind != "none":
                fa, wa, pa = _attn_flops(cfg, seq, i)
                f, w, fw = f + fa, w + wa, fw + pa
            if cfg.family == "hybrid":
                fs, ws, ps = _ssm_flops(cfg)
                f, w, fw = f + fs, w + ws, fw + ps
            if cfg.n_enc_layers and not is_enc:
                # decoder cross-attention over encoder frames
                fa, wa, pa = _attn_flops(cfg, seq, i)
                f, w, fw = f + fa, w + wa, fw + pa
        ff, wf_, pf = _ffn_flops(cfg, i)
        f, w, fw = f + ff, w + wf_, fw + pf
        # norms etc: negligible flops, tiny weights
        w += 2 * d
        wf_meas = measured.get(layer_kind(cfg, i))
        layers.append(LayerProfile(
            name=f"{cfg.arch_id}.L{i}", flops_fwd=f,
            bytes_weights=w * bpp, bytes_act_out=act_out,
            w_frac=wf_meas if wf_meas is not None
            else _analytic_w_frac(f, fw)))
    embed = LayerProfile(name="embed", flops_fwd=0.0,
                         bytes_weights=float(cfg.vocab * d * bpp),
                         bytes_act_out=act_out)
    head = LayerProfile(name="lm_head", flops_fwd=2.0 * d * cfg.vocab,
                        bytes_weights=0.0 if cfg.tie_embeddings
                        else float(cfg.vocab * d * bpp),
                        bytes_act_out=float(cfg.vocab * bpp))
    return NetworkProfile(name=cfg.arch_id, layers=tuple(layers),
                          unit="token", bytes_per_param=bpp,
                          embed=embed, head=head)


# ---------------------------------------------------------------------------
# The paper's own models (per-sample profiles) — feed the Table 3/4/6 benches.
# ---------------------------------------------------------------------------

_VGG16_CONV = [
    # (out_ch, spatial, in_ch)   224x224 ImageNet
    (64, 224, 3), (64, 224, 64),
    (128, 112, 64), (128, 112, 128),
    (256, 56, 128), (256, 56, 256), (256, 56, 256),
    (512, 28, 256), (512, 28, 512), (512, 28, 512),
    (512, 14, 512), (512, 14, 512), (512, 14, 512),
]


def profile_vgg16(bpp: int = 2) -> NetworkProfile:
    layers = []
    for i, (oc, sp, ic) in enumerate(_VGG16_CONV):
        w = 3 * 3 * ic * oc
        f = 2.0 * w * sp * sp
        layers.append(LayerProfile(
            name=f"conv{i}", flops_fwd=f, bytes_weights=w * bpp,
            bytes_act_out=float(oc * (sp // (2 if i in (1, 3, 6, 9) else 1)) ** 2 * bpp)))
    fcs = [(7 * 7 * 512, 4096), (4096, 4096), (4096, 1000)]
    for i, (fi, fo) in enumerate(fcs):
        layers.append(LayerProfile(
            name=f"fc{i}", flops_fwd=2.0 * fi * fo,
            bytes_weights=float(fi * fo * bpp), bytes_act_out=float(fo * bpp)))
    return NetworkProfile("vgg16", tuple(layers), unit="sample",
                          bytes_per_param=bpp)


_RESNET50_STAGES = [  # (n_blocks, width, spatial)
    (3, 64, 56), (4, 128, 28), (6, 256, 14), (3, 512, 7)]


def profile_resnet50(bpp: int = 2) -> NetworkProfile:
    layers = [LayerProfile("stem", flops_fwd=2.0 * 7 * 7 * 3 * 64 * 112 * 112,
                           bytes_weights=7 * 7 * 3 * 64 * bpp,
                           bytes_act_out=float(64 * 56 * 56 * bpp))]
    in_ch = 64
    for (n, w, sp) in _RESNET50_STAGES:
        for b in range(n):
            c_out = w * 4
            wts = in_ch * w + 3 * 3 * w * w + w * c_out
            if b == 0:
                wts += in_ch * c_out   # projection shortcut
            f = 2.0 * wts * sp * sp
            layers.append(LayerProfile(
                name=f"res{w}_{b}", flops_fwd=f, bytes_weights=wts * bpp,
                bytes_act_out=float(c_out * sp * sp * bpp)))
            in_ch = c_out
    layers.append(LayerProfile("fc", flops_fwd=2.0 * 2048 * 1000,
                               bytes_weights=2048 * 1000 * bpp,
                               bytes_act_out=1000.0 * bpp))
    return NetworkProfile("resnet50", tuple(layers), unit="sample",
                          bytes_per_param=bpp)


def profile_gnmt(n_lstm: int = 8, d: int = 1024, seq: int = 50,
                 vocab: int = 32000, bpp: int = 2) -> NetworkProfile:
    """GNMT: n_lstm/2 encoder + n_lstm/2 decoder LSTM layers (+attention)."""
    layers = []
    per_lstm_w = 4 * (d * d + d * d)          # input + recurrent gates
    per_lstm_f = 2.0 * per_lstm_w * seq       # per sample (seq tokens)
    for i in range(n_lstm):
        half = n_lstm // 2
        name = f"enc{i}" if i < half else f"dec{i - half}"
        f, w = per_lstm_f, per_lstm_w
        if i == half:                          # decoder attention layer
            w += 2 * d * d
            f += 2.0 * (2 * d * d) * seq + 2.0 * seq * seq * d
        layers.append(LayerProfile(
            name=name, flops_fwd=f, bytes_weights=float(w * bpp),
            bytes_act_out=float(d * seq * bpp)))
    layers.append(LayerProfile(
        "softmax", flops_fwd=2.0 * d * vocab * seq,
        bytes_weights=float(d * vocab * bpp),
        bytes_act_out=float(vocab * bpp)))
    return NetworkProfile(f"gnmt-{n_lstm}", tuple(layers), unit="sample",
                          bytes_per_param=bpp)


def profile_gnmt_L(n_lstm: int) -> NetworkProfile:
    """GNMT-L of paper Table 4: stacked L/2 encoder + L/2 decoder layers."""
    return profile_gnmt(n_lstm=n_lstm)


# ---------------------------------------------------------------------------
# Measured profiling — paper's GPU mode.
# ---------------------------------------------------------------------------

def _device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA request without a card raises
    (the measured mode never falls back to another device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"measured profiling on {device!r}: no CUDA "
                           f"card (pass device='cpu' to time on the CPU)")
    return dev


def measure_layer(fn: Callable, *args, iters: int = 5,
                  device="cuda") -> float:
    """Median time (s) of ``fn(*args)`` on ``device`` after one warm-up
    call: CUDA events around each call on a card, ``perf_counter`` on the
    CPU."""
    dev = _device(device)
    fn(*args)
    ts = []
    if dev.type == "cuda":
        for _ in range(iters):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn(*args)
            t1.record()
            t1.synchronize()
            ts.append(t0.elapsed_time(t1) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _check_kind(cfg: ArchConfig, kind: str) -> bool:
    """Is ``kind`` a proxy this config has?  Raises on an unknown kind."""
    if kind not in ("dense", "moe", "ssm"):
        raise ValueError(f"kind must be 'dense', 'moe' or 'ssm', "
                         f"got {kind!r}")
    return not ((kind == "moe" and cfg.moe is None)
                or (kind == "ssm" and cfg.ssm is None))


def _vjp(block: Callable, p: dict, x: torch.Tensor, ct: torch.Tensor,
         wrt_params: bool) -> tuple:
    """The block's forward and its vjp at ``ct``: the cotangents of ``x``
    and, with ``wrt_params``, of every parameter (the full vjp); without,
    the parameters are constants and no dL/dw product runs."""
    p = {k: v.detach().requires_grad_(wrt_params) for k, v in p.items()}
    x = x.detach().requires_grad_(True)
    leaves = [x] + (list(p.values()) if wrt_params else [])
    return torch.autograd.grad(block(p, x), leaves, ct)


def measure_w_frac(cfg: ArchConfig, seq: int = 128, iters: int = 5,
                   kind: str = "dense", device="cuda") -> float | None:
    """Measure the backward's B/W split from real vjp timings on ONE
    representative layer of ``cfg`` (reduced dims) on ``device``: a
    transformer-block proxy with the config's projection GEMMs plus a
    softmax-attention term (work with no weight gradient), closed by
    the FFN of the requested ``kind`` — the dense up/down GEMMs, or
    (``kind="moe"``) a router GEMM plus the config's shared + top-k
    expert GEMMs run under dense routing with top-k gate masking (every
    expert executes, gates zero the unpicked ones — the static-shape
    timing proxy for token dropping-free MoE).  ``kind="ssm"`` swaps
    the attention for the state-space mixer: in/out projection GEMMs
    around a gated linear recurrence run as an associative scan — the
    scan combine holds no parameters, so like the softmax span work its
    vjp has no dL/dw and only the projections contribute to the W half.
    The full vjp computes both cotangents; the input-only vjp
    (parameters held constant) skips every dL/dw GEMM — the timing
    excess is the weight-gradient share.

    Returns ``w_frac`` in (0, 1), or ``None`` when the ratio is
    degenerate (noise pushes it out of (0.02, 0.98)) or the config lacks
    the kind (``kind="moe"`` without an MoE config, ``kind="ssm"``
    without an SSM config) — callers fall back to the per-layer analytic
    split.  A failure to run on ``device`` raises."""
    if not _check_kind(cfg, kind):
        return None
    p0, x, ct, block = _block_proxy(cfg, seq, kind, device=device)
    t_full = measure_layer(_vjp, block, p0, x, ct, True, iters=iters,
                           device=device)
    t_x = measure_layer(_vjp, block, p0, x, ct, False, iters=iters,
                        device=device)
    if t_full <= 0:
        return None
    wf = (t_full - t_x) / t_full
    if not 0.02 < wf < 0.98:
        return None
    return wf


def _scan(a: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + xi_t`` along axis 0 as a Hillis-Steele
    associative scan over the (decay, state) monoid
    ``(l, r) -> (l0 * r0, r0 * l1 + r1)``: log2(T) whole-tensor steps."""
    A, H = a, xi
    d = 1
    while d < A.shape[0]:
        A, H = (torch.cat([A[:d], A[:-d] * A[d:]]),
                torch.cat([H[:d], A[d:] * H[:-d] + H[d:]]))
        d *= 2
    return H


def _block_proxy(cfg: ArchConfig, seq: int, kind: str, device="cuda"):
    """Build the reduced transformer-block proxy of ``kind`` (the layer
    :func:`measure_w_frac` documents) on ``device`` and return
    ``(params, x, cotangent, block_fn)`` — shared by the W-split and
    per-stage live timers.  ``block_fn(params, x)`` is plain torch, so
    it runs on whatever device its inputs are on; the random inputs come
    from a ``torch.Generator`` seeded 0."""
    dev = _device(device)
    d = max(32, min(cfg.d_model, 256))
    ff = max(2 * d, min(cfg.d_ff or 4 * d, 4 * d))
    seq = max(8, min(seq, 256))
    gen = torch.Generator().manual_seed(0)
    scale = 1.0 / math.sqrt(d)
    rand = lambda *shape: (torch.randn(*shape, generator=gen)
                           * scale).to(dev)
    if kind == "ssm":
        s_ = cfg.ssm
        di = max(d, min(s_.expand * d, 2 * d))
        p0 = {"w_in": rand(d, 3 * di), "w_out": rand(di, d)}

        def mix(p, x):
            xi, a_raw, z = torch.chunk(x @ p["w_in"], 3, dim=-1)
            a = torch.sigmoid(a_raw)       # decay in (0, 1)
            return (_scan(a, xi) * F.silu(z)) @ p["w_out"]
    else:
        p0 = {"wq": rand(d, d), "wk": rand(d, d), "wv": rand(d, d),
              "wo": rand(d, d)}

        def mix(p, x):
            q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
            s = torch.softmax(q @ k.T * scale, dim=-1)
            return (s @ v) @ p["wo"]
    if kind == "moe":
        m = cfg.moe
        ne = max(2, min(4, m.n_shared + m.n_routed))
        tk = max(1, min(m.top_k, ne))
        fe = max(16, min(m.d_ff_expert, d))
        p0.update(wr=rand(d, ne), we1=rand(ne, d, fe), we2=rand(ne, fe, d))

        def ffn(p, h):
            gates = torch.softmax(h @ p["wr"], dim=-1)
            kth = torch.sort(gates, dim=-1).values[:, -tk][:, None]
            gates = torch.where(gates >= kth, gates,
                                torch.zeros_like(gates))
            y = F.silu(torch.einsum("sd,edf->esf", h, p["we1"]))
            y = torch.einsum("esf,efd->esd", y, p["we2"])
            return torch.einsum("se,esd->sd", gates, y)
    elif kind == "ssm" and not cfg.d_ff:
        # pure-Mamba blocks are mixer-only (no FFN)
        def ffn(p, h):
            return h
    else:
        p0.update(w1=rand(d, ff), w2=rand(ff, d))

        def ffn(p, h):
            return F.silu(h @ p["w1"]) @ p["w2"]

    x = (torch.randn(seq, d, generator=gen)).to(dev)

    def block(p, x):
        return ffn(p, mix(p, x))

    ct = torch.ones(seq, d, device=dev)
    return p0, x, ct, block


def measure_block_time(cfg: ArchConfig, seq: int = 64, iters: int = 3,
                       kind: str = "dense", device="cuda") -> float | None:
    """Median time of ONE full vjp (forward + both cotangents) through
    the reduced block proxy of ``kind`` on ``device`` — the live-timing
    primitive behind :func:`measure_stage_times`.  Returns ``None`` when
    the config lacks ``kind`` (callers fall back to the analytic cost
    vector); a failure to run on ``device`` raises."""
    if not _check_kind(cfg, kind):
        return None
    p0, x, ct, block = _block_proxy(cfg, seq, kind, device=device)
    t = measure_layer(_vjp, block, p0, x, ct, True, iters=iters,
                      device=device)
    return t if t > 0 else None


def stage_layer_kinds(cfg: ArchConfig, plan) -> list[list[str]]:
    """Per-stage list of the timing kinds of the REAL layers each stage
    owns under ``plan`` (a :class:`~repro_torch.pipeline.stage.StagePlan` or
    anything with ``n_stages``/``virtual``/``layers_per_stage``),
    following the Megatron chunk placement (chunk ``v*S + n`` lives on
    device ``n``).  Padded slots are inactive and excluded."""
    S, V, Lc = plan.n_stages, plan.virtual, plan.layers_per_stage
    out = []
    for n in range(S):
        kinds = []
        for v in range(V):
            chunk = v * S + n
            for l in range(chunk * Lc, (chunk + 1) * Lc):
                if l < cfg.n_layers:
                    kinds.append(layer_kind(cfg, l))
        out.append(kinds)
    return out


def measure_stage_times(cfg: ArchConfig, plan, seq: int = 64,
                        iters: int = 3,
                        device="cuda") -> list[float] | None:
    """Measured per-stage step-time vector for ``plan``: time one
    reduced block proxy per DISTINCT layer kind in the trunk
    (:func:`measure_block_time`) and charge each stage the sum over the
    real layers it owns.  This is the live side of the drift monitor —
    on a shared host every stage's layers run on the same silicon, so
    one proxy timing per kind is exact up to layer-count weighting;
    on a real fleet each stage would time its own step and the vector
    arrives from the collective instead.  Returns ``None`` when any
    needed proxy timing is unavailable."""
    per_stage = stage_layer_kinds(cfg, plan)
    kinds = sorted({k for ks in per_stage for k in ks})
    t = {k: measure_block_time(cfg, seq=seq, iters=iters, kind=k,
                               device=device)
         for k in kinds}
    if any(t[k] is None for k in kinds):
        return None
    return [sum(t[k] for k in ks) for ks in per_stage]


# ---------------------------------------------------------------------------
# Drift monitoring — live step timings vs the planned cost vector.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DriftMonitor:
    """EMA of measured per-stage step timings, compared against the
    partition plan's predicted cost vector.

    Both vectors are normalised to *shares* of their own total before
    comparison, so the metric is invariant to absolute scale — a CPU
    device running 1000x slower than the modelled one shows zero drift as
    long as the stages stay in the planned ratio.  Drift is the worst
    per-stage relative share error::

        drift = max_n |m_n - p_n| / p_n      (m, p = measured/planned shares)

    ``should_replan()`` goes true once the EMA has absorbed
    ``min_samples`` updates AND drift exceeds ``threshold`` (default
    0.25: some stage is doing 25% more or less than its planned share
    of the work — the balance the partition was chosen for is gone).

    ``slowdown()`` reports the per-stage measured/planned share ratio —
    the derating vector :func:`repro_torch.core.autoplan.replan` feeds back
    into the cost model so the re-search sees the skewed fleet."""

    planned: tuple[float, ...]
    alpha: float = 0.25              # EMA weight of the newest sample
    threshold: float = 0.25
    min_samples: int = 3
    ema: Optional[list[float]] = None
    n_samples: int = 0

    def __post_init__(self):
        if len(self.planned) < 1 or any(p <= 0 for p in self.planned):
            raise ValueError(f"planned stage costs must be positive, "
                             f"got {self.planned}")

    @classmethod
    def from_plan(cls, plan, **kw) -> "DriftMonitor":
        """Build from a :class:`~repro_torch.core.partition.PartitionPlan`:
        the planned per-stage cost is F + B + W of its cost vector."""
        c = plan.cost_vector()
        planned = tuple(f + b + w for f, b, w in zip(c.F, c.B, c.W))
        return cls(planned=planned, **kw)

    def update(self, measured: Sequence[float]) -> float:
        """Fold one measured per-stage step-time vector into the EMA
        and return the current drift."""
        m = [float(x) for x in measured]
        if len(m) != len(self.planned):
            raise ValueError(f"measured vector has {len(m)} stages, "
                             f"plan has {len(self.planned)}")
        if any(x <= 0 for x in m):
            raise ValueError(f"measured stage times must be positive, "
                             f"got {m}")
        if self.ema is None:
            self.ema = m
        else:
            a = self.alpha
            self.ema = [a * x + (1.0 - a) * e
                        for x, e in zip(m, self.ema)]
        self.n_samples += 1
        return self.drift()

    def _shares(self) -> tuple[list[float], list[float]]:
        pt = sum(self.planned)
        mt = sum(self.ema)
        return ([p / pt for p in self.planned],
                [m / mt for m in self.ema])

    def drift(self) -> float:
        if self.ema is None:
            return 0.0
        p, m = self._shares()
        return max(abs(mi - pi) / pi for pi, mi in zip(p, m))

    def should_replan(self) -> bool:
        return self.n_samples >= self.min_samples \
            and self.drift() > self.threshold

    def slowdown(self) -> tuple[float, ...]:
        """Per-stage measured/planned share ratio (> 1 = that stage is
        slower than the plan assumed).  Identity vector until the first
        update."""
        if self.ema is None:
            return tuple(1.0 for _ in self.planned)
        p, m = self._shares()
        return tuple(mi / pi for pi, mi in zip(p, m))


def planned_stage_costs(cfg: ArchConfig, plan, seq: int = 4096) -> list[float]:
    """Analytic per-stage fwd+bwd cost vector under ``plan`` (trunk
    layers only, flops units) — the PLANNED side of the drift monitor.
    Device-independent: the monitor compares normalised shares, so any
    homogeneous per-flop rate cancels.  Stages that own no real layer
    (extreme padding) are floored to a tiny positive cost."""
    prof = profile_arch(cfg, seq=seq)
    S, V, Lc = plan.n_stages, plan.virtual, plan.layers_per_stage
    out = []
    for n in range(S):
        c = 0.0
        for v in range(V):
            chunk = v * S + n
            for l in range(chunk * Lc, (chunk + 1) * Lc):
                if l < cfg.n_layers:
                    lp = prof.layers[l]
                    c += lp.flops_fwd + lp.flops_bwd
        out.append(c)
    floor = 1e-6 * max(out) if max(out) > 0 else 1.0
    return [max(c, floor) for c in out]
