"""The photometric J^T W J reduce: a CUDA kernel and its plain version.

Replaces the TPU kernel ``photo_reduce_pallas`` (sage_slam_tpu/ops/
pallas_kernels.py:118, ``pl.pallas_call`` at :152) and computes the same
function as ``photo_reduce_xla`` (sage_slam_tpu/ops/photometric.py:617).

For each edge e and point n, summed over L levels with weight w_l and focal
ratios (rx_l, ry_l), the per-point gradient Gram gxx, gxy, gyy, the
gradient-residual products hx, hy (d = f0 - f1) and sum d^2, all scaled by
gate^2; then, over points, the un-normalised

  ata = Kx^T (gxx Kx + gxy Ky) + Ky^T (gxy Kx + gyy Ky)   [E, dim, dim]
  atb = Kx^T hx + Ky^T hy                                 [E, dim]
  err = sum gate^2 sum_l w_l sum_c d^2                    [E]
  n_inl = sum gate^2                                      [E]

The kernel (csrc/photo_reduce.cu, whose note has the details) is bound
by memory: at the window-BA bench point (E=24, L=4, C=16, N=3072, dim=29)
it must read about 93 MB (fgs 56.6 MB, f0 18.9 MB, kx+ky 17.1 MB, gate
0.3 MB), 28 us at 3.35 TB/s, against ~0.3 GFLOP of FP32 work. Producer
warps stream fgs and f0 straight into registers (16-byte loads) and reduce
them to per-point Gram terms while consumer warps contract the previous
tile (warp specialisation); the K-rows come through a 2-stage cp.async
ring. Each block walks one point range in 64-point tiles on a (splits, E)
grid that ``num_splits`` sizes to fill every resident block slot once. The
contraction is the TPU kernel's padded product (atb, err and n_inl ride
padding rows of a PxP product), register-tiled (P/8)x(P/8) per thread,
upper triangle only. The padded width P is the kernel's template
parameter, built at 32 (dim <= 29: CS <= 16) and 48 (dim <= 45: CS <= 32);
``pad_for`` picks the smaller that fits. A second tiny pass sums the
splits in split order and mirrors ata: deterministic, no atomics, ata
bit-symmetric. FP32 FMA only: no TF32, no tensor cores.

The host side is kept small: one output buffer per call (the padded
[E, P, P] result, returned as views by ``unpack_padded``, followed by
the splits' partials), the split count from a cached occupancy query, one
ctypes call.

``photo_reduce`` launches the kernel for CUDA tensors (and raises if the
build or the launch fails; it never falls back) and runs
``photo_reduce_ref`` for CPU tensors. ``photo_reduce.launches`` counts
kernel launches; each launch also adds its P to the ``utils/timing`` count
``photo.k1_pad`` of the span open around it.

Training differentiates through the reduce. On CUDA tensors that carry a
graph the launch goes through ``PhotoReduceFn``, whose backward is written
in closed form (``photo_reduce_backward``: one batched S [Kx | Ky] product
and elementwise passes over levels and channels, torch ops on the card;
the TPU side has none, XLA differentiates photo_reduce_xla there).
``photo_reduce.backward_calls`` counts its calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import timing

MAX_LEVELS = 8  # the kernel's per-level coefficient arrays
PADS = (32, 48)  # the kernel's padded product widths (csrc/photo_reduce.cu Pad<P>)
MAX_DIM = PADS[-1] - 3  # dim = 13 + CS, plus the atb / err / n_inl rows
TILE_POINTS = 64  # points per tile (csrc/photo_reduce.cu TN)


def pad_for(dim: int) -> int:
    """The padded width of the kernel's instantiation for a block of
    ``dim`` variables: the smallest of PADS with room for dim and the three
    padding rows. Raises above MAX_DIM."""
    for pad in PADS:
        if dim + 3 <= pad:
            return pad
    raise ValueError(f"photo_reduce kernel: dim={dim} (max {MAX_DIM})")


def photo_reduce_ref(fgs, f0_cm, gate, kx, ky, weights, ratios):
    """Plain PyTorch reduce, a line-for-line port of photo_reduce_xla
    batched over E -> un-normalised (ata [E, dim, dim], atb [E, dim],
    err [E], n_inl [E]). Level weights that are tensors stay in the graph."""
    c = f0_cm.shape[-2]
    gate2 = gate * gate
    zero = torch.zeros_like(gate)
    gxx = gxy = gyy = hx = hy = zero
    err_total = torch.zeros_like(gate[:, 0])
    for lvl in range(fgs.shape[1]):
        fg = fgs[:, lvl]  # [E, 3C, N]
        f1 = fg[:, :c]
        gx = fg[:, c : 2 * c]
        gy = fg[:, 2 * c :]
        d = f0_cm[:, lvl] - f1
        wl = weights[lvl]
        wl = wl if isinstance(wl, torch.Tensor) else float(wl)
        rx, ry = ratios[lvl]
        gxx = gxx + (wl * rx * rx) * torch.sum(gx * gx, dim=1)
        gxy = gxy + (wl * rx * ry) * torch.sum(gx * gy, dim=1)
        gyy = gyy + (wl * ry * ry) * torch.sum(gy * gy, dim=1)
        hx = hx + (wl * rx) * torch.sum(gx * d, dim=1)
        hy = hy + (wl * ry) * torch.sum(gy * d, dim=1)
        err_total = err_total + wl * torch.sum(gate2 * torch.sum(d * d, dim=1), dim=-1)
    n_inl = torch.sum(gate2, dim=-1)
    gxx, gxy, gyy = gate2 * gxx, gate2 * gxy, gate2 * gyy
    hx, hy = gate2 * hx, gate2 * hy
    kgx = gxx[:, None] * kx + gxy[:, None] * ky  # [E, dim, N]
    kgy = gxy[:, None] * kx + gyy[:, None] * ky
    ata = kx @ kgx.transpose(-1, -2) + ky @ kgy.transpose(-1, -2)
    atb = (kx @ hx[..., None])[..., 0] + (ky @ hy[..., None])[..., 0]
    return ata, atb, err_total, n_inl


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from .._build import load_library

    lib = load_library("photometric")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.photo_reduce_launch.argtypes = [ptr] * 7 + [i32] * 7 + [
        ctypes.POINTER(ctypes.c_float), ptr,
    ]
    lib.photo_reduce_launch.restype = i32
    lib.photo_reduce_slots.argtypes = [i32]
    lib.photo_reduce_slots.restype = i32
    lib.photo_reduce_error_string.argtypes = [i32]
    lib.photo_reduce_error_string.restype = ctypes.c_char_p
    return lib


def _raise_cuda(what: str, status: int):
    lib = _library()
    raise RuntimeError(
        f"photo_reduce kernel {what} failed: CUDA error {status} "
        f"({lib.photo_reduce_error_string(status).decode()})"
    )


@functools.cache
def _slots(device_index: int, pad: int) -> int:
    """Resident block slots of the pad-wide kernel on one card (blocks per
    SM x SMs)."""
    with torch.cuda.device(device_index):
        slots = _library().photo_reduce_slots(pad)
    if slots <= 0:
        _raise_cuda("occupancy query", -slots)
    return slots


def num_splits(n: int, e: int, slots: int) -> int:
    """Blocks per edge: enough that the E x splits grid fills the resident
    block slots once, with at least TILE_POINTS points per split."""
    return max(1, min(n // TILE_POINTS, slots // e))


def split_ranges(n: int, splits: int) -> list:
    """The point ranges [start, stop) of an edge's splits, cut as the
    kernel cuts them (split_start): equal to 4 points, starts 4-aligned."""
    starts = [(s * n // splits) & ~3 for s in range(splits)] + [n]
    return list(zip(starts[:-1], starts[1:]))


def unpack_padded(out, dim: int):
    """Views of the padded product [E, P, P] (the TPU kernel's layout):
    (ata [E, dim, dim], atb [E, dim], err [E], n_inl [E])."""
    return out[:, :dim, :dim], out[:, :dim, dim], out[:, dim + 1, dim + 1], out[:, dim + 1, dim + 2]


def _check_inputs(fgs, f0_cm, gate, kx, ky, weights, ratios):
    tensors = {"fgs": fgs, "f0_cm": f0_cm, "gate": gate, "kx": kx, "ky": ky}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"photo_reduce: {name} is {t.dtype}, expected float32")
        if t.device != fgs.device:
            raise ValueError(f"photo_reduce: {name} on {t.device}, fgs on {fgs.device}")
    if fgs.dim() != 4 or f0_cm.dim() != 4 or gate.dim() != 2 or kx.dim() != 3:
        raise ValueError("photo_reduce: expected fgs/f0_cm 4-D, gate 2-D, kx/ky 3-D")
    e, lv, c3, n = fgs.shape
    c = c3 // 3
    dim = kx.shape[1]
    if (
        c3 != 3 * c
        or f0_cm.shape != (e, lv, c, n)
        or gate.shape != (e, n)
        or kx.shape != (e, dim, n)
        or ky.shape != kx.shape
    ):
        raise ValueError(
            "photo_reduce: shapes fgs %s f0_cm %s gate %s kx %s ky %s do not "
            "match [E,L,3C,N] [E,L,C,N] [E,N] [E,dim,N] [E,dim,N]"
            % (tuple(fgs.shape), tuple(f0_cm.shape), tuple(gate.shape),
               tuple(kx.shape), tuple(ky.shape))
        )
    if len(ratios) != lv or len(weights) < lv:
        raise ValueError(
            f"photo_reduce: {len(ratios)} ratios and {len(weights)} weights "
            f"for {lv} levels (ratios: one per level; weights: at least one)"
        )
    return e, lv, c, n, dim


def _launch(fgs, f0_cm, gate, kx, ky, host_weights, ratios):
    """One K1 launch on CUDA tensors (host_weights: L floats) -> views of
    (ata, atb, err, n_inl). Raises if the shapes exceed the kernel's limits
    or the launch fails."""
    e, lv, c3, n = fgs.shape
    dim = kx.shape[1]
    if lv > MAX_LEVELS:
        raise ValueError(f"photo_reduce kernel: L={lv} (max {MAX_LEVELS})")
    pad = pad_for(dim)
    for name, t in (("fgs", fgs), ("f0_cm", f0_cm), ("gate", gate), ("kx", kx), ("ky", ky)):
        if not t.is_contiguous():
            raise ValueError(f"photo_reduce kernel: {name} is not contiguous")
    dev = fgs.device
    if dev.index != torch.cuda.current_device():  # the C launcher uses the current card
        with torch.cuda.device(dev):
            return _launch(fgs, f0_cm, gate, kx, ky, host_weights, ratios)
    lib = _library()
    splits = num_splits(n, e, _slots(dev.index, pad))
    # one buffer: the padded result [E, pad, pad], then the splits' partials
    buf = torch.empty((e * (1 + splits), pad, pad), dtype=torch.float32, device=dev)
    host = (ctypes.c_float * (3 * lv))(
        *host_weights[:lv],
        *[float(r[0]) for r in ratios],
        *[float(r[1]) for r in ratios],
    )
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.photo_reduce_launch(
        fgs.data_ptr(), f0_cm.data_ptr(), gate.data_ptr(), kx.data_ptr(), ky.data_ptr(),
        buf.data_ptr() + 4 * e * pad * pad, buf.data_ptr(), e, lv, c3 // 3, n, dim, pad, splits,
        host, stream,
    )
    if status != 0:
        _raise_cuda("launch", status)
    photo_reduce.launches += 1
    timing.count("photo.k1_pad", pad)
    return unpack_padded(buf[:e], dim)


def _host_weights(weights, lv: int):
    """The first lv level weights as host floats (one device read for a
    tensor)."""
    if isinstance(weights, torch.Tensor):
        return [float(w) for w in weights[:lv].detach().cpu().tolist()]
    return [float(w) for w in weights[:lv]]


def photo_reduce_backward(fgs, f0_cm, gate, kx, ky, weights, ratios,
                          g_ata, g_atb, g_err, g_n, need=(True,) * 6):
    """Closed-form cotangents of the reduce -> (d fgs, d f0_cm, d gate,
    d kx, d ky, d weights [L]); an entry is None where ``need`` says so.
    Output cotangents that are None count as zeros.

    With S = A' + A'^T (A', a', e', n' the cotangents of ata, atb, err,
    n_inl), per point:
      d kx = gxx S kx + gxy S ky + a' hx,   d ky = gxy S kx + gyy S ky + a' hy,
      d gxx = kx^T S kx / 2,  d gxy = kx^T S ky,  d gyy = ky^T S ky / 2,
      d hx = a'^T kx,  d hy = a'^T ky,
    (gxx..hy gated by gate^2), then elementwise passes over all levels and
    channels at once give fgs, f0_cm, gate^2 and the level weights. Torch
    ops on the inputs' device: one batched S [kx | ky] product."""
    e, lv, c3, n = fgs.shape
    c = c3 // 3
    dim = kx.shape[1]
    zero_e = fgs.new_zeros((e,))
    g_ata = fgs.new_zeros((e, dim, dim)) if g_ata is None else g_ata
    g_atb = fgs.new_zeros((e, dim)) if g_atb is None else g_atb
    g_err = zero_e if g_err is None else g_err
    g_n = zero_e if g_n is None else g_n
    w = weights if isinstance(weights, torch.Tensor) else torch.tensor(
        [float(x) for x in weights[:lv]], dtype=fgs.dtype, device=fgs.device)
    w = w.detach()[:lv].to(fgs.dtype)[None, :, None]  # [1, L, 1]
    rx = fgs.new_tensor([float(r[0]) for r in ratios])[None, :, None]
    ry = fgs.new_tensor([float(r[1]) for r in ratios])[None, :, None]
    gate2 = gate * gate

    # per-level channel sums [E, L, N] of the gradient Gram, gradient x
    # residual and residual energy; their weighted level sums (ungated)
    fg = fgs.view(e, lv, 3, c, n)
    gx, gy = fg[:, :, 1], fg[:, :, 2]
    d = f0_cm - fg[:, :, 0]
    sxx, sxy, syy = (gx * gx).sum(2), (gx * gy).sum(2), (gy * gy).sum(2)
    sxd, syd, sdd = (gx * d).sum(2), (gy * d).sum(2), (d * d).sum(2)
    gxx = (w * rx * rx * sxx).sum(1)
    gxy = (w * rx * ry * sxy).sum(1)
    gyy = (w * ry * ry * syy).sum(1)
    hx = (w * rx * sxd).sum(1)
    hy = (w * ry * syd).sum(1)

    s = g_ata + g_ata.transpose(-1, -2)
    sk = s @ torch.cat([kx, ky], dim=-1)  # [E, dim, 2N]
    skx, sky = sk[..., :n], sk[..., n:]
    a = g_atb[..., None]
    d_gxx = 0.5 * torch.sum(kx * skx, dim=1)  # cotangents of the gated terms
    d_gxy = torch.sum(kx * sky, dim=1)
    d_gyy = 0.5 * torch.sum(ky * sky, dim=1)
    d_hx = torch.sum(a * kx, dim=1)
    d_hy = torch.sum(a * ky, dim=1)

    d_kx = d_ky = d_gate = d_fgs = d_f0 = d_w = None
    if need[3]:
        d_kx = (gate2 * gxx)[:, None] * skx + (gate2 * gxy)[:, None] * sky + a * (gate2 * hx)[:, None]
    if need[4]:
        d_ky = (gate2 * gxy)[:, None] * skx + (gate2 * gyy)[:, None] * sky + a * (gate2 * hy)[:, None]
    if need[2]:
        dd = (w * sdd).sum(1)
        d_g2 = (gxx * d_gxx + gxy * d_gxy + gyy * d_gyy + hx * d_hx + hy * d_hy
                + g_err[:, None] * dd + g_n[:, None])
        d_gate = 2.0 * gate * d_g2
    # cotangents [E, 1, N] of the ungated per-level terms
    r_xx, r_xy, r_yy = (gate2 * d_gxx)[:, None], (gate2 * d_gxy)[:, None], (gate2 * d_gyy)[:, None]
    r_hx, r_hy = (gate2 * d_hx)[:, None], (gate2 * d_hy)[:, None]
    r_dd = (gate2 * g_err[:, None])[:, None]
    if need[0] or need[1]:
        lvl_d = lambda t: t[:, :, None]  # noqa: E731  [E, L, N] -> [E, L, 1, N]
        d_d = lvl_d(w * rx * r_hx) * gx + lvl_d(w * ry * r_hy) * gy + lvl_d(2.0 * w * r_dd) * d
        if need[1]:
            d_f0 = d_d
        if need[0]:
            d_gx = lvl_d(w * rx * 2.0 * rx * r_xx) * gx + lvl_d(w * rx * ry * r_xy) * gy + lvl_d(w * rx * r_hx) * d
            d_gy = lvl_d(w * ry * rx * r_xy) * gx + lvl_d(w * ry * 2.0 * ry * r_yy) * gy + lvl_d(w * ry * r_hy) * d
            d_fgs = torch.stack([-d_d, d_gx, d_gy], dim=2).reshape(e, lv, c3, n)
    if need[5]:
        d_w = (rx * rx * r_xx * sxx + rx * ry * r_xy * sxy + ry * ry * r_yy * syy
               + rx * r_hx * sxd + ry * r_hy * syd + r_dd * sdd).sum((0, 2))
    return d_fgs, d_f0, d_gate, d_kx, d_ky, d_w


class PhotoReduceFn(torch.autograd.Function):
    """The reduce with its closed-form backward (photo_reduce_backward).
    The forward launches K1 on CUDA tensors and runs photo_reduce_ref
    (without a graph) on CPU tensors, so the backward can be held against
    autograd through the plain version on the CPU. ``weights`` may be a
    tensor [L] (its cotangent is returned) or a sequence of floats; the
    kernel takes ``host_weights`` (floats, read from ``weights`` when
    None). ``ratios`` are static."""

    @staticmethod
    def forward(ctx, fgs, f0_cm, gate, kx, ky, weights, ratios, host_weights=None):
        if fgs.device.type == "cuda":
            hw = host_weights if host_weights is not None else _host_weights(weights, fgs.shape[1])
            out = _launch(fgs, f0_cm, gate, kx, ky, hw, ratios)
            out = tuple(t.clone() for t in out)  # own storage, not views of one buffer
        else:
            out = photo_reduce_ref(fgs, f0_cm, gate, kx, ky, weights, ratios)
        ctx.ratios = ratios
        ctx.weights_is_tensor = isinstance(weights, torch.Tensor)
        ctx.weights = None if ctx.weights_is_tensor else weights
        ctx.save_for_backward(fgs, f0_cm, gate, kx, ky,
                              weights if ctx.weights_is_tensor else None)
        return out

    @staticmethod
    def backward(ctx, g_ata, g_atb, g_err, g_n):
        fgs, f0_cm, gate, kx, ky, w_t = ctx.saved_tensors
        weights = w_t if ctx.weights_is_tensor else ctx.weights
        need = tuple(ctx.needs_input_grad[:6])
        grads = photo_reduce_backward(fgs, f0_cm, gate, kx, ky, weights, ctx.ratios,
                                      g_ata, g_atb, g_err, g_n, need)
        photo_reduce.backward_calls += 1
        d_w = grads[5]
        if d_w is not None and w_t is not None and w_t.shape[0] > d_w.shape[0]:
            d_w = torch.cat([d_w, d_w.new_zeros(w_t.shape[0] - d_w.shape[0])])
        return (*grads[:5], d_w, None, None)


def photo_reduce(fgs, f0_cm, gate, kx, ky, weights, ratios, host_weights=None):
    """Fused photometric reduce over all edges -> un-normalised
    (ata [E, dim, dim], atb [E, dim], err [E], n_inl [E]).

    fgs [E, L, 3C, N] target samples (rows f1 | gx | gy), f0_cm
    [E, L, C, N] source features, gate [E, N], kx, ky [E, dim, N] K-rows,
    all float32; weights: per-level weights, a sequence of floats (a config
    tuple may be longer than L) or a tensor that may carry a graph;
    ratios: one (rx, ry) per level; host_weights: the weights as floats,
    so that the kernel's launch reads nothing from the card.

    CUDA tensors go to the kernel: inside a graph through PhotoReduceFn,
    whose backward is closed form, else straight to the launch. CPU tensors
    go to photo_reduce_ref, under autograd."""
    _check_inputs(fgs, f0_cm, gate, kx, ky, weights, ratios)
    if fgs.device.type == "cpu":
        return photo_reduce_ref(fgs, f0_cm, gate, kx, ky, weights, ratios)
    if fgs.device.type != "cuda":
        raise ValueError(f"photo_reduce: unsupported device {fgs.device}")
    w_graph = isinstance(weights, torch.Tensor) and weights.requires_grad
    if torch.is_grad_enabled() and (w_graph or any(
            t.requires_grad for t in (fgs, f0_cm, gate, kx, ky))):
        return PhotoReduceFn.apply(fgs, f0_cm, gate, kx, ky, weights, ratios, host_weights)
    hw = host_weights if host_weights is not None else _host_weights(weights, fgs.shape[1])
    return _launch(fgs, f0_cm, gate, kx, ky, hw, ratios)


photo_reduce.launches = 0
photo_reduce.backward_calls = 0
