"""The photometric factor's prep on the card: one CUDA kernel for the warp,
the target sampling and the K-rows of every edge.

``photo_prep_edges`` launches ``photo_prep_points`` (csrc/photo_prep.cu,
whose note has the design and its bound) and returns what
ops/photometric.photo_prep returns, the five inputs of K1 in K1's layouts:
fgs [E, L, 3C, N], f0_cm [E, L, C, N], gate [E, N], kx and ky [E, 13+CS, N].
The kernel's code width W (the register array of a point's code basis) is
a template parameter, built at 16 and 32; ``code_width`` picks the smaller
that holds CS, and each launch adds W to the ``utils/timing`` count
``photo.prep_cs`` of the span open around it.
It takes the window's tensors whole and the edge indices, and samples the
target frames from ``pixel_table``'s point-major rows, the window's
``tables.pixel_fg`` (ops/photometric.FrameTables, built once a keyframe
by Mapper.frame_tables, or once a problem by solver.ba.prepare_problem).

Dispatch (``uses_kernel``): CUDA tensors launch the kernel, which raises on
inputs it cannot take (the checks are ``check_inputs``, plain Python); CPU
tensors take ops/photometric.photo_prep. An input on the card that carries
an autograd graph raises: the kernel has no backward, and training
differentiates through photometric.photo_prep directly.
``photo_prep_edges.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..geometry.camera import CameraPyramid
from ..utils import timing
from .photo_reduce import MAX_DIM, MAX_LEVELS  # K1's limits (csrc/photo_prep.cu PREP_MAX_LEVELS)

CODE_WIDTHS = (16, 32)  # the kernel's code widths (csrc/photo_prep.cu photo_prep_points<W>)
MAX_CODE = CODE_WIDTHS[-1]  # dim = 13 + CS <= MAX_DIM
MAX_EDGES = 65535  # the grid's second axis


def code_width(cs: int) -> int:
    """The code width of the kernel's instantiation for a code of ``cs``
    entries: the smallest of CODE_WIDTHS that holds it. Raises above
    MAX_CODE."""
    for width in CODE_WIDTHS:
        if cs <= width:
            return width
    raise ValueError(f"photo_prep kernel: CS={cs}, dim={13 + cs} (max {MAX_DIM})")


def row_width(c: int) -> int:
    """Floats in a pixel-table row: f1 | gx | gy | mask, padded to 16 bytes."""
    return -(-(3 * c + 1) // 4) * 4


def pixel_table(feat_pyr: torch.Tensor, grad_pyr: torch.Tensor, mask_flat: torch.Tensor,
                cam_pyr: CameraPyramid) -> torch.Tensor:
    """The target-sampling table of the kernel -> [K, T, row_width(C)]:
    per pyramid pixel its C features, the 2C gradients (x channels, then
    y), the full-resolution mask (level-0 pixels only, zero elsewhere) and
    zeros. The rows of photometric.build_photo_tables' quad tables before packing, in
    point-major order. feat_pyr [C, K, T] or [C, K*T], grad_pyr likewise
    with a leading 2, mask_flat [HW]."""
    c = feat_pyr.shape[0]
    t = cam_pyr.total_pixels
    k = feat_pyr.numel() // (c * t)
    out = feat_pyr.new_zeros((k, t, row_width(c)))
    out[:, :, :c] = feat_pyr.reshape(c, k, t).permute(1, 2, 0)
    out[:, :, c : 3 * c] = grad_pyr.reshape(2 * c, k, t).permute(1, 2, 0)
    out[:, : cam_pyr[0].num_pixels, 3 * c] = mask_flat
    return out


def uses_kernel(*tensors) -> bool:
    """Whether photo_prep runs as the kernel: on CUDA tensors (None entries
    are skipped). Raises on tensors on the card that carry an autograd
    graph."""
    ts = [t for t in tensors if t is not None]
    if not _on_card(ts[0]):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError("photo_prep kernel: an input carries an autograd graph; the kernel has "
                         "no backward (differentiate through photometric.photo_prep)")
    return True


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def check_inputs(rot, trans, code, scale, i0, i1, window, cam_pyr: CameraPyramid):
    """Raise on inputs the kernel cannot take -> (E, K, N, C, CS, L).
    window is a solver.ba.WindowData whose tables carry pixel_fg."""
    w = window
    tables = w.tables
    src, pixel = w.src_feats, None if tables is None else tables.pixel_fg
    if pixel is None:
        raise ValueError("photo_prep kernel: the window has no pixel_fg "
                         "(solver.ba.prepare_problem builds it)")
    bias_at, jac_at = tables.bias_at, tables.jac_at
    floats = {"rot": rot, "trans": trans, "code": code, "scale": scale, "homo": w.homo,
              "bias_flat": w.bias_flat, "jac_flat": w.jac_flat, "src_feats": src,
              "pixel_fg": pixel, "bias_at": bias_at, "jac_at": jac_at}
    ints = {"i0": i0, "i1": i1, "loc1d": w.loc1d}
    for name, t in floats.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"photo_prep kernel: {name} is {t.dtype}, expected float32")
    for name, t in ints.items():
        if t.dtype != torch.int64:
            raise TypeError(f"photo_prep kernel: {name} is {t.dtype}, expected int64")
    if src.dim() != 4 or code.dim() != 2:
        raise ValueError("photo_prep kernel: expected src_feats [K, L, N, C] and code [K, CS]")
    k, lv, n, c = src.shape
    cs = code.shape[1]
    if lv > MAX_LEVELS:
        raise ValueError(f"photo_prep kernel: L={lv} (max {MAX_LEVELS})")
    code_width(cs)
    if c % 4:
        raise ValueError(f"photo_prep kernel: C={c} is not a multiple of 4")
    e = i0.shape[0]
    hw = cam_pyr[0].num_pixels
    want = {"rot": (k, 3, 3), "trans": (k, 3), "code": (k, cs), "scale": (k,), "i0": (e,),
            "i1": (e,), "homo": (k, n, 3), "loc1d": (k, n), "bias_flat": (k, hw),
            "jac_flat": (k, hw, cs), "pixel_fg": (k, cam_pyr.total_pixels, row_width(c))}
    if (bias_at is None) != (jac_at is None):
        raise ValueError("photo_prep kernel: bias_at and jac_at are given together or not at all")
    if bias_at is not None:
        want.update(bias_at=(k, n), jac_at=(k, n, cs))
    tensors = {**floats, **ints}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"photo_prep kernel: {name} is {tuple(tensors[name].shape)}, "
                             f"expected {shape}")
    if lv != cam_pyr.levels:
        raise ValueError(f"photo_prep kernel: src_feats has {lv} levels, the pyramid {cam_pyr.levels}")
    if not 1 <= e <= MAX_EDGES or n < 1:
        raise ValueError(f"photo_prep kernel: E={e} (1 to {MAX_EDGES}), N={n} (at least 1)")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != scale.device:
            raise ValueError(f"photo_prep kernel: {name} on {t.device}, scale on {scale.device}")
        if not t.is_contiguous():
            raise ValueError(f"photo_prep kernel: {name} is not contiguous")
    for name in ("src_feats", "pixel_fg"):  # read with 16-byte loads
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"photo_prep kernel: {name} does not start on a 16-byte boundary")
    return e, k, n, c, cs, lv


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with the prep's C signature declared."""
    from .._build import load_library

    lib = load_library("photometric")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.photo_prep_launch.argtypes = [ptr] * 19 + [i32] * 10 + [ptr] * 4
    lib.photo_prep_launch.restype = i32
    lib.photo_prep_error_string.argtypes = [i32]
    lib.photo_prep_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _host_params(cam_pyr: CameraPyramid, eps: float):
    """The launch's host arrays: camera (fx, fy, cx, cy, eps), per level
    (width, height, first pixel) and (rx, ry)."""
    cam0 = cam_pyr[0]
    cam = (ctypes.c_float * 5)(cam0.fx, cam0.fy, cam0.cx, cam0.cy, eps)
    levels = (ctypes.c_int * (3 * cam_pyr.levels))(*[
        x for lvl, cam_l in enumerate(cam_pyr.cameras)
        for x in (cam_l.width, cam_l.height, cam_pyr.level_offsets[lvl])])
    ratios = (ctypes.c_float * (2 * cam_pyr.levels))(*[
        r for cam_l in cam_pyr.cameras for r in (cam_l.fx / cam0.fx, cam_l.fy / cam0.fy)])
    return cam, levels, ratios


def _launch(rot, trans, code, scale, i0, i1, window, cam_pyr, eps, soft):
    """One launch on CUDA inputs, checked first -> (fgs, f0_cm, gate, kx, ky)."""
    dev = scale.device
    if dev.index != torch.cuda.current_device():  # the C launcher uses the current card
        with torch.cuda.device(dev):
            return _launch(rot, trans, code, scale, i0, i1, window, cam_pyr, eps, soft)
    e, _, n, c, cs, lv = check_inputs(rot, trans, code, scale, i0, i1, window, cam_pyr)
    dim = 13 + cs
    width = code_width(cs)
    fgs = torch.empty((e, lv, 3 * c, n), dtype=torch.float32, device=dev)
    f0 = torch.empty((e, lv, c, n), dtype=torch.float32, device=dev)
    gate = torch.empty((e, n), dtype=torch.float32, device=dev)
    kx = torch.empty((e, dim, n), dtype=torch.float32, device=dev)
    ky = torch.empty((e, dim, n), dtype=torch.float32, device=dev)
    w, tables = window, window.tables
    pixel = tables.pixel_fg
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _library()
    status = lib.photo_prep_launch(
        rot.data_ptr(), trans.data_ptr(), code.data_ptr(), scale.data_ptr(), i0.data_ptr(),
        i1.data_ptr(), w.homo.data_ptr(), ptr(tables.bias_at), ptr(tables.jac_at),
        w.loc1d.data_ptr(), w.bias_flat.data_ptr(), w.jac_flat.data_ptr(), w.src_feats.data_ptr(), pixel.data_ptr(),
        fgs.data_ptr(), f0.data_ptr(), gate.data_ptr(), kx.data_ptr(), ky.data_ptr(),
        e, n, cam_pyr[0].num_pixels, cam_pyr.total_pixels, pixel.shape[-1], c, cs, width, lv,
        int(soft),
        *_host_params(cam_pyr, float(eps)), torch.cuda.current_stream(dev).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"photo_prep kernel launch failed: CUDA error {status} "
                           f"({lib.photo_prep_error_string(status).decode()})")
    photo_prep_edges.launches += 1
    timing.count("photo.prep_cs", width)
    return fgs, f0, gate, kx, ky


def photo_prep_edges(rot, trans, code, scale, i0, i1, window, cam_pyr: CameraPyramid,
                     eps: float, soft: bool = False):
    """The kernel's prep of edges kf[i0] -> frame[i1] -> (fgs, f0_cm, gate,
    kx, ky), from the variables (pose rot [K, 3, 3], trans [K, 3], code
    [K, CS], scale [K]) and a solver.ba.WindowData whose tables carry pixel_fg, all
    CUDA tensors."""
    return _launch(rot, trans, code, scale, i0, i1, window, cam_pyr, eps, soft)


photo_prep_edges.launches = 0
