"""The geometric factor's linearization on the card: one CUDA kernel family
for the frame-1 tables, the warp, the sampling, the rows and their Gram.

``geo_linearize_edges`` makes three launches (csrc/geo_linearize.cu, whose
note has the design and its bound) and returns what
ops/geometric.build_frame1_tables + geometric_jac_error return for a BA
window: (ata [E, D, D], atb [E, D], error [E], n_inl [E]), D = 14 + 2CS,
not yet PSD-corrected. The kernel's code width W is a template parameter,
built at 16 and 32; ``code_width`` picks the smaller that holds CS, which
must be a multiple of 4: the kernels read the code rows (jac_flat, jac_at,
16-byte aligned) as float4 and have no scalar path. Each
call launches the split kernel once and adds ``geo.kernel`` 1 and
``geo.code_width`` W to the ``utils/timing`` span open around it. It takes
the window's tensors whole and the edge indices (which must lie in
[0, K): the kernel indexes the window's rows with them, unchecked), and
decodes every keyframe's frame-1 table itself, once a call.

The split count follows the edges: ``num_splits`` gives each edge enough
blocks that the E x splits grid fills the card's resident block slots in
waves at least ``FILL`` full, so a mapper window (E = 16-48) and the full
graph (E = 372) both keep the SMs busy.

Dispatch (``uses_kernel``): CUDA tensors launch the kernels, which raise on
inputs they cannot take (the checks are ``check_inputs``, plain Python);
CPU tensors take the plain chain. An input on the card that carries an
autograd graph raises: the kernel has no backward, and training
differentiates through geometric.geometric_jac_error directly.
``geo_linearize_edges.launches`` counts calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..geometry.camera import PinholeCamera
from ..utils import timing

CODE_WIDTHS = (16, 32)  # the kernel's code widths (csrc/geo_linearize.cu geo_split_points<W>)
MAX_CODE = CODE_WIDTHS[-1]
MAX_EDGES = 65535  # the grid's second axis
TILE_POINTS = 128  # points of a split block's tile (csrc/geo_linearize.cu GEO_THREADS)
FILL = 0.9  # the least share of the grid's last wave num_splits accepts


def code_width(cs: int) -> int:
    """The code width of the kernel's instantiation for a code of ``cs``
    entries: the smallest of CODE_WIDTHS that holds it. Raises above
    MAX_CODE."""
    for width in CODE_WIDTHS:
        if cs <= width:
            return width
    raise ValueError(f"geo_linearize kernel: CS={cs}, dim={14 + 2 * cs} (max CS {MAX_CODE})")


def num_splits(n: int, e: int, slots: int) -> int:
    """Blocks per edge: the fewest whose E x splits grid fills its last wave
    of ``slots`` resident blocks at least FILL full, else the fullest; at
    most one a TILE_POINTS points."""
    best, best_fill = 1, 0.0
    for splits in range(1, max(1, n // TILE_POINTS) + 1):
        blocks = e * splits
        fill = blocks / (-(-blocks // slots) * slots)
        if fill >= FILL:
            return splits
        if fill > best_fill:
            best, best_fill = splits, fill
    return best


def uses_kernel(*tensors) -> bool:
    """Whether the linearization runs as the kernels: on CUDA tensors (None
    entries are skipped). Raises on tensors on the card that carry an
    autograd graph."""
    ts = [t for t in tensors if t is not None]
    if not _on_card(ts[0]):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError("geo_linearize kernel: an input carries an autograd graph; the kernel has "
                         "no backward (differentiate through geometric.geometric_jac_error)")
    return True


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def check_inputs(rot, trans, code, scale, i0, i1, window, cam: PinholeCamera):
    """Raise on inputs the kernel cannot take -> (E, K, N, HW, CS). window
    is a solver.ba.WindowData; its decode tables (tables.bias_at, jac_at)
    are read where present, else loc1d into bias_flat and jac_flat."""
    w = window
    tables = w.tables
    bias_at, jac_at = (None, None) if tables is None else (tables.bias_at, tables.jac_at)
    floats = {"rot": rot, "trans": trans, "code": code, "scale": scale, "homo": w.homo,
              "bias_flat": w.bias_flat, "jac_flat": w.jac_flat, "mask_flat": w.mask_flat,
              "avg_sq_bias": w.avg_sq_bias, "bias_at": bias_at, "jac_at": jac_at}
    ints = {"i0": i0, "i1": i1, "loc1d": w.loc1d}
    for name, t in floats.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"geo_linearize kernel: {name} is {t.dtype}, expected float32")
    for name, t in ints.items():
        if t.dtype != torch.int64:
            raise TypeError(f"geo_linearize kernel: {name} is {t.dtype}, expected int64")
    if w.homo.dim() != 3 or code.dim() != 2:
        raise ValueError("geo_linearize kernel: expected homo [K, N, 3] and code [K, CS]")
    k, n = w.homo.shape[:2]
    cs = code.shape[1]
    code_width(cs)
    if cs % 4:
        raise ValueError(f"geo_linearize kernel: CS={cs} is not a multiple of 4 (the code rows "
                         "are read as float4)")
    e = i0.shape[0]
    hw = cam.width * cam.height
    want = {"rot": (k, 3, 3), "trans": (k, 3), "code": (k, cs), "scale": (k,), "i0": (e,),
            "i1": (e,), "homo": (k, n, 3), "loc1d": (k, n), "bias_flat": (k, hw),
            "jac_flat": (k, hw, cs), "mask_flat": (hw,), "avg_sq_bias": (k,)}
    if (bias_at is None) != (jac_at is None):
        raise ValueError("geo_linearize kernel: bias_at and jac_at are given together or not at all")
    if bias_at is not None:
        want.update(bias_at=(k, n), jac_at=(k, n, cs))
    tensors = {**floats, **ints}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"geo_linearize kernel: {name} is {tuple(tensors[name].shape)}, "
                             f"expected {shape}")
    if not 1 <= e <= MAX_EDGES or n < 1 or cs < 1:
        raise ValueError(f"geo_linearize kernel: E={e} (1 to {MAX_EDGES}), N={n}, CS={cs} "
                         "(at least 1)")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != scale.device:
            raise ValueError(f"geo_linearize kernel: {name} on {t.device}, scale on {scale.device}")
        if not t.is_contiguous():
            raise ValueError(f"geo_linearize kernel: {name} is not contiguous")
    for name in ("jac_flat", "jac_at"):
        if tensors[name] is not None and tensors[name].data_ptr() % 16:
            raise ValueError(f"geo_linearize kernel: {name} does not start on a 16-byte boundary")
    return e, k, n, hw, cs


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from .._build import load_library

    lib = load_library("geometric")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.geo_linearize_launch.argtypes = [ptr] * 20 + [i32] * 9 + [ptr] * 2
    lib.geo_linearize_launch.restype = i32
    lib.geo_linearize_slots.argtypes = [i32]
    lib.geo_linearize_slots.restype = i32
    lib.geo_linearize_pad.argtypes = [i32]
    lib.geo_linearize_pad.restype = i32
    lib.geo_linearize_error_string.argtypes = [i32]
    lib.geo_linearize_error_string.restype = ctypes.c_char_p
    return lib


def _raise_cuda(what: str, status: int):
    raise RuntimeError(f"geo_linearize kernel {what} failed: CUDA error {status} "
                       f"({_library().geo_linearize_error_string(status).decode()})")


@functools.cache
def _slots(device_index: int, width: int) -> int:
    """Resident block slots of the width-W split kernel on one card (blocks
    per SM x SMs)."""
    with torch.cuda.device(device_index):
        slots = _library().geo_linearize_slots(width)
    if slots <= 0:
        _raise_cuda("occupancy query", -slots)
    return slots


@functools.cache
def _host_params(fx: float, fy: float, cx: float, cy: float, eps: float, loss_factor: float,
                 weight: float):
    """The launch's host array: camera, eps, the robust loss's factor, the
    factor weight and its error without inliers (w * 10, in double first,
    as the plain chain's Python product)."""
    return (ctypes.c_float * 8)(fx, fy, cx, cy, eps, loss_factor, weight, weight * 10.0)


def geo_linearize_edges(rot, trans, code, scale, i0, i1, window, cam: PinholeCamera,
                        loss_factor: float, weight: float, eps: float):
    """The kernels' linearization of edges kf[i0] -> kf[i1] -> (ata
    [E, D, D], atb [E, D], error [E], n_inl [E]), from the variables (pose
    rot [K, 3, 3], trans [K, 3], code [K, CS], scale [K]) and a
    solver.ba.WindowData, all CUDA tensors; the robust loss's scale is
    ``loss_factor * window.avg_sq_bias[i0]``, ``weight`` the factor's."""
    dev = scale.device
    if dev.index != torch.cuda.current_device():  # the C launcher uses the current card
        with torch.cuda.device(dev):
            return geo_linearize_edges(rot, trans, code, scale, i0, i1, window, cam,
                                       loss_factor, weight, eps)
    e, k, n, hw, cs = check_inputs(rot, trans, code, scale, i0, i1, window, cam)
    width = code_width(cs)
    dim = 14 + 2 * cs
    lib = _library()
    splits = num_splits(n, e, _slots(dev.index, width))
    pad = lib.geo_linearize_pad(width)
    # one buffer: the frame-1 table [K, HW, 4], the splits' partials, then
    # the outputs
    sizes = (k * hw * 4, e * splits * pad * pad, e * dim * dim, e * dim, e, e)
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    table, partial, ata, atb, error, n_inl = torch.split(buf, sizes)
    w, tables = window, window.tables
    bias_at, jac_at = (None, None) if tables is None else (tables.bias_at, tables.jac_at)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    status = lib.geo_linearize_launch(
        rot.data_ptr(), trans.data_ptr(), code.data_ptr(), scale.data_ptr(), i0.data_ptr(),
        i1.data_ptr(), w.homo.data_ptr(), ptr(bias_at), ptr(jac_at), w.loc1d.data_ptr(),
        w.bias_flat.data_ptr(), w.jac_flat.data_ptr(), w.mask_flat.data_ptr(),
        w.avg_sq_bias.data_ptr(), table.data_ptr(), partial.data_ptr(), ata.data_ptr(),
        atb.data_ptr(), error.data_ptr(), n_inl.data_ptr(),
        e, k, n, hw, cam.width, cam.height, cs, width, splits,
        _host_params(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), float(eps),
                     float(loss_factor), float(weight)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if status != 0:
        _raise_cuda("launch", status)
    geo_linearize_edges.launches += 1
    timing.count("geo.kernel", 1)
    timing.count("geo.code_width", width)
    return ata.view(e, dim, dim), atb.view(e, dim), error, n_inl


geo_linearize_edges.launches = 0
