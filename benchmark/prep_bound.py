"""The least time of the photometric factor's prep kernel (photo_prep),
counted from shapes, and the code width of its instantiation.

``prep_bound`` counts what the repo's ``chip_smoke.prep_bound`` counts,
taken from the step's shapes instead of its tensors: the kernel's five
outputs written once and each distinct source keyframe's rows read once.
The shapes hold neither the pyramid's pixels nor which keyframes the edges
target, so the target frames' pixel tables, which chip_smoke also counts
(90 MB of 1.60 GB at the full-graph cell's CS = 16 shapes), are left out:
the bound is lower than chip_smoke's by that much, and a share of it never
reads above the kernel's true share.
"""

from __future__ import annotations

import re

CODE_WIDTHS = (16, 32)  # the kernel's instantiations, photo_prep_points<W>
_NAME = re.compile(r"photo_prep_points<(\d+)>")


def code_width(cs: int):
    """The code width W of the instantiation the program launches for a
    code of ``cs`` entries (the smallest that holds it), or None."""
    return next((w for w in CODE_WIDTHS if cs <= w), None)


def instantiation(kernel_name: str):
    """W of a traced ``photo_prep_points<W>`` kernel name, or None for a
    name without it."""
    m = _NAME.search(kernel_name)
    return int(m.group(1)) if m else None


def prep_bound(e: int, levels: int, c: int, n: int, cs: int, sources: int, peak_bw: float):
    """The prep's least time for E edges, L levels, C feature channels, N
    points, a code of CS entries and ``sources`` distinct source keyframes:
    its outputs (fgs [E, L, 3C, N], f0 [E, L, C, N], gate [E, N], kx and ky
    [E, 13+CS, N], float32) written once and each source keyframe's rows
    (homo [N, 3], the decode's bias [N] and basis [N, CS], the source
    features [L, N, C]) read once, at the memory rate -> (bound_ms, bytes)."""
    dim = 13 + cs
    out_bytes = 4 * e * n * (levels * 3 * c + levels * c + 1 + 2 * dim)
    src_bytes = 4 * sources * n * (3 + 1 + cs + levels * c)
    nbytes = out_bytes + src_bytes
    return nbytes / peak_bw * 1e3, nbytes
