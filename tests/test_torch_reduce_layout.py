"""The host-side layout of the CUDA photometric reduce, on the CPU.

The kernel writes the TPU kernel's padded product [E, P, P] (P = 32 up
to dim 29, 48 up to dim 45; atb in column dim, err at [dim+1, dim+1],
n_inl at [dim+1, dim+2]) and the
wrapper returns views of it (``unpack_padded``); its grid walks the point
tiles of each edge in ``num_splits`` runs (``split_ranges``). Here the
padded product is built with plain torch exactly as the Pallas kernel
lays it out, unpacked with the wrapper's function and held against
``photo_reduce_ref`` and JAX ``photo_reduce_pallas`` (interpret mode), at
test_pallas.py's tolerances; and the split plan is checked to cover every
point once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_slam_tpu.ops.pallas_kernels import photo_reduce_pallas
from sage_slam_tpu_torch.ops import photo_reduce as tred

torch.set_num_threads(1)

WEIGHTS = (10.0, 9.0, 8.0, 7.0)


def _rand_inputs(e, lv, c, n, dim, soft, seed=0):
    rng = np.random.default_rng(seed)
    fgs = rng.standard_normal((e, lv, 3 * c, n)).astype(np.float32)
    f0 = rng.standard_normal((e, lv, c, n)).astype(np.float32)
    gate = rng.random((e, n)).astype(np.float32)
    if not soft:
        gate = (gate > 0.2).astype(np.float32)
    kx = rng.standard_normal((e, dim, n)).astype(np.float32)
    ky = rng.standard_normal((e, dim, n)).astype(np.float32)
    return fgs, f0, gate, kx, ky


def _padded_product(fgs, f0_cm, gate, kx, ky, weights, ratios, pad):
    """The Pallas kernel's padded product (pallas_kernels.py:88-112,
    142-145) in plain torch: kx padded with zero rows and a row of ones at
    dim+1; kgx rows dim, dim+1, dim+2 = hx, gate^2 sum_l w_l d^2, gate^2;
    kgy row dim = hy -> kx_p kgx^T + ky_p kgy^T [E, pad, pad]."""
    e, _, c3, n = fgs.shape
    c, dim = c3 // 3, kx.shape[1]
    gate2 = gate * gate
    gxx, gxy, gyy, hx, hy, esum = (torch.zeros_like(gate) for _ in range(6))
    for lvl, (rx, ry) in enumerate(ratios):
        f1, gx, gy = fgs[:, lvl, :c], fgs[:, lvl, c : 2 * c], fgs[:, lvl, 2 * c :]
        d = f0_cm[:, lvl] - f1
        wl = weights[lvl]
        gxx = gxx + (wl * rx * rx) * torch.sum(gx * gx, dim=1)
        gxy = gxy + (wl * rx * ry) * torch.sum(gx * gy, dim=1)
        gyy = gyy + (wl * ry * ry) * torch.sum(gy * gy, dim=1)
        hx = hx + (wl * rx) * torch.sum(gx * d, dim=1)
        hy = hy + (wl * ry) * torch.sum(gy * d, dim=1)
        esum = esum + wl * torch.sum(d * d, dim=1)
    gxx, gxy, gyy, hx, hy = (gate2 * t for t in (gxx, gxy, gyy, hx, hy))
    kx_p = torch.zeros((e, pad, n))
    ky_p = torch.zeros((e, pad, n))
    kx_p[:, :dim], ky_p[:, :dim] = kx, ky
    kx_p[:, dim + 1] = 1.0
    kgx = gxx[:, None] * kx_p + gxy[:, None] * ky_p
    kgy = gxy[:, None] * kx_p + gyy[:, None] * ky_p
    kgx[:, dim], kgx[:, dim + 1], kgx[:, dim + 2] = hx, gate2 * esum, gate2
    kgy[:, dim], kgy[:, dim + 1 :] = hy, 0.0
    return kx_p @ kgx.transpose(1, 2) + ky_p @ kgy.transpose(1, 2)


def _assert_reduce_close(out, ref, binary):
    """test_pallas.py's tolerances: ata/atb rtol 1e-4 with atol 1e-6 of
    max|ata|; err rtol 2e-5; n_inl exact for a binary gate, rtol 1e-6 for
    a soft one."""
    ata, atb, err, inl = (np.asarray(x) for x in out)
    ata_r, atb_r, err_r, inl_r = (np.asarray(x) for x in ref)
    scale = float(np.max(np.abs(ata_r)))
    np.testing.assert_allclose(ata, ata_r, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(atb, atb_r, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(err, err_r, rtol=2e-5)
    if binary:
        np.testing.assert_array_equal(inl, inl_r)
    else:
        np.testing.assert_allclose(inl, inl_r, rtol=1e-6)


@pytest.mark.parametrize(
    "shape,soft",
    [((3, 4, 16, 512, 29), False), ((3, 4, 16, 512, 29), True), ((2, 3, 8, 1000, 17), True),
     ((3, 4, 16, 512, 45), True)],
    ids=["pallas-shape-binary", "pallas-shape-soft", "ragged-dim17", "pallas-shape-dim45-soft"],
)
def test_unpacked_padded_product_matches_ref_and_pallas(shape, soft):
    e, lv, c, n, dim = shape
    ins = _rand_inputs(e, lv, c, n, dim, soft)
    ratios = tuple((0.5**i, 0.5**i) for i in range(lv))
    t_ins = [torch.from_numpy(x) for x in ins]
    padded = _padded_product(*t_ins, WEIGHTS, ratios, tred.pad_for(dim))
    unpacked = tred.unpack_padded(padded, dim)
    for view in unpacked:  # views of the one buffer, no copies
        assert view.untyped_storage().data_ptr() == padded.untyped_storage().data_ptr()
    ref = tred.photo_reduce_ref(*t_ins, WEIGHTS, ratios)
    pallas = photo_reduce_pallas(
        *(jnp.asarray(x) for x in ins), WEIGHTS[:lv], ratios, c, interpret=True
    )
    binary = not soft
    _assert_reduce_close(unpacked, ref, binary)
    _assert_reduce_close(unpacked, pallas, binary)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 100, 1000, 1001, 3072, 3073])
def test_split_plan_covers_every_point_once(n):
    for e in (1, 3, 24):
        for slots in (1, 132, 264, 396):
            splits = tred.num_splits(n, e, slots)
            assert 1 <= splits and (splits == 1 or splits <= n // tred.TILE_POINTS)
            ranges = tred.split_ranges(n, splits)
            assert len(ranges) == splits
            assert ranges[0][0] == 0 and ranges[-1][1] == n
            for (_, stop), (start, _) in zip(ranges, ranges[1:]):
                assert stop == start  # contiguous, no overlap
            sizes = [stop - start for start, stop in ranges]
            # balanced: each start is within 4 points below s*n/splits
            assert min(sizes) >= 1 and max(sizes) - min(sizes) < 8
            assert all(start % 4 == 0 for start, _ in ranges)  # 16-byte loads stay aligned
    # the bench point: 2 resident blocks on each of 132 SMs, 24 edges
    if n == 3072:
        assert tred.num_splits(n, 24, 264) == 11
        assert {stop - start for start, stop in tred.split_ranges(n, 11)} <= {276, 280}
