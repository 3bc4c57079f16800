"""The CUDA photometric reduce against its plain version, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import). Run on a machine with an H100 and nvcc:
``python -m pytest --noconftest tests/test_torch_cuda.py`` (tests/
conftest.py imports JAX, which the port does not need). chip_smoke.py
makes the same comparison at the window-BA bench shapes."""

import numpy as np
import pytest
import torch

from sage_slam_tpu_torch.ops import photo_reduce as tred

pytestmark = pytest.mark.cuda

WEIGHTS = (10.0, 9.0, 8.0, 7.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from sage_slam_tpu_torch.device import set_f32_precision

    set_f32_precision()
    return torch.device("cuda")


def _inputs(e, lv, c, n, dim, soft, seed=0):
    rng = np.random.default_rng(seed)
    gate = rng.random((e, n)).astype(np.float32)
    if not soft:
        gate = (gate > 0.2).astype(np.float32)
    return tuple(
        torch.from_numpy(x)
        for x in (
            rng.standard_normal((e, lv, 3 * c, n)).astype(np.float32),
            rng.standard_normal((e, lv, c, n)).astype(np.float32),
            gate,
            rng.standard_normal((e, dim, n)).astype(np.float32),
            rng.standard_normal((e, dim, n)).astype(np.float32),
        )
    )


@pytest.mark.parametrize(
    "shape,soft",
    [
        ((3, 4, 16, 512, 29), False),
        ((3, 4, 16, 512, 29), True),
        ((24, 4, 16, 3072, 29), False),
        ((2, 3, 8, 1000, 17), True),
    ],
    ids=["pallas-binary", "pallas-soft", "bench", "ragged-dim17"],
)
def test_kernel_matches_plain(cuda, shape, soft):
    e, lv, c, n, dim = shape
    ins = _inputs(e, lv, c, n, dim, soft)
    ratios = tuple((0.5**i, 0.5**i) for i in range(lv))
    ref = tred.photo_reduce_ref(*(x.to(cuda) for x in ins), WEIGHTS, ratios)
    before = tred.photo_reduce.launches
    out = tred.photo_reduce(*(x.to(cuda) for x in ins), WEIGHTS, ratios)
    torch.cuda.synchronize()
    assert tred.photo_reduce.launches == before + 1
    ata, atb, err, n_inl = (x.cpu().numpy() for x in out)
    ata_r, atb_r, err_r, n_r = (x.cpu().numpy() for x in ref)
    scale = float(np.abs(ata_r).max())
    # test_pallas.py's tolerances (float32 sums in another order)
    np.testing.assert_allclose(ata, ata_r, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(atb, atb_r, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(err, err_r, rtol=2e-5)
    if soft:
        np.testing.assert_allclose(n_inl, n_r, rtol=1e-5)
    else:
        np.testing.assert_array_equal(n_inl, n_r)
    np.testing.assert_array_equal(ata, np.swapaxes(ata, -1, -2))  # bit-symmetric


def test_kernel_refuses_what_it_cannot_take(cuda):
    ins = [x.to(cuda) for x in _inputs(2, 4, 16, 64, 33, soft=False)]
    ratios = tuple((0.5**i, 0.5**i) for i in range(4))
    with pytest.raises(ValueError):  # dim 33 > MAX_DIM
        tred.photo_reduce(*ins, WEIGHTS, ratios)
    ins = [x.to(cuda) for x in _inputs(2, 4, 16, 64, 29, soft=False)]
    with pytest.raises(ValueError):  # non-contiguous
        tred.photo_reduce(*ins[:3], ins[3].transpose(1, 2).contiguous().transpose(1, 2), ins[4], WEIGHTS, ratios)
