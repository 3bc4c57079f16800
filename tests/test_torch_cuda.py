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


def _misaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary (the kernel then takes its scalar-load path)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


# the edges of the kernel's design: N % 4 != 0 (scalar loads), N under one
# 64-point tile, one edge, dim < 29 (more padding rows), misaligned bases
CASES = [
    pytest.param((3, 4, 16, 512, 29), False, True, id="pallas-binary"),
    pytest.param((3, 4, 16, 512, 29), True, True, id="pallas-soft"),
    pytest.param((24, 4, 16, 3072, 29), False, True, id="bench"),
    pytest.param((2, 3, 8, 1000, 17), True, True, id="ragged-dim17"),
    pytest.param((4, 4, 16, 1001, 29), False, True, id="n1001-binary"),
    pytest.param((4, 4, 16, 1001, 29), True, True, id="n1001-soft"),
    pytest.param((2, 4, 16, 100, 29), False, True, id="n100-binary"),
    pytest.param((2, 4, 16, 100, 29), True, True, id="n100-soft"),
    pytest.param((1, 4, 16, 3072, 29), False, True, id="one-edge-binary"),
    pytest.param((1, 4, 16, 3072, 29), True, True, id="one-edge-soft"),
    pytest.param((4, 4, 16, 1024, 17), False, True, id="dim17-binary"),
    pytest.param((3, 4, 16, 512, 29), True, False, id="misaligned-soft"),
]


@pytest.mark.parametrize("shape,soft,aligned", CASES)
def test_kernel_matches_plain(cuda, shape, soft, aligned):
    e, lv, c, n, dim = shape
    ins = _inputs(e, lv, c, n, dim, soft)
    ratios = tuple((0.5**i, 0.5**i) for i in range(lv))
    ref = tred.photo_reduce_ref(*(x.to(cuda) for x in ins), WEIGHTS, ratios)
    dev_ins = [x.to(cuda) if aligned else _misaligned(x.to(cuda)) for x in ins]
    before = tred.photo_reduce.launches
    out = tred.photo_reduce(*dev_ins, WEIGHTS, ratios)
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


@pytest.mark.parametrize("n", [3072, 1001], ids=["vector-loads", "scalar-loads"])
def test_kernel_is_deterministic(cuda, n):
    ins = [x.to(cuda) for x in _inputs(24, 4, 16, n, 29, soft=True, seed=3)]
    ratios = tuple((0.5**i, 0.5**i) for i in range(4))
    first = [x.clone() for x in tred.photo_reduce(*ins, WEIGHTS, ratios)]
    second = tred.photo_reduce(*ins, WEIGHTS, ratios)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)  # bit-identical: fixed summation order, no atomics


def test_kernel_refuses_what_it_cannot_take(cuda):
    ins = [x.to(cuda) for x in _inputs(2, 4, 16, 64, 30, soft=False)]
    ratios = tuple((0.5**i, 0.5**i) for i in range(4))
    with pytest.raises(ValueError):  # dim 30 > MAX_DIM: no room for the padding rows
        tred.photo_reduce(*ins, WEIGHTS, ratios)
    ins = [x.to(cuda) for x in _inputs(2, 4, 16, 64, 29, soft=False)]
    with pytest.raises(ValueError):  # non-contiguous
        tred.photo_reduce(*ins[:3], ins[3].transpose(1, 2).contiguous().transpose(1, 2), ins[4], WEIGHTS, ratios)
