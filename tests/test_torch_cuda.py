"""The CUDA photometric reduce against its plain version, the mapper
slice on the card against the same calls on the CPU, the Hessian
assembly kernel against the one-hot path and a float64 sum, and the
geometric factor's kernels against the plain chain.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import). Run on a machine with an H100 and nvcc:
``python -m pytest --noconftest tests/test_torch_cuda.py`` (tests/
conftest.py imports JAX, which the port does not need). chip_smoke.py
makes the same comparison at the window-BA bench shapes."""

import numpy as np
import pytest
import torch

from sage_slam_tpu_torch.ops import photo_reduce as tred
from tests.test_torch_assembly import VARIANTS, assembly_case, index_add_sum, variant_case

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
    # the 48-wide instantiation (dim 30 to 45: CS = 32 is dim 45)
    pytest.param((24, 4, 16, 3072, 45), False, True, id="bench-dim45"),
    pytest.param((3, 4, 16, 512, 45), True, True, id="pallas-dim45-soft"),
    pytest.param((4, 4, 16, 1001, 45), True, True, id="n1001-dim45-soft"),
    pytest.param((2, 4, 16, 100, 30), False, True, id="n100-dim30-binary"),
    pytest.param((3, 4, 16, 512, 45), True, False, id="misaligned-dim45-soft"),
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


@pytest.mark.parametrize("n,dim", [(3072, 29), (1001, 29), (3072, 45)],
                         ids=["vector-loads", "scalar-loads", "vector-loads-dim45"])
def test_kernel_is_deterministic(cuda, n, dim):
    ins = [x.to(cuda) for x in _inputs(24, 4, 16, n, dim, soft=True, seed=3)]
    ratios = tuple((0.5**i, 0.5**i) for i in range(4))
    first = [x.clone() for x in tred.photo_reduce(*ins, WEIGHTS, ratios)]
    second = tred.photo_reduce(*ins, WEIGHTS, ratios)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)  # bit-identical: fixed summation order, no atomics


def test_kernel_refuses_what_it_cannot_take(cuda):
    ins = [x.to(cuda) for x in _inputs(2, 4, 16, 64, 46, soft=False)]
    ratios = tuple((0.5**i, 0.5**i) for i in range(4))
    with pytest.raises(ValueError):  # dim 46 > MAX_DIM: no room for the padding rows at 48
        tred.photo_reduce(*ins, WEIGHTS, ratios)
    ins = [x.to(cuda) for x in _inputs(2, 4, 16, 64, 29, soft=False)]
    with pytest.raises(ValueError):  # non-contiguous
        tred.photo_reduce(*ins[:3], ins[3].transpose(1, 2).contiguous().transpose(1, 2), ins[4], WEIGHTS, ratios)


def _published_mapper(dev, max_keyframes=16, n_frames=6):
    """The mapper at the published widths (SlamConfig(), DepthNetConfig(),
    FeatureNetConfig()) with random weights from a seeded generator, on
    synthetic.mapper_scene; a smaller store than chip_smoke.py's."""
    from sage_slam_tpu_torch import synthetic
    from sage_slam_tpu_torch.config import SlamConfig
    from sage_slam_tpu_torch.geometry.camera import CameraPyramid
    from sage_slam_tpu_torch.mapping.mapper import Mapper
    from sage_slam_tpu_torch.models import depth_network, feature_network

    cfg = SlamConfig(max_keyframes=max_keyframes)
    scene = synthetic.mapper_scene(n_frames, seed=1)
    gen = torch.Generator().manual_seed(1)
    dnet = depth_network.init_network(gen, depth_network.DepthNetConfig())
    fnet = feature_network.init_network(gen, feature_network.FeatureNetConfig())
    mapper = Mapper(cfg, CameraPyramid.build(scene.camera, cfg.pyramid_levels), scene.mask_out,
                    dnet, fnet, video_mask_in=scene.mask_in, device=dev)
    return mapper, scene


def test_build_frame_card_matches_cpu(cuda):
    """Same image and samples through the networks, pyramid and tables on
    the card and on the CPU: within 1e-3 of each tensor's max |value|
    (cuDNN's float32 convolutions against the CPU's); TF32 stays off."""
    mapper, scene = _published_mapper(cuda)
    cpu = mapper.clone("cpu")
    loc = mapper.sample_locations(0.5)
    fr_g = mapper.build_frame(0.5, scene.images[2], loc1d=loc)
    fr_c = cpu.build_frame(0.5, scene.images[2], loc1d=loc.cpu())
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    for name in ("bias_flat", "jac_flat", "feat_pyr", "grad_pyr", "feat_desc_flat", "src_feats",
                 "packed_fg", "packed_feat", "bias_at", "jac_at"):
        of = lambda fr: getattr(fr.tables if name in fr.tables._fields else fr, name)  # noqa: E731
        g, c = of(fr_g).cpu().double(), of(fr_c).double()
        assert float((g - c).abs().max()) <= 1e-3 * float(c.abs().max()), name


def test_mapping_step_card_matches_cpu(cuda):
    """Five keyframes with back connections to the previous 3; the last
    mapping_step on the card and on the CPU from the same state: equal
    iterations and converged flag, variables within 1e-4; the kernel is
    launched once per LM iteration on the card."""
    from sage_slam_tpu_torch.geometry.se3 import SE3

    mapper, scene = _published_mapper(cuda)
    mapper.init_one_frame(0.0, scene.images[0])
    for f in range(1, 5):
        pose = SE3(torch.from_numpy(scene.rot[f]).to(cuda), torch.from_numpy(scene.trans[f]).to(cuda))
        n = mapper.store.num_active
        mapper.enqueue_keyframe(mapper.build_frame(0.1 * f, scene.images[f], pose=pose),
                                list(range(n - 1, max(-1, n - 4), -1)))
        cpu = mapper.clone("cpu") if f == 4 else None
        before = tred.photo_reduce.launches
        err_g = mapper.mapping_step()
        torch.cuda.synchronize()
        assert tred.photo_reduce.launches - before == mapper.last_step_iters > 0
    err_c = cpu.mapping_step()
    assert (cpu.last_step_iters, cpu.last_step_converged) == (
        mapper.last_step_iters, mapper.last_step_converged)
    np.testing.assert_allclose(err_g, err_c, rtol=1e-4)
    vg, vc = mapper.store.variables, cpu.store.variables
    for a, b in ((vg.pose.trans, vc.pose.trans), (vg.pose.rot, vc.pose.rot), (vg.code, vc.code)):
        np.testing.assert_allclose(a[:5].cpu().numpy(), b[:5].numpy(), atol=1e-4)
    np.testing.assert_allclose(vg.scale[:5].cpu().numpy(), vc.scale[:5].numpy(), rtol=1e-4)


BACKWARD_CASES = [
    pytest.param((1, 4, 16, 128, 29), False, id="training-shape-binary"),
    pytest.param((1, 4, 16, 128, 29), True, id="training-shape-soft"),
    pytest.param((24, 4, 16, 3072, 29), False, id="bench-binary"),
    pytest.param((3, 4, 16, 1001, 17), True, id="n1001-dim17-soft"),
    pytest.param((24, 4, 16, 3072, 45), True, id="bench-dim45-soft"),
]


@pytest.mark.parametrize("shape,soft", BACKWARD_CASES)
def test_kernel_backward_matches_autograd_through_plain(cuda, shape, soft):
    """photo_reduce on CUDA tensors that carry a graph launches K1 once and
    differentiates through PhotoReduceFn's closed form: every input's and
    the weights' cotangent within 1e-4 of its max |value| of autograd
    through photo_reduce_ref on the card; fgs, kx and the weights get
    non-zero gradients."""
    e, lv, c, n, dim = shape
    ratios = tuple((0.5**i, 0.5**i) for i in range(lv))
    ins = [x.to(cuda).requires_grad_(True) for x in _inputs(e, lv, c, n, dim, soft, seed=5)]
    w = torch.tensor(WEIGHTS[:lv], device=cuda, requires_grad=True)
    launches, calls = tred.photo_reduce.launches, tred.photo_reduce.backward_calls
    outs = tred.photo_reduce(*ins, w, ratios)
    gen = torch.Generator().manual_seed(6)
    cots = [torch.randn(o.shape, generator=gen).to(cuda) for o in outs]
    got = torch.autograd.grad(outs, [*ins, w], cots)
    assert tred.photo_reduce.launches == launches + 1
    assert tred.photo_reduce.backward_calls == calls + 1
    ref = torch.autograd.grad(tred.photo_reduce_ref(*ins, w, ratios), [*ins, w], cots)
    for name, a, b in zip(("fgs", "f0_cm", "gate", "kx", "ky", "weights"), got, ref):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale, name
    for i in (0, 3, 5):
        assert float(got[i].abs().max()) > 0


def test_kernel_without_a_graph_skips_the_function(cuda):
    """Under torch.no_grad (the serving path) the wrapper launches K1
    directly: no graph, no backward."""
    ins = [x.to(cuda).requires_grad_(True) for x in _inputs(2, 4, 16, 256, 29, False)]
    ratios = tuple((0.5**i, 0.5**i) for i in range(4))
    with torch.no_grad():
        out = tred.photo_reduce(*ins, WEIGHTS, ratios)
    assert all(o.grad_fn is None for o in out)
    out = tred.photo_reduce(*ins, WEIGHTS, ratios)
    assert all(o.grad_fn is not None for o in out[:3])


def _double(tree):
    """A (nested) NamedTuple or tuple with its float32 tensors in float64."""
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.dtype == torch.float32 else tree
    if isinstance(tree, tuple):
        items = [_double(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _bench_prep(dev, soft, flat=False, cs=16, k=8, n_photo=24):
    """The prep kernel's and the plain chain's outputs on the photometric
    edges of the bench point's problem (``k`` keyframes, ``n_photo`` ring
    edges, a ``cs``-dim code; drawn codes and scales; ``flat`` drops the
    prepared decode tables), the plain chain's in float64, and the
    pyramid."""
    from sage_slam_tpu_torch import synthetic
    from sage_slam_tpu_torch.config import MapperConfig
    from sage_slam_tpu_torch.ops import photometric
    from sage_slam_tpu_torch.solver import ba
    from sage_slam_tpu_torch.solver.graph import Variables

    v, p, pyr = synthetic.bench_problem(device=dev, k=k, cs=cs, n_photo=n_photo)
    p = ba.prepare_problem(p, pyr)
    gen = torch.Generator().manual_seed(7)
    v = Variables(v.pose, 0.1 * torch.randn(v.code.shape, generator=gen).to(dev),
                  1.0 + 0.1 * torch.randn(v.scale.shape, generator=gen).to(dev))
    w = p.window
    if flat:
        w = w._replace(tables=w.tables._replace(bias_at=None, jac_at=None))
    pe, eps = p.photo_edges, MapperConfig().dpt_eps
    got = ba._photo_prep(v, w, pe, pyr, eps, soft)
    plain = lambda v, w: photometric.photo_prep(  # noqa: E731
        ba._edge_pose(v, pe.i0), ba._edge_pose(v, pe.i1), v.code[pe.i0], v.scale[pe.i0],
        *ba._photo_inputs(w, pe), pyr, eps, soft=soft)
    return got, plain(v, w), plain(_double(v), _double(w)), pyr


@pytest.mark.parametrize("soft,flat", [(False, False), (True, False), (True, True)],
                         ids=["hard-gate", "soft-gate", "bias_flat-loc"])
def test_prep_kernel_matches_plain_chain(cuda, soft, flat):
    """The prep kernel (ops/photo_prep) against photometric.photo_prep at
    the bench point: one launch; the source features bit-equal; samples,
    gate and K-rows within float32 roundoff of coordinates summed in
    another order, each K-row (per edge) no further from the float64 chain
    than 8x the plain float32 chain or 1e-7 of the row's largest value
    (chip_smoke.py's phase 14 holds every shape and variant element by
    element); K1 on each within phase 4's linearize tolerance."""
    from sage_slam_tpu_torch.config import MapperConfig
    from sage_slam_tpu_torch.ops import photo_prep, photometric

    before = photo_prep.photo_prep_edges.launches
    got, ref, exact, pyr = _bench_prep(cuda, soft, flat)
    assert photo_prep.photo_prep_edges.launches == before + 1
    assert torch.equal(got[1], ref[1])
    for name, a, b, tol in (("fgs", got[0], ref[0], 2e-4), ("gate", got[2], ref[2], 1e-4)):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), name
    for name, i in (("kx", 3), ("ky", 4)):
        a, b, t = got[i], ref[i], exact[i]
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        t = t.nan_to_num(0.0)
        row_max = t.abs().amax(dim=2)  # [E, dim]: each K-row against its own scale
        err_k = (a.double().nan_to_num(0.0) - t).abs().amax(dim=2)
        err_p = (b.double().nan_to_num(0.0) - t).abs().amax(dim=2)
        assert bool((err_k <= 8.0 * torch.maximum(err_p, 1e-7 * row_max)).all()), name
    weights, ratios = tuple(MapperConfig().photo_factor_weights), photometric.level_ratios(pyr)
    k1 = [tuple(x.double().cpu().numpy() for x in tred.photo_reduce(*p, weights, ratios)) for p in (got, ref)]
    scale = float(np.abs(k1[1][0]).max())
    for a, b in zip(k1[0][:2], k1[1][:2]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(k1[0][2], k1[1][2], rtol=1e-4)


def test_prep_kernel_is_deterministic(cuda):
    first = [x.clone() for x in _bench_prep(cuda, True)[0]]
    second = _bench_prep(cuda, True)[0]
    for a, b in zip(first, second):
        assert torch.equal(a, b)  # no atomics: every output written once by one thread


@pytest.mark.parametrize("k,e", [(8, 24), (8, 48), (64, 372)], ids=["e24", "e48", "e372"])
def test_wide_prep_and_k1_match_plain_chains(cuda, k, e):
    """At CS = 32: the 32-code prep kernel against photometric.photo_prep,
    held as test_prep_kernel_matches_plain_chain holds the 16-code one, and
    the 48-wide K1 on the kernel's prep against photo_reduce_ref on it
    (test_kernel_matches_plain's tolerances); one launch of each, and each
    launch counts its instantiation's width in the span open around it."""
    from sage_slam_tpu_torch.ops import photo_prep
    from sage_slam_tpu_torch.utils import timing

    before = photo_prep.photo_prep_edges.launches
    timing.reset()
    timing.enable(True)
    with timing.span("probe"):
        got, ref, exact, pyr = _bench_prep(cuda, True, cs=32, k=k, n_photo=e)
        ratios = tuple((0.5**i, 0.5**i) for i in range(pyr.levels))
        out = tred.photo_reduce(*got, WEIGHTS, ratios)
    timing.enable(False)
    (rec,) = [r for r in timing.records() if r.name == "probe"]
    timing.reset()
    assert photo_prep.photo_prep_edges.launches == before + 1
    assert rec.counts == {"photo.prep_kernel": 1, "photo.prep_cs": 32, "photo.k1_pad": 48}
    assert got[3].shape == (e, 45, 3072)
    assert torch.equal(got[1], ref[1])
    for name, a, b, tol in (("fgs", got[0], ref[0], 2e-4), ("gate", got[2], ref[2], 1e-4)):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), name
    for name, i in (("kx", 3), ("ky", 4)):
        a, b, t = got[i], ref[i], exact[i]
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        t = t.nan_to_num(0.0)
        row_max = t.abs().amax(dim=2)
        err_k = (a.double().nan_to_num(0.0) - t).abs().amax(dim=2)
        err_p = (b.double().nan_to_num(0.0) - t).abs().amax(dim=2)
        assert bool((err_k <= 8.0 * torch.maximum(err_p, 1e-7 * row_max)).all()), name
    torch.cuda.synchronize()
    ata, atb, err, n_inl = (x.double().cpu().numpy() for x in out)
    ata_r, atb_r, err_r, n_r = (x.double().cpu().numpy()
                                for x in tred.photo_reduce_ref(*got, WEIGHTS, ratios))
    scale = float(np.abs(ata_r).max())
    np.testing.assert_allclose(ata, ata_r, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(atb, atb_r, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(err, err_r, rtol=2e-5)
    np.testing.assert_allclose(n_inl, n_r, rtol=1e-5)
    np.testing.assert_array_equal(ata, np.swapaxes(ata, -1, -2))


# ---- the Hessian assembly kernel (csrc/hessian_assembly.cu) ----


def _on(dev, case):
    return tuple(t.to(dev) if isinstance(t, torch.Tensor) else t for t in case)


def _card_assembly(case):
    """One kernel call on copies of h and b -> (H, b, span counts)."""
    from sage_slam_tpu_torch.solver import graph
    from sage_slam_tpu_torch.utils import timing

    h, b, gidx, ata, atb, valid, bd = case
    timing.reset()
    timing.enable(True)
    try:
        out = graph.scatter_hessian(h.clone(), b.clone(), gidx, ata, atb, valid, bd)
        torch.cuda.synchronize()
    finally:
        timing.enable(False)
    (rec,) = timing.records()
    timing.reset()
    return out[0], out[1], rec.counts


ASSEMBLY_CASES = {
    "cell16_photo": (64, 16, "photo"), "cell16_geo": (64, 16, "geo"),
    "cell32_photo": (64, 32, "photo"), "cell32_geo": (64, 32, "geo"),
    "prior_code32": (64, 32, "prior_code"), "prior_code16": (64, 16, "prior_code"),
    "prior_pose": (64, 16, "prior_pose"), "prior_scale": (64, 16, "prior_scale"),
    "pose_graph": (40, 0, "pose_graph"), "store256_pose_graph": (256, 0, "pose_graph"),
    "random_pairs": (9, 4, "geo"),
}


@pytest.mark.parametrize("name", list(ASSEMBLY_CASES))
def test_assembly_kernel_matches_one_hot_and_index_add(cuda, name):
    """The kernel against the plain one-hot path (on the CPU) and the
    float64 index_add_ sum, to float32 roundoff, at the cells' shapes
    (E=372: S=29 / 46 at D=1,472 and S=45 / 78 at D=2,496), the priors
    (E=K=64, S=32, 16, 6, 1), the pose graph (block width 7, S=14) and
    random pairs; H exactly symmetric, one assembly.kernel count and E·S·S
    entries in the span, and two calls bitwise equal."""
    from sage_slam_tpu_torch.solver import graph

    k, cs, kind = ASSEMBLY_CASES[name]
    cpu = assembly_case(k, cs, kind, e=30 if name == "random_pairs" else 0, seed=len(name))
    case = _on(cuda, cpu)
    before = graph._scatter_kernel.calls
    h, b, counts = _card_assembly(case)
    e, s = cpu[2].shape
    if name.startswith("cell"):
        assert (e, s, h.shape[0]) == (372, 13 + cs if kind == "photo" else 14 + 2 * cs, 64 * (7 + cs))
    assert counts == {"entries": e * s * s, "assembly.kernel": 1}
    assert graph._scatter_kernel.calls == before + 1
    want_h, want_b = index_add_sum(*cpu[:6])
    one_h, one_b = graph.scatter_hessian_ref(*cpu[:6])
    scale = float(want_h.abs().max())
    for got, want in ((h, want_h), (one_h, want_h), (b, want_b), (one_b, want_b)):
        torch.testing.assert_close(got.cpu().double(), want, rtol=1e-5, atol=1e-6 * scale)
    torch.testing.assert_close(h.cpu(), one_h, rtol=1e-5, atol=1e-6 * scale)
    assert torch.equal(h, h.T)
    h2, b2, _ = _card_assembly(case)
    assert torch.equal(h, h2) and torch.equal(b, b2)


@pytest.mark.parametrize("variant", VARIANTS)
def test_assembly_kernel_edge_cases(cuda, variant):
    """E=0 (no launch, no count), every edge invalid (H and b untouched),
    an edge whose slots repeat a global index (all summed), accumulation
    onto a non-zero symmetric h (in place, still exactly symmetric),
    valid² weighting, indices outside [0, D) and a block wider than a tile
    (block width 70, tiles of 64), each against the float64 sum."""
    from sage_slam_tpu_torch.solver import graph

    cpu = variant_case(variant)
    h, b, gidx = cpu[:3]
    case = _on(cuda, cpu)
    before = graph._scatter_kernel.calls
    out_h, out_b = graph.scatter_hessian(*case)
    torch.cuda.synchronize()
    assert graph._scatter_kernel.calls == before + (gidx.shape[0] > 0)
    assert out_h.data_ptr() == case[0].data_ptr()  # in place
    want_h, want_b = index_add_sum(*cpu[:6])
    scale = max(float(want_h.abs().max()), 1.0)
    torch.testing.assert_close(out_h.cpu().double(), want_h, rtol=1e-5, atol=1e-6 * scale)
    torch.testing.assert_close(out_b.cpu().double(), want_b, rtol=1e-5, atol=1e-6 * scale)
    if variant in ("no_edges", "all_invalid"):
        assert torch.equal(out_h.cpu(), h) and torch.equal(out_b.cpu(), b)
    assert torch.equal(out_h, out_h.T)


def test_assembly_kernel_launches_two_kernels_without_a_host_read(cuda):
    """One call at the CS=32 cell's geometric shape: two kernels in the
    profile (the plan and the tile pass), and nothing that synchronizes
    with the host (torch's sync debug mode raises on such a call)."""
    from torch.profiler import ProfilerActivity, profile

    from sage_slam_tpu_torch.solver import graph

    case = _on(cuda, assembly_case(64, 32, "geo"))
    graph.scatter_hessian(*case)  # builds and loads the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.scatter_hessian(*case)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA}
    assert len(counts) == 2 and all(c == 1 for c in counts.values()), counts
    for kernel in ("assembly_plan", "assembly_tiles"):
        assert sum(kernel in name for name in counts) == 1, counts


def test_assembly_kernel_refuses_what_it_cannot_take(cuda):
    from sage_slam_tpu_torch.solver import graph

    h, b, gidx, ata, atb, valid, bd = _on(cuda, assembly_case(8, 4, "photo", e=10))
    with pytest.raises(TypeError):
        graph.scatter_hessian(h.double(), b, gidx, ata, atb, valid, bd)
    with pytest.raises(TypeError):
        graph.scatter_hessian(h, b, gidx.int(), ata, atb, valid, bd)
    with pytest.raises(ValueError):  # updated in place: h must be contiguous
        graph.scatter_hessian(h.T, b, gidx, ata, atb, valid, bd)
    with pytest.raises(ValueError):
        graph.scatter_hessian(h, b, gidx, ata[:, :1], atb, valid, bd)
    with pytest.raises(ValueError):  # no backward
        graph.scatter_hessian(h, b, gidx, ata.clone().requires_grad_(), atb, valid, bd)


# ---- the geometric factor's linearization (csrc/geo_linearize.cu) ----


def _geo_case(dev, cs=16, k=8, e=24, flat=False):
    """The geometric edges of the bench point's problem (``k`` keyframes,
    ``e`` ring edges, a ``cs``-dim code; drawn codes and scales; ``flat``
    drops the prepared decode tables) -> (variables, window, edges, camera,
    config)."""
    from sage_slam_tpu_torch import synthetic
    from sage_slam_tpu_torch.config import MapperConfig
    from sage_slam_tpu_torch.solver import ba
    from sage_slam_tpu_torch.solver.graph import Variables

    v, p, pyr = synthetic.bench_problem(device=dev, k=k, cs=cs, n_geo=e)
    p = ba.prepare_problem(p, pyr)
    gen = torch.Generator().manual_seed(11)
    v = Variables(v.pose, 0.1 * torch.randn(v.code.shape, generator=gen).to(dev),
                  1.0 + 0.1 * torch.randn(v.scale.shape, generator=gen).to(dev))
    w = p.window
    if flat:
        w = w._replace(tables=w.tables._replace(bias_at=None, jac_at=None))
    return v, w, p.geo_edges, pyr[0], MapperConfig()


GEO_CASES = [
    pytest.param(16, 8, 24, False, id="cs16-e24"),
    pytest.param(16, 8, 48, False, id="cs16-e48"),
    pytest.param(16, 64, 372, False, id="cs16-e372"),
    pytest.param(32, 8, 24, False, id="cs32-e24"),
    pytest.param(32, 8, 48, False, id="cs32-e48"),
    pytest.param(32, 64, 372, False, id="cs32-e372"),
    pytest.param(16, 8, 24, True, id="cs16-e24-bias_flat"),
]


@pytest.mark.parametrize("cs,k,e,flat", GEO_CASES)
def test_geo_kernel_matches_plain_chain(cuda, cs, k, e, flat):
    """The kernels (ops/geo_linearize, through ba's dispatch) against
    build_frame1_tables + geometric_jac_error on the card, held as
    chip_smoke.py's phase 16 holds them (geo_compare: n_inl exact, ata and
    atb within rtol 1e-4 + atol 1e-5 max |ata|, the error within 1e-4, on
    every edge, an edge with points at a step of the nearest-pixel mask or
    the z test against the plain chain with some of them flipped where it
    misses the unflipped one; two calls bit-equal, ata exactly
    symmetric); one call launches the split kernel once, counted as
    geo.kernel 1 and geo.code_width W in the span open around it."""
    import chip_smoke
    from sage_slam_tpu_torch.ops import geo_linearize
    from sage_slam_tpu_torch.solver import ba
    from sage_slam_tpu_torch.utils import timing

    v, w, ge, cam, cfg = _geo_case(cuda, cs, k, e, flat)
    before = geo_linearize.geo_linearize_edges.launches
    timing.reset()
    timing.enable(True)
    with timing.span("probe"):
        got = chip_smoke._geo_kernel(v, w, ge, cam, cfg)
    timing.enable(False)
    (rec,) = [r for r in timing.records() if r.name == "probe"]
    timing.reset()
    assert geo_linearize.geo_linearize_edges.launches == before + 1
    assert rec.counts == {"geo.kernel": 1, "geo.code_width": cs}
    dim = 14 + 2 * cs
    assert got[0].shape == (e, dim, dim) and got[1].shape == (e, dim)
    three = ba._geo_linearize(v, w, ge, cam, cfg)
    assert all(torch.equal(a, b) for a, b in zip(three, got[:3]))
    stats, faults = chip_smoke.geo_compare(v, w, ge, cam, cfg, f"CS={cs} E={e}")
    assert not faults, faults


def test_geo_kernel_launches_three_kernels_without_a_host_read(cuda):
    """One call at the CS=32 cell's shape: three kernels in the profile (the
    frame-1 table, the splits, the combine), and nothing that synchronizes
    with the host (torch's sync debug mode raises on such a call)."""
    from torch.profiler import ProfilerActivity, profile

    from sage_slam_tpu_torch.solver import ba

    v, w, ge, cam, cfg = _geo_case(cuda, 32, 64, 372)
    ba._geo_linearize(v, w, ge, cam, cfg)  # builds and loads the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            ba._geo_linearize(v, w, ge, cam, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA}
    assert len(counts) == 3 and all(c == 1 for c in counts.values()), counts
    for kernel in ("geo_frame1_table", "geo_split_points<32>", "geo_combine<32>"):
        assert sum(kernel in name for name in counts) == 1, counts


@pytest.mark.parametrize("cs", [16, 32])
def test_linearize_with_geo_kernel_matches_cpu(cuda, cs):
    """ba.linearize on the card (prep kernel, K1, the geometric kernels,
    the assembly) against the same call on CPU copies (the plain chains):
    H and b within rtol 1e-4 + atol 1e-5 max |H|, the error within 1e-4
    (chip_smoke's phase 4 tolerance)."""
    from sage_slam_tpu_torch import convert, synthetic
    from sage_slam_tpu_torch.config import MapperConfig
    from sage_slam_tpu_torch.ops import geo_linearize
    from sage_slam_tpu_torch.solver import ba

    v, p, pyr = synthetic.bench_problem(device=cuda, cs=cs)
    p = ba.prepare_problem(p, pyr)
    cfg = MapperConfig()
    before = geo_linearize.geo_linearize_edges.launches
    h, b, err = ba.linearize(v, p, pyr, cfg)
    assert geo_linearize.geo_linearize_edges.launches == before + 1
    h_c, b_c, err_c = ba.linearize(convert.to_device(v, "cpu"), convert.to_device(p, "cpu"), pyr, cfg)
    scale = float(h_c.abs().max())
    torch.testing.assert_close(h.cpu(), h_c, rtol=1e-4, atol=1e-5 * scale)
    torch.testing.assert_close(b.cpu(), b_c, rtol=1e-4, atol=1e-5 * scale)
    torch.testing.assert_close(err.cpu(), err_c, rtol=1e-4, atol=0.0)


def test_geo_kernel_refuses_a_graph_and_training_keeps_the_plain_chain(cuda):
    """An input on the card that carries an autograd graph raises in the
    dispatch and launches nothing; geometric.geometric_jac_error, which
    training calls directly, keeps its graph on the card and launches
    nothing either."""
    from sage_slam_tpu_torch.ops import geo_linearize
    from sage_slam_tpu_torch.solver import ba

    v, w, ge, cam, cfg = _geo_case(cuda)
    before = geo_linearize.geo_linearize_edges.launches
    vg = v._replace(code=v.code.clone().requires_grad_())
    with pytest.raises(ValueError, match="autograd graph"):
        ba._geo_linearize(vg, w, ge, cam, cfg)
    import chip_smoke

    ata, atb, err, _ = chip_smoke._geo_plain(vg, w, ge, cam, cfg)
    assert ata.grad_fn is not None and err.grad_fn is not None
    assert geo_linearize.geo_linearize_edges.launches == before


def test_geo_kernel_refuses_what_it_cannot_take(cuda):
    """Wrong dtype or shape, CS > 32, a CS that is not a multiple of 4, a
    code basis off a 16-byte boundary and E = 0 raise before any launch."""
    from sage_slam_tpu_torch.ops import geo_linearize

    v, w, ge, cam, cfg = _geo_case(cuda)
    k, n = w.loc1d.shape
    hw = w.bias_flat.shape[1]
    before = geo_linearize.geo_linearize_edges.launches
    call = lambda **kw: geo_linearize.geo_linearize_edges(  # noqa: E731
        **{**dict(rot=v.pose.rot, trans=v.pose.trans, code=v.code, scale=v.scale, i0=ge.i0,
                  i1=ge.i1, window=w, cam=cam, loss_factor=cfg.geo_loss_param_factor,
                  weight=cfg.geo_factor_weight, eps=cfg.dpt_eps), **kw})
    with pytest.raises(TypeError):
        call(scale=v.scale.double())
    with pytest.raises(ValueError):
        call(window=w._replace(homo=w.homo[:, :-1].contiguous()))
    wide = w._replace(jac_flat=torch.zeros((k, hw, 33), device=cuda),
                      tables=w.tables._replace(jac_at=torch.zeros((k, n, 33), device=cuda)))
    with pytest.raises(ValueError):
        call(code=torch.zeros((k, 33), device=cuda), window=wide)
    odd = w._replace(jac_flat=torch.zeros((k, hw, 30), device=cuda),
                     tables=w.tables._replace(jac_at=torch.zeros((k, n, 30), device=cuda)))
    with pytest.raises(ValueError, match="multiple of 4"):
        call(code=torch.zeros((k, 30), device=cuda), window=odd)
    moved = torch.empty(w.jac_flat.numel() + 1, device=cuda)[1:].view(w.jac_flat.shape)
    with pytest.raises(ValueError, match="16-byte"):
        call(window=w._replace(jac_flat=moved.copy_(w.jac_flat)))
    with pytest.raises(ValueError):
        call(i0=ge.i0[:0], i1=ge.i1[:0])
    assert geo_linearize.geo_linearize_edges.launches == before


@pytest.mark.parametrize("solver,path", [("dense", "dense"), ("auto", "schur")])
def test_refine_mapping_over_a_full_store(cuda, monkeypatch, solver, path):
    """RefineMapping (SlamSystem.refine_mapping: full-graph mapping steps,
    each to its relinearization exit, until one converges) over a store
    filled to its 256 keyframes at the published widths (SlamConfig() with
    the mapper's ``solver``, random DepthNetConfig() / FeatureNetConfig()
    networks, the mapper's video, 3 back-connections a keyframe): every step
    solves the 5,888-wide compact problem on the expected path ("auto"
    takes the Schur elimination at 256 keyframes) and the map's variables
    come back finite. Prints its wall time, LM iterations and peak memory."""
    import dataclasses
    import json
    import time

    from sage_slam_tpu_torch import synthetic
    from sage_slam_tpu_torch.config import SlamConfig
    from sage_slam_tpu_torch.frontend.slam import SlamSystem
    from sage_slam_tpu_torch.geometry.se3 import SE3
    from sage_slam_tpu_torch.models import depth_network, feature_network
    from sage_slam_tpu_torch.solver import ba

    cfg = SlamConfig()
    cfg = dataclasses.replace(cfg, mapper=dataclasses.replace(cfg.mapper, solver=solver))
    k = cfg.max_keyframes
    scene = synthetic.mapper_scene(k, seed=1)
    gen = torch.Generator().manual_seed(1)
    dnet = depth_network.init_network(gen, depth_network.DepthNetConfig())
    fnet = feature_network.init_network(gen, feature_network.FeatureNetConfig())
    system = SlamSystem(cfg, scene.camera, scene.mask_out, dnet, fnet, video_mask_in=scene.mask_in,
                        device=cuda)
    mapper = system.mapper
    mapper.init_one_frame(0.0, scene.images[0])
    for f in range(1, k):
        pose = SE3(torch.from_numpy(scene.rot[f]).to(cuda), torch.from_numpy(scene.trans[f]).to(cuda))
        mapper.enqueue_keyframe(mapper.build_frame(0.1 * f, scene.images[f], pose=pose),
                                list(range(f - 1, max(-1, f - 4), -1)))
    assert system.store.num_active == k == 256
    widths, paths = [], []
    run_ba, resolve_solver = ba.run_ba, ba.resolve_solver

    def spy(variables, *args, **kwargs):
        widths.append(variables.num_kf * variables.block_dim)
        return run_ba(variables, *args, **kwargs)

    def spy_solver(*args):
        paths.append(resolve_solver(*args))
        return paths[-1]

    monkeypatch.setattr(ba, "run_ba", spy)
    monkeypatch.setattr(ba, "resolve_solver", spy_solver)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    err = system.refine_mapping()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    assert widths and set(widths) == {k * (7 + cfg.code_size)} == {5888}
    assert set(paths) == {path}
    v = system.store.variables
    for t in (v.pose.rot, v.pose.trans, v.code, v.scale):
        assert bool(torch.isfinite(t[:k]).all())
    assert np.isfinite(err)
    print("refine_mapping_full_store " + json.dumps({
        "card": torch.cuda.get_device_name(cuda), "solver": path, "keyframes": k, "width": widths[0],
        "steps": len(widths), "lm_iters": system.refine_iterations,
        "converged": mapper.last_step_converged, "wall_s": wall_s,
        "peak_bytes": torch.cuda.max_memory_allocated(cuda), "error": float(err)}))
