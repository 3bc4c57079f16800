"""Port parity: the photometric factor and its reduce against the JAX
package on the same numpy inputs (CPU). On the CPU the port's reduce is
its plain version, photo_reduce_ref; the CUDA kernel is held against it on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sage_slam_tpu.ops import photometric as jph
from sage_slam_tpu.ops.pallas_kernels import photo_reduce_pallas
from sage_slam_tpu.solver import ba as jba
from sage_slam_tpu.solver.graph import Variables as JaxVariables
from sage_slam_tpu_torch import convert
from sage_slam_tpu_torch.config import MapperConfig
from sage_slam_tpu_torch.geometry import interp
from sage_slam_tpu_torch.ops import photo_prep as tprep
from sage_slam_tpu_torch.ops import photo_reduce as tred
from sage_slam_tpu_torch.ops import photometric as tph
from sage_slam_tpu_torch.solver import ba as tba

torch.set_num_threads(1)

WEIGHTS = (10.0, 9.0, 8.0, 7.0)


def _perturbed(variables, seed=2):
    """The graft variables with nonzero codes and scales != 1."""
    rng = np.random.default_rng(seed)
    k, cs = variables.code.shape
    code = (rng.standard_normal((k, cs)) * 0.3).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    return JaxVariables(variables.pose, jnp.asarray(code), jnp.asarray(scale))


@pytest.fixture(scope="module")
def graft_case():
    """The __graft_entry__ problem (K=4, 32x40, C=CS=16, L=4, N=512,
    6 edges): test_pallas.py's reduce shapes with real prep outputs."""
    v, p, pyr = graft._build_problem()
    v = _perturbed(v)
    p = jba.prepare_problem(p, pyr)
    tv = convert.variables_from_numpy(jax.tree.map(np.asarray, v), device="cpu")
    tp = convert.problem_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    return v, p, pyr, tv, tp, convert.camera_pyramid_from_numpy(pyr)


def _jax_prep(v, p, pyr, soft):
    pe = p.photo_edges
    kf0, fr1, shared = jba._photo_inputs(p.window, pe)
    return jax.vmap(
        lambda a, b, c, d, e, f, sh: jph.photo_prep(
            a, b, c, d, e, f, sh, pyr, 1e-6, soft=soft
        ),
        in_axes=(0, 0, 0, 0, 0, 0, None),
    )(
        jba._edge_vars(v, pe.i0), jba._edge_vars(v, pe.i1),
        v.code[pe.i0], v.scale[pe.i0], kf0, fr1, shared,
    )


def _torch_prep(tv, tp, tpyr, soft):
    pe = tp.photo_edges
    kf0, fr1, shared = tba._photo_inputs(tp.window, pe)
    return tph.photo_prep(
        tba._edge_pose(tv, pe.i0), tba._edge_pose(tv, pe.i1),
        tv.code[pe.i0], tv.scale[pe.i0], kf0, fr1, shared, tpyr, 1e-6, soft=soft,
    )


def _assert_reduce_close(out_t, out_j, binary):
    """test_pallas.py's tolerances: ata/atb rtol 1e-4 with atol 1e-6 of
    max|ata|; err rtol 2e-5; n_inl exact for a binary gate (sums of 0/1),
    float32 roundoff (rtol 1e-6) for a soft one."""
    ata_t, atb_t, err_t, inl_t = (x.numpy() for x in out_t)
    ata_j, atb_j, err_j, inl_j = (np.asarray(x) for x in out_j)
    scale = float(np.max(np.abs(ata_j)))
    np.testing.assert_allclose(ata_t, ata_j, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(atb_t, atb_j, rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(err_t, err_j, rtol=2e-5)
    if binary:
        np.testing.assert_array_equal(inl_t, inl_j)
    else:
        np.testing.assert_allclose(inl_t, inl_j, rtol=1e-6)


@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_photo_prep_and_reduce_match_xla_and_pallas(graft_case, soft):
    v, p, pyr, tv, tp, tpyr = graft_case
    prep_j = _jax_prep(v, p, pyr, soft)
    prep_t = _torch_prep(tv, tp, tpyr, soft)
    for name, a, b in zip(("fgs", "f0", "gate", "kx", "ky"), prep_t, prep_j):
        b = np.asarray(b)
        # float32 roundoff of warp/sampling arithmetic, relative to the
        # array's scale (K-rows reach ~1e3)
        np.testing.assert_allclose(
            a.numpy(), b, rtol=1e-4, atol=1e-5 * float(np.max(np.abs(b))), err_msg=name
        )
    ratios = jph.level_ratios(pyr)
    assert tph.level_ratios(tpyr) == ratios
    ref = tred.photo_reduce_ref(*prep_t, WEIGHTS, ratios)
    xla = jax.vmap(
        lambda a, b, g, x, y: jph.photo_reduce_xla(a, b, g, x, y, WEIGHTS, ratios)
    )(*prep_j)
    pallas = photo_reduce_pallas(*prep_j, WEIGHTS, ratios, 16, interpret=None)
    _assert_reduce_close(ref, xla, binary=not soft)
    _assert_reduce_close(ref, pallas, binary=not soft)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = tred.photo_reduce.launches
    wrapped = tred.photo_reduce(*prep_t, WEIGHTS, ratios)
    assert tred.photo_reduce.launches == before
    for a, b in zip(wrapped, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _rand_inputs(e=3, lv=4, c=16, n=512, dim=29, seed=0, soft=False):
    """test_pallas.py's random reduce inputs."""
    rng = np.random.default_rng(seed)
    fgs = rng.standard_normal((e, lv, 3 * c, n)).astype(np.float32)
    f0 = rng.standard_normal((e, lv, c, n)).astype(np.float32)
    gate = rng.random((e, n)).astype(np.float32)
    if not soft:
        gate = (gate > 0.2).astype(np.float32)
    kx = rng.standard_normal((e, dim, n)).astype(np.float32)
    ky = rng.standard_normal((e, dim, n)).astype(np.float32)
    return fgs, f0, gate, kx, ky


@pytest.mark.parametrize(
    "shape,soft",
    [((3, 4, 16, 512, 29), False), ((3, 4, 16, 512, 29), True), ((2, 3, 8, 1000, 17), True)],
    ids=["pallas-shape-binary", "pallas-shape-soft", "ragged-dim17"],
)
def test_photo_reduce_ref_matches_xla_random(shape, soft):
    e, lv, c, n, dim = shape
    ins = _rand_inputs(e, lv, c, n, dim, soft=soft)
    weights = WEIGHTS + (6.0,)  # a config tuple may be longer than L
    ratios = tuple((0.5**i, 0.5**i) for i in range(lv))
    ref = tred.photo_reduce_ref(*(torch.from_numpy(x) for x in ins), weights, ratios)
    xla = jax.vmap(
        lambda a, b, g, x, y: jph.photo_reduce_xla(a, b, g, x, y, weights, ratios)
    )(*(jnp.asarray(x) for x in ins))
    _assert_reduce_close(ref, xla, binary=not soft)


def test_photo_reduce_rejects_bad_inputs():
    ins = [torch.from_numpy(x) for x in _rand_inputs(e=2, n=64)]
    ratios = tuple((0.5**i, 0.5**i) for i in range(4))
    with pytest.raises(TypeError):
        tred.photo_reduce(ins[0].double(), *ins[1:], WEIGHTS, ratios)
    with pytest.raises(ValueError):
        tred.photo_reduce(ins[0], ins[1][:, :, :8], *ins[2:], WEIGHTS, ratios)
    with pytest.raises(ValueError):
        tred.photo_reduce(*ins, WEIGHTS, ratios[:3])
    with pytest.raises(ValueError):
        tred.photo_reduce(*ins, WEIGHTS[:2], ratios)
    with pytest.raises(ValueError):
        tred.photo_reduce(*ins[:4], ins[4][:, :5], WEIGHTS, ratios)


@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_photometric_factor_matches_jax(graft_case, soft):
    v, p, pyr, tv, tp, tpyr = graft_case
    pe = p.photo_edges
    kf0, fr1, shared = jba._photo_inputs(p.window, pe)
    args_j = (jba._edge_vars(v, pe.i0), jba._edge_vars(v, pe.i1), v.code[pe.i0], v.scale[pe.i0], kf0, fr1)
    jac_j = jax.vmap(
        lambda a, b, c, d, e, f, sh: jph.photometric_jac_error(
            a, b, c, d, e, f, sh, pyr, WEIGHTS, 1e-6, soft=soft
        ),
        in_axes=(0, 0, 0, 0, 0, 0, None),
    )(*args_j, shared)
    err_j = jax.vmap(
        lambda a, b, c, d, e, f, sh: jph.photometric_error(
            a, b, c, d, e, f, sh, pyr, WEIGHTS, 1e-6, soft=soft
        ),
        in_axes=(0, 0, 0, 0, 0, 0, None),
    )(*args_j, shared)
    tpe = tp.photo_edges
    tkf0, tfr1, tshared = tba._photo_inputs(tp.window, tpe)
    args_t = (
        tba._edge_pose(tv, tpe.i0), tba._edge_pose(tv, tpe.i1),
        tv.code[tpe.i0], tv.scale[tpe.i0], tkf0, tfr1, tshared, tpyr, WEIGHTS, 1e-6,
    )
    jac_t = tph.photometric_jac_error(*args_t, soft=soft)
    err_t = tph.photometric_error(*args_t, soft=soft)
    _assert_reduce_close(jac_t, jac_j, binary=not soft)
    np.testing.assert_allclose(err_t[0].numpy(), np.asarray(err_j[0]), rtol=2e-5)
    np.testing.assert_allclose(err_t[1].numpy(), np.asarray(err_j[1]), rtol=1e-6)
    # the error-only path evaluates the same cost as the linearization
    np.testing.assert_allclose(err_t[0].numpy(), jac_t[2].numpy(), rtol=2e-5)


def test_photo_tables_and_source_features_match_jax(graft_case):
    v, p, pyr, tv, tp, tpyr = graft_case
    w, tw = p.window, tp.window
    c = w.feat_pyr.shape[0]
    tables_j = jph.build_photo_tables(
        w.feat_pyr.reshape(c, -1), w.grad_pyr.reshape(2, c, -1), w.mask_flat, pyr
    )
    tables_t = tph.build_photo_tables(
        tw.feat_pyr.reshape(c, -1), tw.grad_pyr.reshape(2, c, -1), tw.mask_flat, tpyr
    )
    for a, b in zip(tables_t[:2], tables_j[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len(tables_t) == 4
    for ta, tb in zip(tables_t[2:4], tables_j[2:4]):
        assert len(ta) == len(tb)
        for a, b in zip(ta, tb):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tables_j[4] is None and tables_j[5] is None  # JAX's mega tables: off
    src_j = jph.sample_source_features(w.feat_pyr[:, 0], w.loc1d[0], pyr)
    src_t = tph.sample_source_features(tw.feat_pyr[:, 0], tw.loc1d[0], tpyr)
    np.testing.assert_allclose(src_t.numpy(), np.asarray(src_j), rtol=1e-6, atol=1e-6)


def _frames_tables(w, sel, pyr):
    """FrameTables.build over the window's frames ``sel`` alone."""
    return tph.FrameTables.build(w.feat_pyr[:, sel], w.grad_pyr[:, :, sel], w.mask_flat, pyr,
                                 w.loc1d[sel], w.bias_flat[sel], w.jac_flat[sel])


def _assert_tables_equal(got, want):
    assert [t is None for t in got] == [t is None for t in want]
    assert len(got.dense_fg) == len(want.dense_fg) > 0
    assert len(got.dense_feat) == len(want.dense_feat)
    pairs = list(zip(got.leaves(), want.leaves()))
    assert len(pairs) == len(want.leaves()) == 4 + len(want.dense_fg) + len(want.dense_feat) + 1
    for (a, axis), (b, _) in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), axis


@pytest.mark.parametrize("case", ["rows-slice", "rows-ids", "rows-one-id", "store-write"])
def test_frame_tables_keyframe_rows_equal_their_frames_alone(graft_case, case):
    """Every way keyframe rows leave or enter FrameTables gives, bit for
    bit, the tables FrameTables.build makes from those frames alone: rows
    with a slice (slice_problem_keyframes), with an id tensor
    (compact_problem_keyframes, one gather a table), with one id
    (SlamSystem._store_frame_view: views of the store), and a store's
    zeros + write of K=1 frames in any order (KeyframeStore.write_tables,
    rows never written staying zero)."""
    *_, tv, tp, tpyr = graft_case
    w = tp.window._replace(tables=None)
    full = _frames_tables(w, slice(None), tpyr)
    if case == "rows-slice":
        got = tba.slice_problem_keyframes(tp._replace(window=w._replace(tables=full)), 3, tpyr)
        _assert_tables_equal(got.window.tables, _frames_tables(w, slice(0, 3), tpyr))
    elif case == "rows-ids":
        ids = torch.tensor([3, 0, 2])
        got = tba.compact_problem_keyframes(tp._replace(window=w._replace(tables=full)), ids,
                                            torch.ones(3), tpyr)
        _assert_tables_equal(got.window.tables, _frames_tables(w, ids, tpyr))
    elif case == "rows-one-id":
        got = full.rows(2)
        _assert_tables_equal(got, _frames_tables(w, slice(2, 3), tpyr))
        for (a, _), (b, axis) in zip(got.leaves(), full.leaves()):  # views: no copy
            assert a.data_ptr() == b.select(axis, 2).data_ptr()
    else:
        one = _frames_tables(w, slice(0, 1), tpyr)
        store = tph.FrameTables.zeros(6, one)
        for i in (3, 0, 2, 1):
            store.write(i + 1, _frames_tables(w, slice(i, i + 1), tpyr))
        _assert_tables_equal(store.rows(slice(1, 5)), full)
        assert all(not t.select(axis, 0).any() and not t.select(axis, 5).any()
                   for t, axis in store.leaves())
        assert store.nbytes() == full.nbytes() * 6 // 4
        with pytest.raises(ValueError, match="pixel rows"):
            store.write(0, one._replace(pixel_fg=None))


# ---- the prep kernel (ops/photo_prep, csrc/photo_prep.cu): what runs here ----


def _pixel_bilinear(pixel, frame, x, y, width, height, offset, col, ncols):
    """The prep kernel's gather written in torch: the zero-padded bilinear
    of columns [col, col + ncols) of pixel_table rows [K, T, PW] at level
    coordinates x, y [E, N] of frames ``frame`` [E] -> [E, ncols, N]; the
    four taps of interp._quad_anchor, each read only inside the image,
    combined in the kernel's order."""
    x0, y0 = torch.floor(x), torch.floor(y)
    wx0, wy0 = (x0 + 1.0) - x, (y0 + 1.0) - y
    wx1, wy1 = 1.0 - wx0, 1.0 - wy0
    xi, yi = interp._int_coord(x0, width), interp._int_coord(y0, height)
    out = None
    for dx, dy, wx, wy in ((0, 0, wx0, wy0), (1, 0, wx1, wy0), (0, 1, wx0, wy1), (1, 1, wx1, wy1)):
        xx, yy = xi + dx, yi + dy
        inx, iny = (xx >= 0) & (xx < width), (yy >= 0) & (yy < height)
        w = wx * wy * inx.to(x.dtype) * iny.to(x.dtype)
        idx = offset + yy.clamp(0, height - 1) * width + xx.clamp(0, width - 1)
        rows = pixel[frame[:, None], idx][..., col : col + ncols]  # [E, N, ncols]
        rows = torch.where((inx & iny)[..., None], rows, torch.zeros_like(rows))
        term = rows.movedim(-1, -2) * w[:, None]
        out = term if out is None else out + term
    return out


def _pixel_nearest(pixel, frame, x, y, width, height, col):
    """The kernel's hard gate: the mask column at the nearest pixel (half
    up), zero outside the image."""
    x0, y0 = torch.floor(x), torch.floor(y)
    xr = interp._int_coord(x0, width) + ((x - x0) >= 0.5).long()
    yr = interp._int_coord(y0, height) + ((y - y0) >= 0.5).long()
    inb = (xr >= 0) & (xr < width) & (yr >= 0) & (yr < height)
    idx = yr.clamp(0, height - 1) * width + xr.clamp(0, width - 1)
    return torch.where(inb, pixel[frame[:, None], idx][..., col], torch.zeros_like(x))


def _sample_coords(cam0, e, n, seed):
    """Full-resolution target coordinates [E, N]: inside and around the
    image, far outside it, and NaN."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((e, n), generator=g) * (cam0.width + 8) - 4
    v = torch.rand((e, n), generator=g) * (cam0.height + 8) - 4
    u[:, :3] = torch.tensor([float("nan"), 1e6, -1e6])
    v[:, 3:6] = torch.tensor([float("nan"), -1e6, 1e6])
    u[:, 6], v[:, 6] = -0.5, cam0.height - 0.5  # on the half-pixel border
    return u, v


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_pixel_table_bilinear_equals_quad_and_dense(graft_case, level):
    """The identity the prep kernel rests on: one zero-padded bilinear
    gather from pixel_table's rows gives, bit for bit, the quad gather from
    packed_fg at every level (the gate's mask column too, soft and hard),
    and within float32 roundoff the hat-weight matmul
    (interp.dense_bilinear_cm) of the coarse levels, including coordinates
    outside the image and NaN."""
    *_, tp, tpyr = graft_case
    w = tp.window
    c = w.feat_pyr.shape[0]
    packed_fg, _, dense_fg, _ = tph.build_photo_tables(
        w.feat_pyr.reshape(c, -1), w.grad_pyr.reshape(2, c, -1), w.mask_flat, tpyr)
    pixel = tprep.pixel_table(w.feat_pyr, w.grad_pyr, w.mask_flat, tpyr)
    assert pixel.shape == (4, tpyr.total_pixels, tprep.row_width(c)) and pixel.shape[-1] % 4 == 0
    cam0, cam = tpyr[0], tpyr[level]
    e, n = 6, 400
    frame = torch.tensor([0, 1, 2, 3, 3, 1])
    u, v = _sample_coords(cam0, e, n, seed=level)
    ul, vl = interp.level_coords(u, v, cam.fx / cam0.fx, cam.fy / cam0.fy)
    off = tpyr.level_offsets[level]
    got = _pixel_bilinear(pixel, frame, ul, vl, cam.width, cam.height, off, 0, 3 * c)
    qoff = frame * tpyr.total_quad_rows + tpyr.quad_level_offsets[level]
    rowv, wts = interp.quad_gather_cols(packed_fg, ul, vl, cam.width, cam.height, qoff)
    np.testing.assert_array_equal(got.numpy(), interp.combine_quad_cm(rowv, wts, 3 * c, 3 * c + 1).numpy())
    assert torch.isnan(got).any() and (got == 0).all(dim=1).any()  # NaN and outside points present
    dense = tph.dense_levels(tpyr)
    if level in dense:
        hat = interp.dense_bilinear_cm(dense_fg[dense.index(level)][frame], ul, vl, cam.width, cam.height)
        np.testing.assert_allclose(got.numpy(), hat.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(hat.nan_to_num().abs().max()))
    if level == 0:
        soft = _pixel_bilinear(pixel, frame, ul, vl, cam.width, cam.height, 0, 3 * c, 1)[:, 0]
        np.testing.assert_array_equal(
            soft.numpy(), interp.quad_bilinear_select_cm(rowv, wts, 3 * c, 3 * c + 1).numpy())
        hard = _pixel_nearest(pixel, frame, ul, vl, cam.width, cam.height, 3 * c)
        np.testing.assert_array_equal(hard.numpy(), interp.quad_nearest_select_cm(
            rowv, ul, vl, cam.width, cam.height, 3 * c, 3 * c + 1).numpy())


def test_photo_prep_on_cpu_takes_the_plain_path(graft_case):
    """CPU tensors take photometric.photo_prep: ba's dispatch returns its
    outputs bit for bit and launches nothing."""
    *_, tv, tp, tpyr = graft_case
    before = tprep.photo_prep_edges.launches
    for soft in (False, True):
        got = tba._photo_prep(tv, tp.window, tp.photo_edges, tpyr, 1e-6, soft)
        for a, b in zip(got, _torch_prep(tv, tp, tpyr, soft)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    prepared = tba.prepare_problem(tp, tpyr)
    assert prepared.window.tables.pixel_fg.shape == (4, tpyr.total_pixels, tprep.row_width(16))
    tba.linearize(tv, prepared, tpyr, MapperConfig())
    assert tprep.photo_prep_edges.launches == before


@pytest.mark.parametrize("graph", ["graph", "none", "none-under-no_grad", "graph-under-no_grad"])
def test_photo_prep_dispatch_on_the_card(graft_case, graph, monkeypatch):
    """With the device test answering "on the card", a prepared window's
    inputs reach the kernel's launch, also under no_grad, where a leaf that
    requires grad builds no graph; an input that carries a graph raises
    (the kernel has no backward) and launches nothing."""
    *_, tv, tp, tpyr = graft_case
    calls = []
    monkeypatch.setattr(tprep, "_on_card", lambda t: True)
    monkeypatch.setattr(tprep, "_launch", lambda *a: calls.append(a) or "kernel")
    code = tv.code.clone().requires_grad_(graph.startswith("graph"))
    v = tv._replace(code=code)
    window = tba.prepare_problem(tp, tpyr).window
    run = lambda: tba._photo_prep(v, window, tp.photo_edges, tpyr, 1e-6, False)  # noqa: E731
    if graph == "graph":
        with pytest.raises(ValueError, match="autograd graph"):
            run()
        assert calls == []
        return
    if graph.endswith("under-no_grad"):
        with torch.no_grad():
            out = run()
    else:
        out = run()
    assert out == "kernel" and len(calls) == 1 and calls[0][6] is window


def _check_case(case, tv, tp, tpyr):
    """(rot, trans, code, scale, i0, i1, window) with one defect."""
    w = tp.window
    pixel = w.tables.pixel_fg
    tables = lambda **kw: w._replace(tables=w.tables._replace(**kw))  # noqa: E731
    args = dict(rot=tv.pose.rot, trans=tv.pose.trans, code=tv.code, scale=tv.scale,
                i0=tp.photo_edges.i0, i1=tp.photo_edges.i1, window=w)
    k, n = w.loc1d.shape
    if case == "dim-over-45":  # tables of a 33-entry code, consistent but over the widest kernel
        hw = w.bias_flat.shape[1]
        args["code"] = torch.zeros((k, 33))
        args["window"] = tables(jac_at=torch.zeros((k, n, 33)))._replace(
            jac_flat=torch.zeros((k, hw, 33)))
    elif case == "levels-over-max":
        args["window"] = w._replace(src_feats=torch.zeros((k, tprep.MAX_LEVELS + 1, n, 16)))
    elif case == "float64-homo":
        args["window"] = w._replace(homo=w.homo.double())
    elif case == "int32-edges":
        args["i0"] = args["i0"].int()
    elif case == "non-contiguous-table":
        args["window"] = tables(pixel_fg=pixel.transpose(0, 1).contiguous().transpose(0, 1))
    elif case == "misaligned-table":
        flat = torch.zeros(pixel.numel() + 1)
        args["window"] = tables(pixel_fg=flat[1:].view(pixel.shape))
    elif case == "table-of-another-pyramid":
        args["window"] = tables(pixel_fg=pixel[:, :-4])
    elif case == "no-pixel-table":
        args["window"] = tables(pixel_fg=None)
    elif case == "channels-not-multiple-of-4":
        args["window"] = w._replace(src_feats=w.src_feats[..., :6].contiguous())
    elif case == "bias-without-jac":
        args["window"] = tables(jac_at=None)
    return args


@pytest.mark.parametrize("case,error", [
    ("dim-over-45", ValueError), ("levels-over-max", ValueError), ("float64-homo", TypeError),
    ("int32-edges", TypeError), ("non-contiguous-table", ValueError),
    ("misaligned-table", ValueError), ("table-of-another-pyramid", ValueError),
    ("channels-not-multiple-of-4", ValueError), ("bias-without-jac", ValueError),
    ("no-pixel-table", ValueError),
])
def test_photo_prep_kernel_rejects_what_it_cannot_take(graft_case, case, error):
    """The kernel wrapper's checks, which run before any launch (so here,
    without a card): the limits it shares with K1 (dim <= 45, L <=
    MAX_LEVELS), dtypes, contiguity, 16-byte alignment, shapes and a
    window without its pixel table."""
    *_, tv, tp, tpyr = graft_case
    tp = tba.prepare_problem(tp, tpyr)
    args = _check_case("none", tv, tp, tpyr)
    assert tprep.check_inputs(**args, cam_pyr=tpyr) == (6, 4, 512, 16, 16, 4)
    with pytest.raises(error):
        tprep.check_inputs(**_check_case(case, tv, tp, tpyr), cam_pyr=tpyr)
