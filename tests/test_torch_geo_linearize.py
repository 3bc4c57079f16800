"""The geometric factor's linearization kernel wrapper (ops/geo_linearize)
on the CPU: the dispatch, the input checks and the split count, which run
before any launch. The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 16)."""

import pytest
import torch

from sage_slam_tpu_torch import synthetic
from sage_slam_tpu_torch.config import MapperConfig
from sage_slam_tpu_torch.ops import geo_linearize as geo
from sage_slam_tpu_torch.ops import geometric
from sage_slam_tpu_torch.solver import ba
from sage_slam_tpu_torch.utils import timing


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def case():
    """The graft problem (K=4, 32x40, CS=16, N=512, 6 geometric edges) on
    the CPU, prepared, with drawn codes and scales."""
    v, p, pyr = synthetic.graft_problem(device="cpu")
    gen = torch.Generator().manual_seed(3)
    v = v._replace(code=0.1 * torch.randn(v.code.shape, generator=gen),
                   scale=1.0 + 0.1 * torch.randn(v.scale.shape, generator=gen))
    return v, ba.prepare_problem(p, pyr), pyr


def test_linearize_on_cpu_takes_the_plain_chain(case):
    """CPU tensors take build_frame1_tables + geometric_jac_error: the
    dispatch returns their outputs bit for bit, and a whole linearize
    launches nothing and counts no geo.kernel."""
    v, p, pyr = case
    cfg = MapperConfig()
    ge, w = p.geo_edges, p.window
    before = geo.geo_linearize_edges.launches
    got = ba._geo_linearize(v, w, ge, pyr[0], cfg)
    kf0, kf1, shared = ba._geo_inputs(w, ge, v, pyr[0], which="full")
    ref = geometric.geometric_jac_error(
        ba._edge_pose(v, ge.i0), ba._edge_pose(v, ge.i1), v.code[ge.i0], v.code[ge.i1],
        v.scale[ge.i0], v.scale[ge.i1], kf0, kf1, shared, pyr[0], cfg.geo_factor_weight,
        cfg.geo_loss_param_factor * w.avg_sq_bias[ge.i0], cfg.dpt_eps)
    assert len(got) == 3
    for a, b in zip(got, ref[:3]):
        assert torch.equal(a, b)
    timing.reset()
    timing.enable(True)
    try:
        ba.linearize(v, p, pyr, cfg)
    finally:
        timing.enable(False)
    spans = [r for r in timing.records() if r.name == "lin.geo"]
    timing.reset()
    assert geo.geo_linearize_edges.launches == before
    assert len(spans) == 1 and "geo.kernel" not in spans[0].counts
    assert spans[0].counts["edges"] == ge.i0.shape[0]


@pytest.mark.parametrize("graph", ["graph", "none", "none-under-no_grad", "graph-under-no_grad"])
def test_geo_dispatch_on_the_card(case, graph, monkeypatch):
    """With the device test answering "on the card", the window whole and
    the edge indices reach the kernels, also under no_grad, where a leaf
    that requires grad builds no graph; an input that carries a graph
    raises (the kernels have no backward) and launches nothing."""
    v, p, pyr = case
    calls = []
    monkeypatch.setattr(geo, "_on_card", lambda t: True)
    monkeypatch.setattr(geo, "geo_linearize_edges",
                        lambda *a: calls.append(a) or ("ata", "atb", "err", "n"))
    v = v._replace(scale=v.scale.clone().requires_grad_(graph.startswith("graph")))
    run = lambda: ba._geo_linearize(v, p.window, p.geo_edges, pyr[0], MapperConfig())  # noqa: E731
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
    cfg = MapperConfig()
    assert out == ("ata", "atb", "err") and len(calls) == 1
    args = calls[0]
    assert args[4] is p.geo_edges.i0 and args[5] is p.geo_edges.i1 and args[6] is p.window
    assert args[8:] == (cfg.geo_loss_param_factor, cfg.geo_factor_weight, cfg.dpt_eps)


def _args(case, defect):
    """(rot, trans, code, scale, i0, i1, window, cam) with one defect."""
    v, p, pyr = case
    w, ge = p.window, p.geo_edges
    args = dict(rot=v.pose.rot, trans=v.pose.trans, code=v.code, scale=v.scale, i0=ge.i0,
                i1=ge.i1, window=w, cam=pyr[0])
    k, n = w.loc1d.shape
    hw = w.bias_flat.shape[1]
    tables = lambda **kw: w._replace(tables=w.tables._replace(**kw))  # noqa: E731
    if defect == "cs-over-32":  # consistent tables of a 33-entry code
        args["code"] = torch.zeros((k, 33))
        args["window"] = tables(jac_at=torch.zeros((k, n, 33)))._replace(
            jac_flat=torch.zeros((k, hw, 33)))
    elif defect == "cs-30":  # consistent tables of a code the float4 reads cannot take
        args["code"] = torch.zeros((k, 30))
        args["window"] = tables(jac_at=torch.zeros((k, n, 30)))._replace(
            jac_flat=torch.zeros((k, hw, 30)))
    elif defect in ("jac_flat-misaligned", "jac_at-misaligned"):  # contiguous, 4 bytes in
        name = defect.split("-")[0]
        t = getattr(w, name) if name == "jac_flat" else w.tables.jac_at
        moved = torch.empty(t.numel() + 1)[1:].view(t.shape).copy_(t)
        args["window"] = (w._replace(jac_flat=moved) if name == "jac_flat"
                          else tables(jac_at=moved))
    elif defect == "no-edges":
        args["i0"] = args["i1"] = ge.i0[:0]
    elif defect == "float64-scale":
        args["scale"] = v.scale.double()
    elif defect == "int32-indices":
        args["i0"] = ge.i0.int()
    elif defect == "homo-shape":
        args["window"] = w._replace(homo=w.homo[:, :-1])
    elif defect == "mask-shape":
        args["window"] = w._replace(mask_flat=w.mask_flat[:-1])
    elif defect == "avg_sq_bias-shape":
        args["window"] = w._replace(avg_sq_bias=w.avg_sq_bias[:-1])
    elif defect == "jac_flat-not-contiguous":
        args["window"] = w._replace(jac_flat=w.jac_flat.transpose(0, 1).contiguous().transpose(0, 1))
    elif defect == "bias_at-alone":
        args["window"] = tables(jac_at=None)
    return args


@pytest.mark.parametrize("defect,error", [
    ("cs-over-32", ValueError), ("cs-30", ValueError), ("jac_flat-misaligned", ValueError),
    ("jac_at-misaligned", ValueError), ("no-edges", ValueError), ("float64-scale", TypeError),
    ("int32-indices", TypeError), ("homo-shape", ValueError), ("mask-shape", ValueError),
    ("avg_sq_bias-shape", ValueError), ("jac_flat-not-contiguous", ValueError),
    ("bias_at-alone", ValueError),
])
def test_check_inputs_rejects_what_the_kernel_cannot_take(case, defect, error):
    """The wrapper's checks, which run before any launch (so here, without a
    card): CS <= 32 and a multiple of 4, the code rows 16-byte aligned,
    1 <= E, dtypes, shapes, contiguity, and the decode
    tables given together."""
    assert geo.check_inputs(**_args(case, "none")) == (6, 4, 512, 32 * 40, 16)
    flat = _args(case, "none")
    flat["window"] = flat["window"]._replace(tables=None)  # loc1d into bias_flat, jac_flat
    assert geo.check_inputs(**flat) == (6, 4, 512, 32 * 40, 16)
    with pytest.raises(error):
        geo.check_inputs(**_args(case, defect))


@pytest.mark.parametrize("n,e,slots,want", [
    (3072, 372, 528, 4),  # the full-graph cell at four blocks an SM (W = 16): 1,488 of 1,584 slots
    (3072, 372, 264, 2),  # two blocks an SM (W = 32): 744 of 792
    (3072, 372, 132, 1),  # one block an SM: 372 of 396
    (3072, 48, 264, 5),  # a mapper window: 240 of 264
    (3072, 24, 264, 10),  # the bench point: 240 of 264
    (3072, 16, 528, 24),  # a small window: at most a tile of points a split
    (100, 6, 264, 1),  # under one tile
])
def test_num_splits_fills_the_grid(n, e, slots, want):
    """The split count follows E: the fewest splits whose grid fills its
    last wave at least FILL full, at most one a tile of points."""
    got = geo.num_splits(n, e, slots)
    assert got == want
    assert 1 <= got <= max(1, n // geo.TILE_POINTS)
    blocks = e * got
    full = blocks / (-(-blocks // slots) * slots)
    assert full >= geo.FILL or got == max(1, n // geo.TILE_POINTS) or e * got < slots


@pytest.mark.parametrize("cs,width", [(1, 16), (16, 16), (17, 32), (32, 32), (33, None)])
def test_code_width(cs, width):
    if width is None:
        with pytest.raises(ValueError):
            geo.code_width(cs)
    else:
        assert geo.code_width(cs) == width


def test_geo_hold_finds_the_flipped_step_points(case):
    """chip_smoke.geo_hold, which holds every edge of the card's kernels to
    the plain chain, on a stand-in for the kernels: the plain chain with the
    mask flipped at one point of edge 1 and two of edge 3 and the z test at
    one point of edge 2, those points listed among the step points with
    decoys beside. Every edge is held, against the subset that was flipped;
    an edge moved without a step point, or flipped at a point not listed,
    is not held."""
    import chip_smoke

    v, p, pyr = case
    w, ge, cfg = p.window, p.geo_edges, MapperConfig()

    def plain(fm, fp):
        return chip_smoke._geo_plain_flipped(v, w, ge, pyr[0], cfg, fm, fp)

    none = torch.zeros((ge.i0.shape[0], w.loc1d.shape[1]), dtype=torch.bool)
    mask_flip, z_flip = none.clone(), none.clone()
    mask_flip[1, 5] = mask_flip[3, 7] = mask_flip[3, 9] = True
    z_flip[2, 3] = True
    mask_step = mask_flip.clone()
    mask_step[1, 6] = mask_step[3, 8] = mask_step[5, 2] = True  # decoys, not flipped
    got = plain(mask_flip, z_flip)
    base = plain(none, none)
    assert torch.equal(got[3] != base[3], torch.tensor([False, True, True, True, False, False]))
    ref, flips, ok = chip_smoke.geo_hold(got, plain, mask_step, z_flip)
    assert bool(ok.all())
    assert flips.tolist() == [0, 1, 1, 2, 0, 0]
    for a, b in zip(ref, got):
        torch.testing.assert_close(a, b.double(), rtol=0, atol=0)

    moved = [x.clone() for x in got]
    moved[0][0] *= 1.01  # edge 0 has no step point
    mask_step[3, 9] = False  # edge 3's second flip is not listed
    _, _, ok = chip_smoke.geo_hold(moved, plain, mask_step, z_flip)
    assert ok.tolist() == [False, True, True, False, True, True]
