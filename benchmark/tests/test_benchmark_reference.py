"""The comparison that decides ``correct``, on the CPU at a tiny size.

The reference's LM step is its own: the warp's derivatives it takes by
autograd match finite differences. The program's run passes the
comparison; a perturbed output and a lower precision fail it; and with the timed path broken underneath (a step that returns its
state unchanged, half of the batch left out, an answer altered where it is
produced) a whole run comes out not correct. Each cell runs on one card, so
it has no exchange between cards to leave out. On the CPU the lower
precision is the reference computed from inputs rounded to TF32's 10-bit
mantissa (the card's control turns TF32 on instead, which the CPU lacks).
"""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark import run as brun
from benchmark.reference import compare, lm as ref_lm, refine

from .conftest import SEED

CPU = torch.device("cpu")
LM = "refine_map64.full_graph_lm"


def run_cell(root, name, seconds=2.0):
    cell = harness.resolve(root, name)
    return brun.measure(cell, SEED, seconds, False, CPU, harness.now())


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (round half up)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.fixture(scope="module")
def lm(tiny):
    return run_cell(tiny, LM)


def test_the_program_passes(lm):
    res, checks, _ = lm
    assert res["correct"], checks
    assert list(res)[-1] == "checks"


def test_the_warp_derivatives_match_finite_differences(lm):
    _, _, out = lm
    frames, images, rot, trans, conn, _ = out["reference"]
    pb, start = refine.build(frames, images, rot, trans, conn)
    pb = pb._replace(homo=pb.homo.double(), bias=pb.bias.double(), basis=pb.basis.double())
    state = ref_lm.State(*(t.double() for t in start))
    state = state._replace(code=torch.rand_like(state.code))
    i0, i1 = pb.photo[0][:4], pb.photo[1][:4]
    cs = state.code.shape[-1]
    p = torch.zeros(4, 14 + 2 * cs, dtype=torch.float64)
    fn = lambda q: ref_lm._points(state, pb, i0, i1, q)  # noqa: E731
    _, jac = ref_lm._jvp(fn, p, 13 + cs)
    for j in range(13 + cs):
        step = torch.zeros_like(p)
        step[:, j] = 1e-6
        fd = (fn(p + step) - fn(p - step)) / 2e-6
        assert torch.allclose(jac[j], fd, rtol=1e-5, atol=1e-7), j


def test_a_perturbed_output_fails(lm):
    _, _, out = lm
    ref = out["reference"][-1]
    res = ref["result"]
    moved = res._replace(code=res.code + 0.1 * (res.code - ref["start"].code))
    assert not compare.passes(refine.gaps([moved], ref))
    assert compare.passes(refine.gaps([res], ref))


def test_a_lower_precision_fails(lm):
    _, _, out = lm
    frames, images, rot, trans, conn, ref = out["reference"]
    with torch.no_grad():
        for p in frames.depth_net.parameters():
            p.copy_(tf32_round(p))
    low = refine.outputs(frames, tf32_round(images), rot, trans, conn, tf32=False)
    assert not compare.passes(refine.gaps([low["result"]], ref))


def _unchanged_step(orig):
    def run_ba(variables, problem, cam_pyr, cfg, update_mask, max_iters=None, use_conv=False):
        _, err, iters, conv = orig(variables, problem, cam_pyr, cfg, update_mask, max_iters, use_conv)
        return variables, err, iters, conv
    return run_ba


def _half_edges(orig):
    def run_ba(variables, problem, cam_pyr, cfg, update_mask, max_iters=None, use_conv=False):
        def half(e):
            keep = torch.arange(e.valid.shape[0]) < e.valid.shape[0] // 2
            return e._replace(valid=e.valid * keep.to(e.valid))
        problem = problem._replace(photo_edges=half(problem.photo_edges),
                                   geo_edges=half(problem.geo_edges))
        return orig(variables, problem, cam_pyr, cfg, update_mask, max_iters, use_conv)
    return run_ba


def _altered_answer(orig):
    def run_ba(*args, **kwargs):
        v, err, iters, conv = orig(*args, **kwargs)
        return v._replace(scale=v.scale * 1.01), err, iters, conv
    return run_ba


@pytest.mark.parametrize("fault", [_unchanged_step, _half_edges, _altered_answer])
def test_a_broken_full_graph_step_is_not_correct(tiny, monkeypatch, fault):
    from sage_slam_tpu_torch.solver import ba

    monkeypatch.setattr(ba, "run_ba", fault(ba.run_ba))
    res, checks, _ = run_cell(tiny, LM, seconds=1.0)
    assert not res["correct"], checks


@pytest.mark.cuda
def test_a_cell_is_correct_on_the_card(card, tiny):
    cell = harness.resolve(tiny, LM)
    res, checks, _ = brun.measure(cell, SEED, 2.0, True, card, harness.now())
    assert res["correct"], checks
    assert res["device"]["busy_s"] > 0
