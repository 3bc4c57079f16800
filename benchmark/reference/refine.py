"""The reference of the full-graph LM cell: the map's problem rebuilt from
the images, the weights and the starting poses, and one full-graph step of
the LM written from the factors' definitions (``lm``).

Recomputed here from the inputs, as the program's set-up derives them: every
keyframe's networks, pyramid, samples and features at them, the first
keyframe's median-depth scale and each later keyframe's scale correction
against its first back-connection, the photometric and geometric edges in
both directions of every connection, the priors (a code prior on every
keyframe; the first keyframe's scale and pose held), and then one step of
the configuration's ``max_gn_iters`` LM iterations over every keyframe.
"""

from __future__ import annotations

import torch

from . import compare, lm
from .frames import Frames, precision

# set between the readings in PERF.md: sound runs, then the control
LIMITS = {"update_gap": 0.03}


def back_connections(i: int, count: int) -> list:
    """Keyframe i's back-connections: the ``count`` keyframes before it,
    newest first."""
    return list(range(i - 1, max(i - 1 - count, -1), -1))


def problem(frames: Frames, built: list, scale0: float, connections: int) -> lm.Problem:
    """The map of the keyframes ``built`` as the LM's problem."""
    m = frames.cfg.mapper
    k = len(built)
    dev = frames.device
    pyr = frames.cam_pyr
    pairs = [(a, b) for i in range(1, k) for c in back_connections(i, connections)
             for a, b in ((i, c), (c, i))]
    edges = (torch.tensor([a for a, _ in pairs], device=dev),
             torch.tensor([b for _, b in pairs], device=dev))
    none = (torch.zeros(0, dtype=torch.long, device=dev),) * 2
    feats, grads = [], []
    for lvl in range(pyr.levels):
        sl = slice(pyr.level_offsets[lvl], pyr.level_offsets[lvl] + pyr[lvl].num_pixels)
        feats.append(torch.stack([f.feat_pyr[:, sl].T for f in built]))
        grads.append(torch.stack([torch.cat([f.grad_pyr[0, :, sl].T, f.grad_pyr[1, :, sl].T], -1)
                                  for f in built]))
    stack = lambda name: torch.stack([getattr(f, name) for f in built])  # noqa: E731
    return lm.Problem(
        loc1d=stack("loc1d").long(), homo=stack("homo"), bias=stack("bias_flat"),
        basis=stack("jac_flat"), feats=tuple(feats), grads=tuple(grads), src=stack("src_feats"),
        avg_sq_bias=stack("avg_sq_bias"), mask=frames.mask_flat,
        levels=tuple(lm.Level(c.fx, c.fy, c.cx, c.cy, c.width, c.height) for c in pyr.cameras),
        photo=edges if m.use_photometric else none, geo=edges if m.use_geometric else none,
        scale_target=scale0)


def build(frames: Frames, images: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor,
          connections: int) -> tuple:
    """The map the inputs define -> (lm.Problem, the starting lm.State)."""
    k = images.shape[0]
    built, scales = [], []
    for i in range(k):
        fr = frames.build(float(i), images[i])
        if i == 0:
            scale = frames.init_scale(fr)
        else:
            j = back_connections(i, connections)[0]
            ref_depth = frames.depth(built[j], built[j].code, scales[j])
            scale = frames.correct_scale(fr, (rot[i], trans[i]), ref_depth, (rot[j], trans[j]))
        built.append(fr)
        scales.append(scale)
    start = lm.State(rot.clone(), trans.clone(),
                     torch.zeros(k, frames.cfg.code_size, device=frames.device),
                     torch.tensor(scales, dtype=torch.float32, device=frames.device))
    return problem(frames, built, scales[0], connections), start


def outputs(frames: Frames, images: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor,
            connections: int, tf32: bool) -> dict:
    """One step from the map the inputs define -> {"start": lm.State,
    "result": lm.State}."""
    with precision(tf32):
        pb, start = build(frames, images, rot, trans, connections)
        result = lm.run(start, pb, frames.cfg.mapper, frames.cfg.mapper.max_gn_iters)
    return {"start": start, "result": result}


def update_gap(got: lm.State, ref: lm.State, start: lm.State) -> float:
    """The worst of the pose, code and scale gaps (see compare)."""
    pose = compare.moved_gap(compare.pose_diff(got.rot, got.trans, ref.rot, ref.trans),
                             compare.pose_diff(ref.rot, ref.trans, start.rot, start.trans))
    code = compare.moved_gap((got.code.double() - ref.code.double()).abs().amax(-1),
                             (ref.code.double() - start.code.double()).abs().amax(-1))
    scale = compare.moved_gap((got.scale.double() - ref.scale.double()).abs(),
                              (ref.scale.double() - start.scale.double()).abs())
    return max(pose, code, scale)


def gaps(results: list, ref: dict) -> list:
    """The cell's number over every step's variables ``results`` against
    the reference's step."""
    value = max(update_gap(v, ref["result"], ref["start"]) for v in results)
    return [compare.check("update_gap", value, LIMITS["update_gap"])]
