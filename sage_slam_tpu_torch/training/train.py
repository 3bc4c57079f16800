"""Training driver — two-phase curriculum with the differentiable BA (port
of sage_slam_tpu/training/train.py).

SGD with momentum 0.9 on a cyclic learning rate, gradients clipped to a
global norm of 10; a ``separate`` phase (depth and descriptor losses only)
switching to a ``joint`` phase that runs the unrolled differentiable BA
inside the loss; an LSGAN discriminator step; npz checkpoints with
epoch/step resume in the JAX package's file format (``arr_i`` in
``jax.tree.flatten`` order of the params dict, then ``step`` and
``epoch``), so a checkpoint of either package loads into the other.

The optimizers are optax's, written out by hand: ``clip_by_global_norm``
scales by max_norm / |g| only when |g| >= max_norm (no epsilon), the
momentum trace is g + 0.9 t, and the update is -lr(count) t with the
schedule read at the step count before its increment. The joint phase's
chain keeps the same trace and count. The discriminator's SGD is
unclipped at base_lr and steps on its pre-update parameters, with the
generator's prediction detached.

Sample ids cannot follow ``jax.random``: a step draws its two frames'
photometric sample ids from a seeded CPU ``torch.Generator`` or takes them
injected (``ids=``). Parameters live in a dict like the JAX one: ``depth``
(DepthNetwork), ``feat`` (FeatureNetwork), ``ba`` (BAParams of 0-d
tensors), ``log_sigma`` (0-d tensor) and ``disc`` (Discriminator). A step
updates them in place; ``clone_state`` copies a state (the plateau
snapshots, the card-against-CPU hold).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..geometry.camera import CameraPyramid
from ..geometry.interp import locations_1d_to_2d, locations_1d_to_homo
from ..models import depth_network, feature_network
from ..ops import geometric, photometric
from ..ops.pyramid import gaussian_pyramid_with_grad, mask_pyramid
from . import diff_ba, discriminator, losses
from .dataset import Triplet


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    base_lr: float = 1.0e-4
    max_lr: float = 1.0e-3
    cycle_steps: int = 2000
    separate_train_epoch: int = 2
    grad_clip: float = 10.0
    depth_weight: float = 1.0
    flow_weight: float = 1.0
    desc_weight: float = 1.0
    no_match_weight: float = 0.1
    hist_weight: float = 0.1
    decor_weight: float = 1.0e-3
    g_adv_weight: float = 1.0e-3
    ba_iters: int = 4
    ba_use_reproj: bool = False  # the reference defines the term but never calls it
    # ---- joint-phase stabilizers ----
    # LR multiplier while in the joint phase (the loss through the unrolled
    # LM is stiffer than the separate-phase one)
    joint_lr_factor: float = 0.25
    # ramp the BA-derived losses in over this many joint epochs; the
    # net-bias depth anchor ramps out
    ba_warmup_epochs: int = 4
    # per-iteration backward cotangent clip through the LM unroll
    # (diff_ba._bwd_clip); 0 disables
    ba_bwd_clip: float = 1.0
    # floor of the net-bias depth supervision in the joint phase (the
    # runtime starts depth from the zero-code bias)
    ba_depth_anchor: float = 0.5
    response_sigma_init: float = 30.0
    pyramid_levels: int = 3
    num_photo_samples: int = 128
    eval_fraction: float = 0.1  # the held-out evaluation split


class TrainState(NamedTuple):
    params: dict  # depth / feat / ba / log_sigma / disc
    opt_state: dict  # {"trace": [gen leaves' momentum], "count": int}
    disc_opt_state: dict  # {"trace": [disc leaves' momentum]}
    step: int
    epoch: int


def _path_key(name: str):
    """Sort key of a dotted parameter name in jax.tree.flatten order (dict
    keys sorted, list indices numeric)."""
    return tuple(int(c) if c.isdigit() else c for c in name.split("."))


def module_leaves(net: torch.nn.Module):
    """[(dotted name, parameter)] in jax.tree.flatten order of the JAX
    param tree with the same names."""
    return sorted(net.named_parameters(), key=lambda kv: _path_key(kv[0]))


def param_leaves(params: dict, with_disc: bool = True):
    """[(name, tensor)] of the params dict in jax.tree.flatten order: ba
    (its fields in order), depth, disc, feat, log_sigma. Without the
    discriminator: the generator's leaves, optax's order for them."""
    out = []
    for key in sorted(params):
        if key == "disc" and not with_disc:
            continue
        value = params[key]
        if isinstance(value, diff_ba.BAParams):
            out += [(f"ba.{f}", getattr(value, f)) for f in value._fields]
        elif isinstance(value, torch.nn.Module):
            out += [(f"{key}.{n}", p) for n, p in module_leaves(value)]
        else:
            out.append((key, value))
    return out


def cyclic_lr(cfg: TrainConfig):
    """Triangular cyclic LR between base_lr and max_lr, in float32 as the
    JAX schedule computes it."""
    f = np.float32

    def schedule(step) -> float:
        s = f(step)
        cycle = np.floor(f(1) + s / f(2 * cfg.cycle_steps))
        x = np.abs(s / f(cfg.cycle_steps) - f(2) * cycle + f(1))
        return f(cfg.base_lr) + f(cfg.max_lr - cfg.base_lr) * np.maximum(f(0), f(1) - x)

    return schedule


def init_state(generator: torch.Generator, depth_cfg, feat_cfg, disc_cfg, cfg: TrainConfig,
               device=None) -> TrainState:
    """Random networks from ``generator`` (depth, feature, discriminator in
    that order), BAParams.init, log sigma, zero momentum."""
    dev = resolve_device(device)
    ba = diff_ba.BAParams.init(cfg.pyramid_levels, device=dev)
    params = {
        "depth": depth_network.init_network(generator, depth_cfg, device=dev),
        "feat": feature_network.init_network(generator, feat_cfg, device=dev),
        "ba": diff_ba.BAParams(*(p.requires_grad_(True) for p in ba)),
        "log_sigma": torch.log(torch.tensor(cfg.response_sigma_init, dtype=torch.float32)).to(dev)
        .requires_grad_(True),
        "disc": discriminator.init_network(generator, disc_cfg, device=dev),
    }
    return fresh_optimizer_state(params)


def fresh_optimizer_state(params: dict, step: int = 0, epoch: int = 0) -> TrainState:
    """A TrainState over ``params`` with zero momentum at count 0."""
    zeros = lambda leaves: [torch.zeros_like(t) for _, t in leaves]  # noqa: E731
    disc = module_leaves(params["disc"])
    return TrainState(
        params=params,
        opt_state={"trace": zeros(param_leaves(params, with_disc=False)), "count": 0},
        disc_opt_state={"trace": zeros(disc)},
        step=step, epoch=epoch,
    )


def clone_state(state: TrainState, device=None) -> TrainState:
    """A deep copy of ``state`` (on ``device`` if given)."""
    dev = torch.device(device) if device is not None else None

    def tensor(t):
        out = t.detach().clone()
        out = out.to(dev) if dev is not None else out
        return out.requires_grad_(t.requires_grad)

    params = {}
    for key, value in state.params.items():
        if isinstance(value, torch.nn.Module):
            net = copy.deepcopy(value)
            params[key] = net.to(dev) if dev is not None else net
        elif isinstance(value, diff_ba.BAParams):
            params[key] = diff_ba.BAParams(*(tensor(t) for t in value))
        else:
            params[key] = tensor(value)
    return TrainState(
        params=params,
        opt_state={"trace": [tensor(t) for t in state.opt_state["trace"]],
                   "count": state.opt_state["count"]},
        disc_opt_state={"trace": [tensor(t) for t in state.disc_opt_state["trace"]]},
        step=state.step, epoch=state.epoch,
    )


def resize_linear(image: torch.Tensor, hw) -> torch.Tensor:
    """[C, H, W] -> [C, h, w]: jax.image.resize(..., "linear") (a triangle
    filter widened by the scale when downsampling, i.e. antialiased)."""
    return F.interpolate(image[None], size=tuple(hw), mode="bilinear", antialias=True,
                         align_corners=False)[0]


def draw_sample_ids(generator: torch.Generator, hw: int, n: int):
    """The two frames' photometric sample ids, a permutation prefix each."""
    return tuple(torch.randperm(hw, generator=generator)[:n] for _ in range(2))


def _prep_frame(params, image, mask_out, cam_pyr: CameraPyramid, loc1d, mask_in=None):
    """Network inference and pyramids for one frame. ``mask_in`` is the
    input-res video mask fed to the partial convs (None: all ones)."""
    in_mask = (mask_in[None].to(image.dtype) if mask_in is not None
               else torch.ones((1,) + tuple(image.shape[1:]), dtype=image.dtype, device=image.device))
    fmap, fdesc = feature_network.apply(params["feat"], image, in_mask)
    bias, basis = depth_network.apply(params["depth"], image, in_mask)
    cs = basis.shape[0]
    masks = mask_pyramid(mask_out, cam_pyr.levels)
    fpyr, gpyr = gaussian_pyramid_with_grad(fmap, masks, cam_pyr.levels)
    loc1d = loc1d.to(image.device).long()
    return dict(
        bias_flat=bias.reshape(-1),
        jac_flat=basis.reshape(cs, -1).T,
        feat_pyr=fpyr,
        grad_pyr=gpyr,
        desc_flat=fdesc.reshape(fdesc.shape[0], -1).T,
        loc1d=loc1d,
        homo=locations_1d_to_homo(loc1d, cam_pyr[0]),
    )


def make_loss_fn(cam_pyr: CameraPyramid, cfg: TrainConfig, joint: bool):
    """loss_fn(params, batch, ids, warm=1.0) -> (total loss, aux dict) over
    one triplet; ``ids`` are the (src, close) photometric sample ids."""

    def loss_fn(params, batch, ids, warm=1.0):
        cam = cam_pyr[0]
        mask = batch["mask"]
        mask_in = batch.get("mask_in")
        f_src = _prep_frame(params, batch["image_src"], mask, cam_pyr, ids[0], mask_in)
        f_close = _prep_frame(params, batch["image_close"], mask, cam_pyr, ids[1], mask_in)
        image_far = batch["image_far"]
        in_mask = (mask_in[None] if mask_in is not None
                   else torch.ones((1,) + tuple(image_far.shape[1:]), device=image_far.device))
        _, fdesc_far = feature_network.apply(params["feat"], image_far, in_mask)
        desc_far_flat = fdesc_far.reshape(fdesc_far.shape[0], -1).T

        sigma = torch.exp(params["log_sigma"])
        aux = {}
        kp_src, gt_close = batch["keypoints_src"], batch["gt_match_close"]
        # descriptor losses: symmetric relative response, src->close and back
        l_rr = 0.5 * (
            losses.rr_loss(f_src["desc_flat"], f_close["desc_flat"], kp_src, gt_close, sigma)
            + losses.rr_loss(f_close["desc_flat"], f_src["desc_flat"], gt_close, kp_src, sigma)
        )
        # no-match loss at the keypoints that project outside the close
        # frame's mask, weighted to zero where the dataset found none
        l_nm = batch["no_match_valid"] * losses.no_match_loss(
            f_src["desc_flat"], f_close["desc_flat"], batch["no_match_src"], sigma)
        src_cdf = losses.descriptor_cdf_histogram(f_src["desc_flat"][kp_src])
        close_cdf = losses.descriptor_cdf_histogram(f_close["desc_flat"][gt_close])
        far_cdf = losses.descriptor_cdf_histogram(desc_far_flat[kp_src])
        # the triplet loss counts only where the far frame truly does not
        # overlap the source
        l_hist = batch["far_valid"] * losses.triplet_histogram_loss(src_cdf, close_cdf, far_cdf)
        total = cfg.desc_weight * l_rr + cfg.no_match_weight * l_nm + cfg.hist_weight * l_hist
        aux.update(rr=l_rr, no_match=l_nm, hist=l_hist)

        # depth supervision on the network output (separate phase) or the
        # BA result (joint phase)
        cs = f_src["jac_flat"].shape[-1]
        h, w = cam.height, cam.width
        bias_src = f_src["bias_flat"].reshape(h, w)
        if joint:
            dev = mask.device
            zero = torch.zeros(1, dtype=torch.long, device=dev)
            hw = mask.numel()
            mask_flat = mask.reshape(-1)
            kf0 = photometric.PhotoKf0(
                loc1d=f_src["loc1d"][None], homo0=f_src["homo"][None],
                src_feats=photometric.sample_source_features(
                    f_src["feat_pyr"], f_src["loc1d"], cam_pyr)[None],
                base_hw=zero, base_pyr=zero,
            )
            photo_shared = photometric.single_frame_shared(
                f_src["bias_flat"], f_src["jac_flat"], f_close["feat_pyr"], f_close["grad_pyr"],
                mask_flat, cam_pyr,
            )
            geo_shared = geometric.GeoShared(
                bias_flat=torch.cat([f_src["bias_flat"], f_close["bias_flat"]]),
                jac_flat=torch.cat([f_src["jac_flat"], f_close["jac_flat"]]),
                mask_flat=mask_flat,
            )
            # keypoint matches for the match-geometry / reprojection terms;
            # the matched target depths are the close frame's FIXED depth
            kp, mt = kp_src.long(), gt_close.long()
            mx, my = locations_1d_to_2d(mt, cam.width)
            matches = diff_ba.MatchSet(
                homo0=locations_1d_to_homo(kp, cam),
                bias0=f_src["bias_flat"][kp],
                jac0=f_src["jac_flat"][kp],
                match_homo1=locations_1d_to_homo(mt, cam),
                match_depths=f_close["bias_flat"][mt],
                matched_2d=torch.stack([mx, my], dim=-1),
                valid=mask_flat[kp] * mask_flat[mt],
            )
            mean_sq_depth = torch.sum((f_close["bias_flat"] * mask_flat) ** 2) / torch.clamp(
                torch.sum(mask_flat), min=1.0)
            inputs = diff_ba.BAInputs(
                kf0=kf0, fr1=photometric.PhotoFr1(base_pyr=zero), photo_shared=photo_shared,
                geo_kf0=geometric.GeoKf0(loc1d=f_src["loc1d"][None], homo0=f_src["homo"][None],
                                         base_hw=zero),
                geo_kf1=geometric.GeoKf1(base_hw=torch.full((1,), hw, dtype=torch.long, device=dev)),
                geo_shared=geo_shared, matches=matches, mean_sq_depth=mean_sq_depth,
                init_scale=torch.tensor(1.0, device=dev),
            )
            # the BA starts from the dataset's perturbed initial pose
            init = diff_ba.BAState(tau10=batch["tau_init"], scale0=torch.tensor(1.0, device=dev),
                                   code0=torch.zeros(cs, device=dev))
            final, _ = diff_ba.ba_optimize(
                params["ba"], inputs, cam_pyr, init, max_iters=cfg.ba_iters,
                use_match_geom=True, use_geom=True, use_reproj=cfg.ba_use_reproj,
                bwd_clip=cfg.ba_bwd_clip,
            )
            pred_depth, pred_flow = diff_ba.ba_outputs(final, f_src["bias_flat"], f_src["jac_flat"], cam)
            l_flow = losses.normalized_masked_l2_flow_loss(
                batch["gt_flow"][None], pred_flow[None], (mask * batch["flow_mask"])[None, None])
            # ``warm`` fades the flow loss in, and cross-fades the depth
            # supervision from the raw net bias to the BA output
            total = total + cfg.flow_weight * warm * l_flow
            aux["flow"] = l_flow
            anchor = max(1.0 - warm, cfg.ba_depth_anchor)
            l_depth_src = warm * losses.scale_invariant_depth_loss(
                batch["depth_src"][None], pred_depth[None], mask[None]
            ) + anchor * losses.scale_invariant_depth_loss(
                batch["depth_src"][None], bias_src[None], mask[None])
        else:
            pred_depth = bias_src
            l_depth_src = losses.scale_invariant_depth_loss(
                batch["depth_src"][None], pred_depth[None], mask[None])
        # the net-bias output's SI-log error, logged in both phases
        aux["depth_net"] = losses.scale_invariant_depth_loss(
            batch["depth_src"][None], bias_src[None], mask[None])

        # depth supervision: 0.75 src + 0.25 close network bias
        l_depth = 0.75 * l_depth_src + 0.25 * losses.scale_invariant_depth_loss(
            batch["depth_close"][None], f_close["bias_flat"].reshape(h, w)[None], mask[None])
        basis = f_src["jac_flat"].T.reshape(1, cs, h, w)
        l_decor = losses.basis_decorrelation_loss(basis, mask[None, None])
        total = total + cfg.depth_weight * l_depth + cfg.decor_weight * l_decor
        aux.update(depth=l_depth, decor=l_decor)

        # adversarial generator term
        disc_in = torch.cat([resize_linear(batch["image_src"], (h, w)), pred_depth[None]], dim=0)
        l_adv = discriminator.lsgan_g_loss(discriminator.apply(params["disc"], disc_in))
        total = total + cfg.g_adv_weight * l_adv
        aux["g_adv"] = l_adv
        aux["pred_depth"] = pred_depth
        return total, aux

    return loss_fn


def _sgd_update(leaves, grads, trace, lr: float):
    """optax.sgd(momentum=0.9): t = g + 0.9 t; p += -lr t (in place)."""
    for (_, p), g, t in zip(leaves, grads, trace):
        t.mul_(0.9).add_(g)
        p.add_(t * (-lr))


def make_train_step(cam_pyr: CameraPyramid, cfg: TrainConfig, joint: bool, lr_factor: float = 1.0):
    """step(state, batch, ids=None, generator=None, warm=1.0) ->
    (state, loss, aux): one generator SGD step (clipped to cfg.grad_clip,
    lr = cyclic_lr(count) * lr_factor) and one discriminator step, on the
    parameters in place. ``ids`` are the two frames' sample ids; without
    them they are drawn from ``generator``."""
    loss_fn = make_loss_fn(cam_pyr, cfg, joint)
    sched = cyclic_lr(cfg)
    h, w = cam_pyr[0].height, cam_pyr[0].width

    def step(state: TrainState, batch, ids=None, generator=None, warm=1.0):
        params = state.params
        if ids is None:
            ids = draw_sample_ids(generator, h * w, cfg.num_photo_samples)
        gen = param_leaves(params, with_disc=False)
        loss, aux = loss_fn(params, batch, ids, warm)
        grads = torch.autograd.grad(loss, [t for _, t in gen], allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for (_, t), g in zip(gen, grads)]

        # discriminator LSGAN step on its pre-update parameters
        disc_leaves = module_leaves(params["disc"])
        img = resize_linear(batch["image_src"], (h, w))
        real = torch.cat([img, batch["depth_src"][None]], dim=0)
        fake = torch.cat([img, aux["pred_depth"].detach()[None]], dim=0)
        d_loss = discriminator.lsgan_d_loss(discriminator.apply(params["disc"], real),
                                            discriminator.apply(params["disc"], fake))
        d_grads = torch.autograd.grad(d_loss, [t for _, t in disc_leaves])

        with torch.no_grad():
            # clip_by_global_norm: g / |g| * max_norm where |g| >= max_norm
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < cfg.grad_clip
            grads = [torch.where(keep, g, g / g_norm * cfg.grad_clip) for g in grads]
            count = state.opt_state["count"]
            lr = float(np.float32(sched(count)) * np.float32(lr_factor))
            _sgd_update(gen, grads, state.opt_state["trace"], lr)
            _sgd_update(disc_leaves, d_grads, state.disc_opt_state["trace"], cfg.base_lr)
        aux_out = {k: v.detach() for k, v in aux.items() if k != "pred_depth"}
        aux_out["d_loss"] = d_loss.detach()
        new_state = state._replace(
            opt_state={"trace": state.opt_state["trace"], "count": count + 1},
            step=state.step + 1,
        )
        return new_state, loss.detach(), aux_out

    return step


def make_eval_step(cam_pyr: CameraPyramid, cfg: TrainConfig, joint: bool):
    """step(state, batch, ids=None, generator=None) -> (loss, aux): the loss
    battery without an optimizer step, under torch.no_grad (aux keeps
    pred_depth for the image logger)."""
    loss_fn = make_loss_fn(cam_pyr, cfg, joint)
    h, w = cam_pyr[0].height, cam_pyr[0].width

    def step(state: TrainState, batch, ids=None, generator=None):
        if ids is None:
            ids = draw_sample_ids(generator, h * w, cfg.num_photo_samples)
        with torch.no_grad():
            return loss_fn(state.params, batch, ids)

    return step


class ScalarLogger:
    """JSONL scalar logger: one line per step with tag, step and values."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._fh = open(path, "a") if path else None

    def log(self, step: int, tag: str, values: dict):
        if self._fh is None:
            return
        import json

        rec = {"step": int(step), "tag": tag}
        rec.update({k: float(v) for k, v in values.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ImageLogger:
    """PNG image logger: one normalized grayscale PNG per (step, tag)
    under ``dirpath``."""

    def __init__(self, dirpath: Optional[str]):
        self.dir = dirpath
        if dirpath:
            os.makedirs(dirpath, exist_ok=True)

    def log(self, step: int, tag: str, img):
        if not self.dir:
            return
        from PIL import Image

        a = np.asarray(img, np.float32)
        if a.ndim == 3:  # [C, H, W] -> first channel
            a = a[0]
        lo, hi = float(a.min()), float(a.max())
        a = (a - lo) / max(hi - lo, 1e-9)
        Image.fromarray((255 * a).astype(np.uint8)).save(os.path.join(self.dir, f"{step:06d}_{tag}.png"))


def train(
    triplets,
    cam,
    depth_cfg,
    feat_cfg,
    disc_cfg,
    cfg: TrainConfig,
    num_epochs: int = 2,
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    log_path: Optional[str] = None,
    image_log_dir: Optional[str] = None,
    plateau_patience: int = 0,
    plateau_min_rel_improve: float = 0.01,
    time_budget_s: float = 0.0,
    device=None,
):
    """Epoch driver with the two-phase curriculum and a held-out evaluation
    split -> (state, history): the last eval_fraction of the triplets is
    never trained on; after every epoch the eval battery runs on it and its
    scalars are logged.

    ``time_budget_s`` > 0 stops at the first epoch boundary past the
    budget. ``plateau_patience`` > 0 ends training once the best eval loss
    has not improved by ``plateau_min_rel_improve`` (relative) for that
    many epochs; tracking is per phase, a separate-phase plateau with a
    joint phase ahead jumps to the joint phase from the phase's best
    snapshot, and on return the final phase's best snapshot replaces the
    last state (and is checkpointed).

    Networks come from torch.Generator().manual_seed(seed); the sample ids
    from a second generator seeded seed + 1."""
    dev = resolve_device(device)
    cam_pyr = CameraPyramid.build(cam, cfg.pyramid_levels)
    state = init_state(torch.Generator().manual_seed(seed), depth_cfg, feat_cfg, disc_cfg, cfg, dev)
    ids_gen = torch.Generator().manual_seed(seed + 1)
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state = load_checkpoint(checkpoint_path, state)

    n_eval = max(1, int(len(triplets) * cfg.eval_fraction)) if len(triplets) > 1 else 0
    train_set = triplets[: len(triplets) - n_eval]
    eval_set = triplets[len(triplets) - n_eval:]
    batches_train = [triplet_to_batch(t, cam, dev) for t in train_set]
    batches_eval = [triplet_to_batch(t, cam, dev) for t in eval_set]

    steps = {}
    logger = ScalarLogger(log_path)
    imlog = ImageLogger(image_log_dir)
    history = []
    best_eval = float("inf")
    best_state = None
    stale = 0
    last_joint = None
    t_start = time.time()
    try:
        epoch = state.epoch
        while epoch < num_epochs:
            joint = epoch >= cfg.separate_train_epoch
            if joint is not last_joint:
                # eval-loss scales differ between the phases: plateau
                # tracking and the best snapshot restart per phase
                best_eval = float("inf")
                best_state = None
                stale = 0
                last_joint = joint
            if ("train", joint) not in steps:
                factor = cfg.joint_lr_factor if joint else 1.0
                steps[("train", joint)] = make_train_step(cam_pyr, cfg, joint, factor)
                steps[("eval", joint)] = make_eval_step(cam_pyr, cfg, joint)
            warm = 1.0
            if joint and cfg.ba_warmup_epochs > 0:
                warm = min(1.0, (epoch - cfg.separate_train_epoch + 1) / cfg.ba_warmup_epochs)
            warm = float(np.float32(warm))
            for batch in batches_train:
                state, loss, aux = steps[("train", joint)](state, batch, generator=ids_gen, warm=warm)
                logger.log(state.step, "train", dict(loss=loss, **aux))
            ev = {}
            for bi, batch in enumerate(batches_eval):
                loss, aux = steps[("eval", joint)](state, batch, generator=ids_gen)
                pred_depth = aux.pop("pred_depth").cpu().numpy()
                if bi == 0:
                    # depth panels of the first eval sample
                    gt = batch["depth_src"].cpu().numpy()
                    imlog.log(state.step, "pred_depth", pred_depth)
                    imlog.log(state.step, "gt_depth", gt)
                    imlog.log(state.step, "depth_err",
                              np.abs(pred_depth - gt) * batch["mask"].cpu().numpy())
                for k, v in dict(loss=loss, **aux).items():
                    ev.setdefault(k, []).append(float(v))
            ev_mean = {k: float(np.mean(v)) for k, v in ev.items()}
            logger.log(state.step, "eval", ev_mean)
            history.append(dict(epoch=epoch, joint=joint, eval=ev_mean))
            state = state._replace(epoch=epoch + 1)
            if checkpoint_path:
                save_checkpoint(checkpoint_path, state)
            if plateau_patience > 0 and "loss" in ev_mean:
                if ev_mean["loss"] < best_eval * (1.0 - plateau_min_rel_improve):
                    best_eval = ev_mean["loss"]
                    best_state = clone_state(state)
                    history[-1]["snapshotted"] = True
                    stale = 0
                else:
                    stale += 1
                    if stale >= plateau_patience:
                        if not joint and cfg.separate_train_epoch < num_epochs:
                            # enter the joint phase from the separate
                            # phase's best snapshot instead of ending
                            if best_state is not None:
                                state = best_state
                            epoch = cfg.separate_train_epoch
                            state = state._replace(epoch=epoch)
                            continue
                        break
            if time_budget_s > 0 and time.time() - t_start > time_budget_s:
                break
            epoch += 1
    finally:
        logger.close()
    # hand back (and persist) the best-eval snapshot of the final phase
    if best_state is not None:
        state = best_state
        if checkpoint_path:
            save_checkpoint(checkpoint_path, state)
    return state, history


def triplet_to_batch(t: Triplet, cam, device=None) -> dict:
    """A Triplet as tensors on ``device``, with the GT rigid flow for the
    joint phase (its mask keeps positive-depth, in-bounds pixels), the
    initial pose's tangent and the input-res video mask."""
    from ..geometry import se3 as se3m

    dev = resolve_device(device)
    h, w = t.depth_src.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = np.maximum(t.depth_src, 1e-6)
    x3 = (xs - cam.cx) / cam.fx * z
    y3 = (ys - cam.cy) / cam.fy * z
    pts = np.stack([x3, y3, z, np.ones_like(z)], 0).reshape(4, -1)
    warped = t.rel_pose_close_src @ pts
    u = warped[0] / np.maximum(warped[2], 1e-6) * cam.fx + cam.cx
    v = warped[1] / np.maximum(warped[2], 1e-6) * cam.fy + cam.cy
    gt_flow = np.stack([u.reshape(h, w) - xs, v.reshape(h, w) - ys], 0).astype(np.float32)
    flow_mask = (
        (warped[2] > 1e-6) & (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    ).reshape(h, w).astype(np.float32)

    init_rel = t.init_rel_pose if t.init_rel_pose is not None else t.rel_pose_close_src
    tau_init = se3m.se3_log(se3m.SE3(
        rot=torch.tensor(np.asarray(init_rel[:3, :3], np.float32)),
        trans=torch.tensor(np.asarray(init_rel[:3, 3], np.float32)),
    ))
    no_match = t.no_match_src if t.no_match_src is not None else t.keypoints_src
    # input-res video mask (nearest upsample of the output-res mask)
    h_in, w_in = t.image_src.shape[1:]
    yi = (np.arange(h_in) * h / h_in).astype(int)
    xi = (np.arange(w_in) * w / w_in).astype(int)
    mask_in = t.mask[np.ix_(yi, xi)]
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    i64 = lambda a: torch.tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
    return dict(
        mask_in=f32(mask_in),
        image_src=f32(t.image_src),
        image_close=f32(t.image_close),
        image_far=f32(t.image_far),
        mask=f32(t.mask),
        depth_src=f32(t.depth_src),
        depth_close=f32(t.depth_close),
        keypoints_src=i64(t.keypoints_src),
        gt_match_close=i64(t.gt_match_close),
        no_match_src=i64(no_match),
        no_match_valid=f32(t.no_match_valid if t.no_match_src is not None else 0.0),
        far_valid=f32(1.0 if t.far_overlap_valid else 0.0),
        tau_init=tau_init.to(dev),
        gt_flow=f32(gt_flow),
        flow_mask=f32(flow_mask),
    )


def save_checkpoint(path: str, state: TrainState):
    """npz checkpoint in the JAX package's format: arr_i in jax.tree.flatten
    order of the params dict, then step and epoch."""
    leaves = [t.detach().cpu().numpy() for _, t in param_leaves(state.params)]
    np.savez(path, *leaves, step=int(state.step), epoch=int(state.epoch))


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """A copy of ``state`` with the checkpoint's params, step and epoch. The
    file holds no optimizer state: the momentum and the schedule's count
    stay those of ``state``, as in the JAX package."""
    data = np.load(path)
    out = clone_state(state)
    with torch.no_grad():
        for i, (name, t) in enumerate(param_leaves(out.params)):
            arr = data[f"arr_{i}"]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{path}: arr_{i} ({name}) has shape {arr.shape}, want {tuple(t.shape)}")
            t.copy_(torch.as_tensor(arr).to(t.dtype))
    return out._replace(step=int(data["step"]), epoch=int(data["epoch"]))
