"""What the program's mapper derives from an image, recomputed plainly: a
frozen copy of ``Mapper.build_frame`` (networks, feature pyramid, seeded
photometric samples and the keyframe's features at them), the first
keyframe's median-depth scale (``init_one_frame``) and the depth-scale
correction of a new keyframe (``correct_depth_scale``)."""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import torch

from .slam.config import SlamConfig, _from_dict
from .slam.geometry import interp
from .slam.geometry.camera import CameraPyramid, PinholeCamera
from .slam.models import depth_network, feature_network
from .slam.ops.depth import decode_depth
from .slam.ops.pyramid import gaussian_pyramid_with_grad, mask_pyramid


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 with TF32 off (the configuration's precision) or, for the
    control, TF32 on in matmuls and cuDNN convolutions."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def sample_seed(timestamp: float) -> int:
    return int(timestamp * 1e6) & 0x7FFFFFFF


def median(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


class Frames:
    """The frame builder of one configuration on ``device``."""

    def __init__(self, config: dict, intrinsics, mask_out, mask_in, depth_state: dict,
                 device):
        self.cfg = _from_dict(SlamConfig, config)
        self.device = dev = torch.device(device)
        h, w = mask_out.shape
        fx, fy, cx, cy = intrinsics
        self.cam = PinholeCamera(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h)
        self.cam_pyr = CameraPyramid.build(self.cam, self.cfg.pyramid_levels)
        self.mask = torch.as_tensor(np.asarray(mask_out, np.float32), device=dev)
        self.mask_flat = self.mask.reshape(-1)
        self.mask_in = torch.as_tensor(np.asarray(mask_in, np.float32), device=dev)
        valid = np.flatnonzero(np.asarray(mask_out, np.float32).reshape(-1) > 0.5)
        self.valid_loc1d = torch.as_tensor(valid.astype(np.int64), device=dev)
        self.num_samples = min(self.cfg.mapper.pho_num_samples, len(valid))
        self.masks_pyr = mask_pyramid(self.mask, self.cam_pyr.levels)
        nets = config["networks"]
        self.depth_net = depth_network.DepthNetwork(
            depth_network.DepthNetConfig(**net_kwargs(nets["depth"]))).to(dev)
        with torch.no_grad():
            for name, p in self.depth_net.named_parameters():
                p.copy_(depth_state[name])
        self.feat_net = feature_network.FeatureNetwork(
            feature_network.FeatureNetConfig(**net_kwargs(nets["feature"]))).to(dev)

    def sample_locations(self, timestamp: float) -> torch.Tensor:
        gen = torch.Generator().manual_seed(sample_seed(timestamp))
        perm = torch.randperm(self.valid_loc1d.shape[0], generator=gen)[: self.num_samples]
        return self.valid_loc1d[perm.to(self.device)]

    def build(self, timestamp: float, image: torch.Tensor) -> SimpleNamespace:
        """Mapper.build_frame's FrameData fields for ``image`` [3, H, W]."""
        image = image.to(self.device, torch.float32)
        loc1d = self.sample_locations(timestamp)
        in_mask = self.mask_in[None]
        with torch.no_grad():
            fmap, _ = feature_network.apply(self.feat_net, image, in_mask)
            bias, basis = depth_network.apply(self.depth_net, image, in_mask)
        cs = basis.shape[0]
        bias_flat = bias.reshape(-1)
        jac_flat = basis.reshape(cs, -1).T.contiguous()
        feat_pyr, grad_pyr = gaussian_pyramid_with_grad(fmap, self.masks_pyr, self.cam_pyr.levels)
        return SimpleNamespace(
            timestamp=timestamp, bias_flat=bias_flat, jac_flat=jac_flat, feat_pyr=feat_pyr,
            grad_pyr=grad_pyr, loc1d=loc1d,
            homo=interp.locations_1d_to_homo(loc1d, self.cam_pyr[0]),
            avg_sq_bias=torch.sum((bias_flat * self.mask_flat) ** 2) / torch.sum(self.mask_flat),
            code=torch.zeros(self.cfg.code_size, device=self.device), scale=1.0,
            src_feats=self.source_features(feat_pyr, loc1d),
        )

    def source_features(self, feat_pyr: torch.Tensor, loc1d: torch.Tensor) -> torch.Tensor:
        """A frame's own features [C, T] at its photometric points, every
        level -> [L, N, C]."""
        cam0 = self.cam_pyr[0]
        x0, y0 = interp.locations_1d_to_2d(loc1d, cam0.width)
        out = []
        for lvl in range(self.cam_pyr.levels):
            cam = self.cam_pyr[lvl]
            ul, vl = interp.level_coords(x0, y0, cam.fx / cam0.fx, cam.fy / cam0.fy)
            out.append(interp.bilinear_flat(feat_pyr, ul, vl, cam.width, cam.height,
                                            self.cam_pyr.level_offsets[lvl]).T)
        return torch.stack(out, dim=0)

    def depth(self, fr, code=None, scale=None) -> torch.Tensor:
        """The frame's decoded depth map [HW]."""
        return decode_depth(fr.bias_flat, fr.jac_flat, fr.code if code is None else code,
                            fr.scale if scale is None else scale)

    def init_scale(self, fr) -> float:
        """init_one_frame: the scale that sets the median depth over the mask to 1."""
        depth = fr.scale * (fr.bias_flat[self.valid_loc1d] + fr.jac_flat[self.valid_loc1d] @ fr.code)
        return fr.scale / max(abs(float(median(depth))), 1e-6)

    def correct_scale(self, fr, pose: tuple, ref_depth: torch.Tensor, ref_pose: tuple) -> float:
        """correct_depth_scale: the median over the valid warped points of
        z in the new frame over its unscaled depth bias there; poses are
        (rot, trans), world from camera."""
        cam = self.cam_pyr[0]
        rel_rot = pose[0].T @ ref_pose[0]
        rel_trans = pose[0].T @ (ref_pose[1] - pose[1])
        d0 = ref_depth[self.valid_loc1d]
        homo0 = interp.locations_1d_to_homo(self.valid_loc1d, cam)
        x1 = d0[:, None] * (homo0 @ rel_rot.T) + rel_trans
        pos = x1[:, 2] > self.cfg.mapper.dpt_eps
        u = x1[:, 0] / x1[:, 2] * cam.fx + cam.cx
        v = x1[:, 1] / x1[:, 2] * cam.fy + cam.cy
        bias1 = interp.bilinear_flat(fr.bias_flat[None], u, v, cam.width, cam.height)[0]
        within = interp.nearest_flat(self.mask_flat, u, v, cam.width, cam.height)
        valid = (within > 0.5) & pos & (torch.abs(bias1) > 1e-8)
        ratios = torch.where(valid, x1[:, 2] / torch.where(valid, bias1, torch.ones_like(bias1)),
                             torch.full_like(bias1, float("nan")))
        r = ratios.cpu().numpy()
        r = r[np.isfinite(r)]
        return fr.scale if len(r) == 0 else float(np.median(r))


def net_kwargs(d: dict) -> dict:
    """A configuration's JSON networks group as config keyword arguments
    (lists as tuples)."""
    return {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list) else v)
            for k, v in d.items()}
