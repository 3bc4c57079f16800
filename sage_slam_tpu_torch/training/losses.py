"""Training losses (port of sage_slam_tpu/training/losses.py).

* scale-invariant log depth loss,
* basis decorrelation (masked ZNCC of the basis channels),
* normalized masked L2 flow loss,
* descriptor response-map losses with a learnable response sigma
  (``rr_loss``, ``no_match_loss``) and the soft expected match locations,
* the triplet loss on soft per-channel descriptor CDF histograms.

Every function takes a leading batch axis where the JAX one does.
"""

from __future__ import annotations

import torch


def scale_invariant_depth_loss(gt, pred, mask, epsilon=1.0e-3):
    """[B, H, W] each -> scalar."""
    ratio = torch.log(torch.clamp(mask * pred, min=epsilon)) - torch.log(
        torch.clamp(mask * gt, min=epsilon)
    )
    wsum = torch.sum(mask, dim=(1, 2))
    loss1 = torch.sum(ratio**2, dim=(1, 2)) / wsum
    s2 = torch.sum(ratio, dim=(1, 2))
    loss2 = (s2 * s2) / (wsum * wsum)
    return torch.mean(loss1 + loss2)


def basis_decorrelation_loss(basis, mask):
    """basis [B, C, H, W], mask [B, 1, H, W] -> scalar."""
    b, c, h, w = basis.shape
    mean = torch.mean(basis, dim=(2, 3), keepdim=True)
    centered = (basis - mean).reshape(b, c, h * w)
    m = mask.reshape(b, 1, h * w)
    cov = (centered * m) @ centered.transpose(-1, -2) / torch.sum(m, dim=-1)[..., None]
    cov = torch.clamp(cov, min=1.0e-10)
    sigma = torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
    zncc = cov / (sigma[:, :, None] * sigma[:, None, :])
    return torch.mean(zncc**2)


def normalized_masked_l2_flow_loss(gt_flow, pred_flow, mask, eps=1.0e-2):
    """[B, 2, H, W] flows, [B, 1, H, W] mask -> scalar."""
    b, _, h, w = gt_flow.shape
    scale = torch.tensor([1.0 / w, 1.0 / h], dtype=gt_flow.dtype,
                         device=gt_flow.device).reshape(1, 2, 1, 1)
    g = gt_flow * scale
    p = pred_flow * scale
    msum = torch.sum(mask, dim=(1, 2, 3))
    mean_mag = (
        0.5 * (
            torch.sum(mask * g**2, dim=(1, 2, 3)) / (1.0 + msum)
            + torch.sum(mask * p**2, dim=(1, 2, 3)) / (1.0 + msum)
        )
        + eps
    ).detach()
    loss = torch.sum(mask * (g - p) ** 2, dim=(1, 2, 3)) / (mean_mag * (msum + 1.0))
    return torch.mean(loss)


def triplet_histogram_loss(src_cdf, tgt_cdf, far_cdf, margin=0.2):
    """[K, C] CDF histograms per channel -> scalar."""
    pos = torch.mean((src_cdf - tgt_cdf) ** 2, dim=0)
    neg = torch.mean((src_cdf - far_cdf) ** 2, dim=0)
    return torch.mean(torch.relu(pos - neg + margin))


def _response_map(desc_src_at_kp, desc_tgt_flat, sigma):
    """[M, C] keypoint descriptors vs [HW, C] target -> softmax response
    [M, HW], a shift-invariant softmax of -sigma * d2 (the naive
    exp / sum underflows to 0/0 once the learnt sigma grows)."""
    d2 = torch.sum((desc_src_at_kp[:, None, :] - desc_tgt_flat[None]) ** 2, dim=-1)
    return torch.softmax(-sigma * d2, dim=-1)


def rr_loss(desc_src_flat, desc_tgt_flat, src_loc1d, gt_tgt_loc1d, sigma, loss_eps=1.0e-10):
    """Response-at-the-right-place loss: [HW, C] maps, [M] ids -> scalar."""
    kp = desc_src_flat[src_loc1d.long()]
    resp = _response_map(kp, desc_tgt_flat, sigma)  # [M, HW]
    sampled = torch.gather(resp, 1, gt_tgt_loc1d.long()[:, None])
    return torch.mean(-torch.log(loss_eps + sampled))


def no_match_loss(desc_src_flat, desc_tgt_flat, no_match_loc1d, sigma):
    """Pushes the responses of unmatched keypoints toward uniform."""
    hw = desc_tgt_flat.shape[0]
    kp = desc_src_flat[no_match_loc1d.long()]
    resp = _response_map(kp, desc_tgt_flat, sigma)
    return torch.mean(torch.sum((1.0 / hw - resp) ** 2, dim=-1))


def soft_matching_locations(desc_src_flat, desc_tgt_flat, src_loc1d, sigma, width):
    """Differentiable expected match locations [M, 2] (x, y)."""
    hw = desc_tgt_flat.shape[0]
    kp = desc_src_flat[src_loc1d.long()]
    resp = _response_map(kp, desc_tgt_flat, sigma)  # [M, HW]
    pix = torch.arange(hw, dtype=resp.dtype, device=resp.device)
    xs = torch.remainder(pix, float(width))
    ys = torch.floor(pix / width)
    return torch.stack([resp @ xs, resp @ ys], dim=-1)


def descriptor_cdf_histogram(desc_at_kp, num_bins=32, lo=-1.0, hi=1.0, tau=50.0):
    """Soft per-channel CDF histogram of descriptor values [M, C] ->
    [num_bins, C]."""
    edges = torch.linspace(lo, hi, num_bins, dtype=desc_at_kp.dtype, device=desc_at_kp.device)
    ind = torch.sigmoid(tau * (edges[:, None, None] - desc_at_kp[None]))
    return torch.mean(ind, dim=1)
