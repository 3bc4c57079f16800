"""Training dataset — (src, close, far) frame triplets with supervision.

Port of sage_slam_tpu/training/dataset.py (host numpy; the port keeps its
own copy). Mirrors representation/datasets/endoscopy_dataset.py: each sample
provides images, masks, GT depths, relative poses, FAST keypoint
locations with match / no-match splits, a perturbed initial pose, and
rotation-augmentation variants. Sources:

* FusionHDF5Dataset — the reference's fusion_data.hdf5 sequences
  (endoscopy_dataset.py:212-527): per-sequence HDF5 files discovered by
  pattern, filtered by patient (bag) id, sampled with sqrt(frame-count)
  probability, with median-depth scale normalization, distance-ranked
  close/far frame selection, overlap-constrained resampling, FAST
  keypoints, pose perturbation, and rotation augmentation,
* NpzSequenceDataset — the same pipeline over sequences stored as .npz
  (color [N,H,W,3], depth [N,H,W], mask [H,W], intrinsics [4],
  poses [N,4,4] world-from-cam),
* SyntheticTripletDataset — procedural fixture used by the tests.

This is host-side (numpy/cv2) data preparation — the device path only
ever sees the fixed-shape arrays packed into `Triplet`. Where cv2 does not
import, resizes are nearest-neighbour, erosion is a numpy 3x3 min, and the
keypoints are mask-interior image-gradient maxima (the JAX package's own
fallback): the triplets then differ from the cv2 ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

try:  # host-side feature detection / image ops (not on the device path)
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover - cv2 may be absent
    cv2 = None
    _HAS_CV2 = False

from ..geometry.camera import PinholeCamera


@dataclasses.dataclass(frozen=True)
class TripletConfig:
    """Knobs of the reference pipeline with the defaults of
    representation/configs/training.json:105-137."""

    num_keypoints: int = 128  # lm_reproj_nsamples role (256 in ref)
    frame_interval: int = 60
    far_frame_interval: int = 60
    tgt_overlap_ratio: float = 0.6
    far_overlap_ratio: float = 0.5
    random_overlap_ratio: float = 0.4
    max_rot_dir_rad: float = 0.4
    max_rot_angle_rad: float = 0.4
    max_trans_dir_rad: float = 0.4
    max_trans_dist_offset: float = 0.5
    aug_rot_limit: float = 0.78  # radians
    fast_threshold: int = 1
    depth_eps: float = 1.0e-2
    max_resample: int = 20  # bound the reference's `while True` loop
    use_rotation_aug: bool = True
    scale_normalize: bool = True  # median-depth scale (dataset.py:314-320)


@dataclasses.dataclass
class Triplet:
    image_src: np.ndarray  # [3, H, W]
    image_close: np.ndarray
    image_far: np.ndarray
    mask: np.ndarray  # [h, w] output res
    depth_src: np.ndarray  # [h, w] GT depth at output res
    depth_close: np.ndarray
    rel_pose_close_src: np.ndarray  # [4, 4] T_close_from_src
    keypoints_src: np.ndarray  # [K] 1d pixel ids (output res)
    gt_match_close: np.ndarray  # [K] 1d pixel ids in close frame
    camera: PinholeCamera  # output-res intrinsics
    # --- endoscopy_dataset.py parity fields ---
    no_match_src: Optional[np.ndarray] = None  # [K] 1d src ids w/o match
    no_match_valid: float = 0.0  # weight for the no-match set
    init_rel_pose: Optional[np.ndarray] = None  # [4,4] perturbed init
    init_overlap_ratio: float = 1.0
    far_overlap_valid: bool = True
    rot_angles: Optional[np.ndarray] = None  # [3] src/close/far aug rads


# ---------------------------------------------------------------------------
# host-side image ops


def _resize(img: np.ndarray, hw, nearest: bool = False) -> np.ndarray:
    """cv2.resize wrapper (endoscopy_dataset.py:144-147) with a numpy
    nearest fallback when cv2 is unavailable."""
    h, w = hw
    if img.shape[:2] == (h, w):
        return np.asarray(img)
    if _HAS_CV2:
        interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
        return cv2.resize(np.asarray(img), dsize=(w, h), interpolation=interp)
    ys = (np.arange(h) * (img.shape[0] / h)).astype(np.int64)
    xs = (np.arange(w) * (img.shape[1] / w)).astype(np.int64)
    return np.asarray(img)[ys][:, xs]


def _erode(mask: np.ndarray, iterations: int) -> np.ndarray:
    """3x3 binary erosion (endoscopy_dataset.py:64-66)."""
    if _HAS_CV2:
        kernel = np.ones((3, 3), np.uint8)
        return cv2.erode(mask.astype(np.uint8), kernel, iterations=iterations)
    m = mask.astype(bool)
    for _ in range(iterations):
        p = np.pad(m, 1, mode="constant")
        m = np.ones_like(m)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                m &= p[1 + dy : 1 + dy + mask.shape[0], 1 + dx : 1 + dx + mask.shape[1]]
    return m.astype(np.uint8)


def fast_keypoints_1d(
    image_chw: np.ndarray,
    mask: np.ndarray,
    out_hw,
    threshold: int = 1,
) -> np.ndarray:
    """FAST-9/16 keypoints on the fine image, mapped to unique coarse
    1d ids (endoscopy_dataset.py:48-49, 53-83): detect on the fine
    grayscale inside the 6-iteration-eroded fine mask, divide by the
    fine/coarse ratio, round, unique. Falls back to mask-interior
    image-gradient maxima without cv2."""
    fh, fw = image_chw.shape[1:]
    oh, ow = out_hw
    fine_mask = _resize(
        (mask > 0.5).astype(np.uint8) * 255, (fh, fw), nearest=True
    )
    fine_mask = _erode(fine_mask, 6)
    gray = (255.0 * image_chw.mean(axis=0)).clip(0, 255).astype(np.uint8)
    ratio = fh / oh
    if _HAS_CV2:
        det = cv2.FastFeatureDetector_create(
            threshold=int(threshold),
            nonmaxSuppression=True,
            type=cv2.FAST_FEATURE_DETECTOR_TYPE_9_16,
        )
        kps = det.detect(gray, (fine_mask > 0).astype(np.uint8) * 255)
        if not kps:
            return np.zeros((0,), np.int64)
        ys = np.round(np.asarray([k.pt[1] for k in kps]) / ratio)
        xs = np.round(np.asarray([k.pt[0] for k in kps]) / ratio)
    else:
        g = gray.astype(np.float32)
        score = np.abs(np.gradient(g, axis=0)) + np.abs(np.gradient(g, axis=1))
        score = score * (fine_mask > 0)
        flat = np.argsort(score.reshape(-1))[::-1][: 4 * oh * ow // 16]
        ys = np.round((flat // fw) / ratio)
        xs = np.round((flat % fw) / ratio)
    ys = np.clip(ys, 0, oh - 1)
    xs = np.clip(xs, 0, ow - 1)
    return np.unique((ys * ow + xs).astype(np.int64))


def _rotate(img: np.ndarray, angle_rad: float, nearest: bool) -> np.ndarray:
    """Rotate [C,H,W] or [H,W] about the image center with zero padding
    (utils/processing.py:134-157 images_warping role)."""
    chw = img.ndim == 3
    h, w = img.shape[-2:]
    hw = img if not chw else img.transpose(1, 2, 0)
    if _HAS_CV2:
        deg = float(np.degrees(angle_rad))
        m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), deg, 1.0)
        flags = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
        out = cv2.warpAffine(
            np.ascontiguousarray(hw), m, (w, h), flags=flags,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0,
        )
    else:
        c, s = np.cos(angle_rad), np.sin(angle_rad)
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        xc, yc = xx - (w - 1) / 2, yy - (h - 1) / 2
        sx = np.round(c * xc + s * yc + (w - 1) / 2).astype(np.int64)
        sy = np.round(-s * xc + c * yc + (h - 1) / 2).astype(np.int64)
        inb = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
        out = np.zeros_like(hw)
        out[inb] = hw[np.clip(sy, 0, h - 1), np.clip(sx, 0, w - 1)][inb]
    if out.ndim == 2 and hw.ndim == 3:
        out = out[..., None]
    return out.transpose(2, 0, 1) if chw else out


def rotation_augment(image_chw, mask, angle_rad: float):
    """diff_rotation_aug ∘ diff_rotation_aug_reverse
    (endoscopy_dataset.py:152-188): rotate by `angle_rad`, rotate back.
    The round trip keeps the scene geometry (so GT poses/flow stay
    valid) while injecting the interpolation blur and corner loss the
    reference's `crop_*` training inputs see; the validity mask follows
    with nearest interpolation."""
    aug_img = _rotate(image_chw, angle_rad, nearest=False)
    aug_mask = _rotate((mask > 0.5).astype(np.float32), angle_rad, nearest=True)
    crop_img = _rotate(aug_img, -angle_rad, nearest=False)
    crop_mask = _rotate(aug_mask, -angle_rad, nearest=True)
    return crop_img, crop_mask * (mask > 0.5)


# ---------------------------------------------------------------------------
# geometry helpers (numpy mirrors of utils/processing.py)


def _project_points(pts_1d, depth, rel, cam, depth_eps):
    """Warp source 1d pixel ids into the target frame. Returns target
    (u, v) float coords and the positive-depth mask."""
    w = cam.width
    xs = (pts_1d % w).astype(np.float64)
    ys = (pts_1d // w).astype(np.float64)
    z = depth.reshape(-1)[pts_1d]
    x3 = (xs - cam.cx) / cam.fx * z
    y3 = (ys - cam.cy) / cam.fy * z
    p = np.stack([x3, y3, z, np.ones_like(z)], 0)
    q = rel @ p
    pos = q[2] > depth_eps
    zq = np.maximum(q[2], depth_eps)
    u = q[0] / zq * cam.fx + cam.cx
    v = q[1] / zq * cam.fy + cam.cy
    return u, v, pos


def compute_scene_overlap(rel, depth_src, src_mask, tgt_mask, cam, depth_eps=1e-2):
    """(point_within_mask_ratio, warp_area_ratio) — numpy mirror of
    utils/processing.py:361-428. Note the reference measures hull size
    with scipy ConvexHull.area, which for 2-D hulls is the PERIMETER;
    we keep that semantics so the overlap thresholds transfer."""
    ids = np.flatnonzero(src_mask.reshape(-1) >= 0.9)
    if ids.size < 3:
        return 0.0, 0.0
    u, v, pos = _project_points(ids, depth_src, rel, cam, depth_eps)
    ui = np.clip(np.round(u), 0, cam.width - 1).astype(np.int64)
    vi = np.clip(np.round(v), 0, cam.height - 1).astype(np.int64)
    inb = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    tgt_ok = tgt_mask.reshape(-1)[vi * cam.width + ui] > 0.5
    point_ratio = float(np.mean(tgt_ok & inb & pos))
    try:
        from scipy.spatial import ConvexHull

        src_pts = np.stack([ids // cam.width, ids % cam.width], 1).astype(
            np.float64
        )
        tgt_pts = np.stack([v, u], 1)
        ori = ConvexHull(src_pts).area
        warped = ConvexHull(tgt_pts).area
        area_ratio = float(min(warped / max(ori, 1e-9), 1.0))
    except Exception:
        area_ratio = point_ratio
    return point_ratio, area_ratio


def split_match_candidates(kps, depth_src, rel, cam, tgt_mask, depth_eps=1e-2):
    """extract_keypoints split (endoscopy_dataset.py:130-133): positive
    target depth AND in-target-mask → match candidates (with their
    rounded target 1d ids); positive depth but OUT of the target mask →
    no-match candidates."""
    if kps.size == 0:
        e = np.zeros((0,), np.int64)
        return e, e, e
    u, v, pos = _project_points(kps, depth_src, rel, cam, depth_eps)
    ui = np.clip(np.round(u), 0, cam.width - 1).astype(np.int64)
    vi = np.clip(np.round(v), 0, cam.height - 1).astype(np.int64)
    inb = (u >= -0.5) & (u < cam.width - 0.5) & (v >= -0.5) & (v < cam.height - 0.5)
    tgt_ids = vi * cam.width + ui
    valid = tgt_mask.reshape(-1)[tgt_ids] > 0.5
    match = pos & inb & valid
    no_match = pos & ~(inb & valid)
    return kps[match], tgt_ids[match], kps[no_match]


def _perp_direction(base_dir, max_dir_rad, rng):
    """Shared tail of generate_random_rotation/translation
    (utils/processing.py:303-317): a unit vector obtained by scaling a
    perpendicular of `base_dir` by tan(U[0,1)*max_dir_rad) and
    renormalizing."""
    while True:
        t = 2.0 * rng.random(3) - 1.0
        n = np.linalg.norm(t)
        if n > 1e-6 and np.sum((base_dir - t / n) ** 2) > 1e-12:
            t = t / n
            break
    perp = np.cross(base_dir, t)
    perp = perp / max(np.linalg.norm(perp), 1e-12)
    d = np.tan(rng.random() * max_dir_rad) * perp
    return d / max(np.linalg.norm(d), 1e-12)


def _rotvec_to_matrix(v):
    angle = np.linalg.norm(v)
    if angle < 1e-12:
        return np.eye(3)
    axis = v / angle
    kx = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * (kx @ kx)


def _matrix_to_rotvec(r):
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    angle = np.arccos(cos)
    if angle < 1e-8:
        return np.zeros(3)
    axis = np.array(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]
    ) / (2.0 * np.sin(angle))
    return angle * axis


def perturb_pose(rel, cfg: TripletConfig, rng) -> np.ndarray:
    """Random initial pose around the GT relative pose — numpy mirror of
    generate_random_rotation/translation (utils/processing.py:291-358)
    and their composition (endoscopy_dataset.py:446-458):
    R' = R_rand R_gt, t' = R' t_gt + t_rand."""
    r_gt = rel[:3, :3]
    t_gt = rel[:3, 3]

    gt_rotvec = _matrix_to_rotvec(r_gt)
    ang = np.linalg.norm(gt_rotvec)
    if ang > 1e-9:
        rot_dir = gt_rotvec / ang
    else:
        rot_dir = 2.0 * rng.random(3) - 1.0
        rot_dir = rot_dir / np.linalg.norm(rot_dir)
    rand_dir = _perp_direction(rot_dir, cfg.max_rot_dir_rad, rng)
    rand_angle = (2.0 * rng.random() - 1.0) * cfg.max_rot_angle_rad
    r_rand = _rotvec_to_matrix(rand_angle * rand_dir)

    dist = np.linalg.norm(t_gt)
    if dist > 1e-9:
        trans_dir = t_gt / dist
    else:
        trans_dir = 2.0 * rng.random(3) - 1.0
        trans_dir = trans_dir / np.linalg.norm(trans_dir)
    rand_tdir = _perp_direction(trans_dir, cfg.max_trans_dir_rad, rng)
    t_rand = dist + rng.random() * cfg.max_trans_dist_offset * rand_tdir

    out = np.eye(4)
    out[:3, :3] = r_rand @ r_gt
    out[:3, 3] = out[:3, :3] @ t_gt + t_rand
    return out


def generate_far_close_idx(src, n, translations, cfg: TripletConfig, rng):
    """Distance-ranked close/far selection
    (endoscopy_dataset.py:190-210): three candidates — one within
    ±frame_interval, one ≤ src-far_interval, one ≥ src+far_interval —
    ranked by squared camera-center distance; min → close, max → far."""
    c1 = int(
        rng.integers(
            max(0, src - cfg.frame_interval),
            min(n, src + cfg.frame_interval + 1),
        )
    )
    c2 = int(rng.integers(0, max(1, src - cfg.far_frame_interval)))
    c3 = int(
        rng.integers(min(n - 1, src + cfg.far_frame_interval), n)
    )
    cands = [c1, c2, c3]
    d = [float(np.sum((translations[i] - translations[src]) ** 2)) for i in cands]
    return cands[int(np.argmin(d))], cands[int(np.argmax(d))]


# ---------------------------------------------------------------------------
# shared triplet builder


class _SequenceSource:
    """Adapter interface: per-frame accessors at native resolution."""

    n_frames: int

    def color(self, i) -> np.ndarray:  # [H, W, 3] float or uint8
        raise NotImplementedError

    def depth(self, i) -> np.ndarray:  # [H, W]
        raise NotImplementedError

    def depth_mask(self, i) -> Optional[np.ndarray]:  # [H, W] or None
        raise NotImplementedError

    def video_mask(self) -> np.ndarray:  # [H, W]
        raise NotImplementedError

    def pose(self, i) -> np.ndarray:  # [4, 4] world-from-cam
        raise NotImplementedError

    def intrinsics(self) -> np.ndarray:  # [fx, fy, cx, cy] native res
        raise NotImplementedError


def _build_triplet(
    seq: _SequenceSource,
    out_hw,
    in_hw,
    cfg: TripletConfig,
    rng,
) -> Triplet:
    """One reference __getitem__ (endoscopy_dataset.py:237-527): triplet
    selection, scale normalization, rotation augmentation, overlap
    gates with resampling, FAST match/no-match split, pose perturbation."""
    n = seq.n_frames
    oh, ow = out_hw
    nh, nw = seq.video_mask().shape
    fx, fy, cx, cy = np.asarray(seq.intrinsics(), np.float64)
    cam = PinholeCamera(
        fx=fx * ow / nw, fy=fy * oh / nh,
        cx=cx * ow / nw, cy=cy * oh / nh, width=ow, height=oh,
    )
    translations = np.stack([seq.pose(i)[:3, 3] for i in range(n)], 0)
    video_mask = (
        _resize(seq.video_mask().astype(np.float32), out_hw, nearest=True) > 0.5
    ).astype(np.float32)

    def frame(i):
        im = np.asarray(seq.color(i), np.float32)
        if im.max() > 1.5:
            im = im / 255.0
        fine = _resize(im, in_hw).transpose(2, 0, 1)
        d = _resize(np.asarray(seq.depth(i), np.float32), out_hw)
        dm = seq.depth_mask(i)
        dm = (
            video_mask
            if dm is None
            else (_resize(dm.astype(np.float32), out_hw, nearest=True) > 0.5).astype(
                np.float32
            )
        )
        return fine, d, dm

    for _ in range(cfg.max_resample):
        src = int(rng.integers(0, n))
        close, far = generate_far_close_idx(src, n, translations, cfg, rng)

        f_src, d_src, dm_src = frame(src)
        f_close, d_close, dm_close = frame(close)
        f_far, _, _ = frame(far)

        # median-depth scale normalization of depths AND pose
        # translations (endoscopy_dataset.py:314-320)
        scale = 1.0
        if cfg.scale_normalize:
            vals = d_src[(dm_src > 0.5) & (d_src > 0)]
            if vals.size:
                scale = 1.0 / float(np.median(vals))
        d_src = scale * d_src
        d_close = scale * d_close

        def rel_pose(i, j):
            pi, pj = seq.pose(i).copy(), seq.pose(j).copy()
            pi[:3, 3] *= scale
            pj[:3, 3] *= scale
            return np.linalg.inv(pj) @ pi

        rel_close = rel_pose(src, close)
        rel_far = rel_pose(src, far)

        # rotation augmentation (round trip → the reference's crop_*)
        angles = (
            rng.uniform(-cfg.aug_rot_limit, cfg.aug_rot_limit, 3)
            if cfg.use_rotation_aug
            else np.zeros(3)
        )
        masks = {}
        if cfg.use_rotation_aug:
            f_src, masks["src"] = rotation_augment(f_src, video_mask, angles[0])
            f_close, masks["close"] = rotation_augment(
                f_close, video_mask, angles[1]
            )
            f_far, _ = rotation_augment(f_far, video_mask, angles[2])
        else:
            masks["src"] = masks["close"] = video_mask
        tri_mask = masks["src"] * masks["close"]

        # overlap gates (endoscopy_dataset.py:337-387)
        src_valid = dm_src * masks["src"]
        pr, ar = compute_scene_overlap(
            rel_close, d_src, src_valid, masks["close"], cam, cfg.depth_eps
        )
        if pr < cfg.tgt_overlap_ratio or ar < cfg.tgt_overlap_ratio:
            continue
        pr_f, ar_f = compute_scene_overlap(
            rel_far, d_src, src_valid, video_mask, cam, cfg.depth_eps
        )
        far_ok = not (
            pr_f > cfg.far_overlap_ratio and ar_f > cfg.far_overlap_ratio
        )

        # FAST keypoints → match / no-match split
        cand = fast_keypoints_1d(f_src, src_valid, out_hw, cfg.fast_threshold)
        cand = cand[
            (src_valid.reshape(-1)[cand] > 0.5)
            & (d_src.reshape(-1)[cand] > cfg.depth_eps)
        ]
        m_src, m_tgt, nm_src = split_match_candidates(
            cand, d_src, rel_close, cam, masks["close"], cfg.depth_eps
        )
        if m_src.size < 4:
            continue
        k = cfg.num_keypoints
        sel = rng.choice(m_src.size, size=k, replace=True)
        kps, matches = m_src[sel], m_tgt[sel]
        if nm_src.size:
            nm = nm_src[rng.choice(nm_src.size, size=k, replace=True)]
            nm_valid = 1.0
        else:
            nm, nm_valid = kps.copy(), 0.0

        # initial-pose perturbation with the overlap retry loop
        # (endoscopy_dataset.py:443-485)
        init_rel, init_ratio = None, 0.0
        for _ in range(11):
            guess = perturb_pose(rel_close, cfg, rng)
            gpr, gar = compute_scene_overlap(
                guess, d_src, src_valid, masks["close"], cam, cfg.depth_eps
            )
            if (
                gpr > cfg.random_overlap_ratio
                and gar > cfg.random_overlap_ratio
            ):
                init_rel, init_ratio = guess, min(gpr, gar)
                break
        if init_rel is None:
            continue

        return Triplet(
            image_src=f_src.astype(np.float32),
            image_close=f_close.astype(np.float32),
            image_far=f_far.astype(np.float32),
            mask=(tri_mask * video_mask).astype(np.float32),
            depth_src=d_src.astype(np.float32),
            depth_close=d_close.astype(np.float32),
            rel_pose_close_src=rel_close.astype(np.float32),
            keypoints_src=kps.astype(np.int64),
            gt_match_close=matches.astype(np.int64),
            camera=cam,
            no_match_src=nm.astype(np.int64),
            no_match_valid=nm_valid,
            init_rel_pose=init_rel.astype(np.float32),
            init_overlap_ratio=float(init_ratio),
            far_overlap_valid=far_ok,
            rot_angles=angles.astype(np.float32),
        )
    raise RuntimeError(
        f"no triplet satisfied the overlap gates in {cfg.max_resample} draws"
    )


# ---------------------------------------------------------------------------
# sources


class FusionHDF5Dataset(_SequenceSource):
    """The reference fusion_data.hdf5 reader
    (endoscopy_dataset.py:212-248): discovers `hdf5_pattern` files under
    `data_root`, keeps sequences whose `bag_<id>` path component is in
    `patient_ids`, and samples sequences with probability proportional
    to sqrt(frame count). HDF5 layout: color [N,H,W,3] uint8,
    mask [H,W(,1)], render_depth [N,H,W(,1)], render_mask [N,H,W(,1)],
    extrinsics [N,4,4], intrinsics [.,3,3] or [4]."""

    def __init__(
        self,
        data_root: str,
        patient_ids=None,
        hdf5_pattern: str = "fusion_data.hdf5",
        out_hw=(64, 80),
        in_hw=(128, 160),
        cfg: TripletConfig = TripletConfig(),
        seed: int = 0,
    ):
        import pathlib

        import h5py

        self.cfg = cfg
        self.out_hw, self.in_hw = tuple(out_hw), tuple(in_hw)
        self.rng = np.random.default_rng(seed)
        paths = sorted(pathlib.Path(data_root).rglob(hdf5_pattern))
        self.files, counts = [], []
        for p in paths:
            s = str(p)
            if patient_ids is not None:
                i = s.find("bag_")
                if i < 0:
                    continue
                j = s.find("/", i)
                j = len(s) if j < 0 else j
                try:
                    bag = int(s[i + 4 : j])
                except ValueError:
                    continue
                if bag not in patient_ids:
                    continue
            f = h5py.File(s, "r", libver="latest", swmr=True)
            self.files.append(f)
            counts.append(f["color"].shape[0])
        if not self.files:
            raise FileNotFoundError(
                f"no {hdf5_pattern} under {data_root} for {patient_ids}"
            )
        p = np.sqrt(np.asarray(counts, np.float64))
        self.probability = p / p.sum()
        self._f = self.files[0]
        self.n_frames = int(self._f["color"].shape[0])

    def _select(self):
        i = int(
            self.rng.choice(len(self.files), p=self.probability)
        )
        self._f = self.files[i]
        self.n_frames = int(self._f["color"].shape[0])

    @staticmethod
    def _squeeze(a):
        a = np.asarray(a)
        return a[..., 0] if a.ndim == 3 and a.shape[-1] == 1 else a

    def color(self, i):
        return np.asarray(self._f["color"][i])

    def depth(self, i):
        return self._squeeze(self._f["render_depth"][i]).astype(np.float32)

    def depth_mask(self, i):
        if "render_mask" not in self._f:
            return None
        return (self._squeeze(self._f["render_mask"][i]) > 0).astype(np.float32)

    def video_mask(self):
        m = self._squeeze(np.asarray(self._f["mask"]))
        if m.ndim == 3:  # stored per-frame: frame 0 (dataset.py:270)
            m = m[0]
        return (m > 0).astype(np.float32)

    def pose(self, i):
        return np.asarray(self._f["extrinsics"][i], np.float64)

    def intrinsics(self):
        k = np.asarray(self._f["intrinsics"])
        if k.ndim == 3:
            k = k[0]
        if k.shape == (3, 3):
            return np.array([k[0, 0], k[1, 1], k[0, 2], k[1, 2]])
        return k.reshape(-1)[:4]

    def sample(self) -> Triplet:
        self._select()
        return _build_triplet(self, self.out_hw, self.in_hw, self.cfg, self.rng)


class ArraySequenceDataset(_SequenceSource):
    """The triplet pipeline over in-memory arrays
    (color [N,H,W,3], depth [N,H,W], mask [H,W], intrinsics [4],
    poses [N,4,4]) — e.g. a rendered io.dataset.Bowl3DInterface
    sequence (`.to_arrays()`), used to train the networks on the
    synthetic 3D scene for the learned-prior end-to-end test."""

    def __init__(
        self,
        arrays: dict,
        cfg: Optional[TripletConfig] = None,
        out_hw=None,
        in_hw=None,
        seed: int = 0,
    ):
        self.d = arrays
        self.rng = np.random.default_rng(seed)
        self.cfg = cfg or TripletConfig()
        h, w = self.d["depth"].shape[1:3]
        self.out_hw = tuple(out_hw) if out_hw else (h, w)
        self.in_hw = tuple(in_hw) if in_hw else (2 * h, 2 * w)
        self.n_frames = int(self.d["color"].shape[0])

    def __len__(self):
        return self.n_frames

    def color(self, i):
        return np.asarray(self.d["color"][i])

    def depth(self, i):
        return np.asarray(self.d["depth"][i], np.float32)

    def depth_mask(self, i):
        return None

    def video_mask(self):
        return np.asarray(self.d["mask"], np.float32)

    def pose(self, i):
        return np.asarray(self.d["poses"][i], np.float64)

    def intrinsics(self):
        return np.asarray(self.d["intrinsics"]).reshape(-1)[:4]

    def sample(self) -> Triplet:
        return _build_triplet(self, self.out_hw, self.in_hw, self.cfg, self.rng)


class NpzSequenceDataset(_SequenceSource):
    """Same pipeline over an .npz sequence (color [N,H,W,3],
    depth [N,H,W], mask [H,W], intrinsics [4], poses [N,4,4])."""

    def __init__(
        self,
        path: str,
        num_keypoints: int = 128,
        cfg: Optional[TripletConfig] = None,
        out_hw=None,
        in_hw=None,
        seed: int = 0,
        # legacy knobs kept for API compatibility
        close_range: Optional[int] = None,
        far_min: Optional[int] = None,
    ):
        self.d = np.load(path)
        self.rng = np.random.default_rng(seed)
        if cfg is None:
            cfg = TripletConfig(num_keypoints=num_keypoints)
        if close_range is not None:
            cfg = dataclasses.replace(cfg, frame_interval=close_range)
        if far_min is not None:
            cfg = dataclasses.replace(cfg, far_frame_interval=far_min)
        self.cfg = cfg
        h, w = self.d["depth"].shape[1:3]
        self.out_hw = tuple(out_hw) if out_hw else (h, w)
        self.in_hw = tuple(in_hw) if in_hw else (2 * h, 2 * w)
        self.n_frames = int(self.d["color"].shape[0])

    def __len__(self):
        return self.n_frames

    def color(self, i):
        return np.asarray(self.d["color"][i])

    def depth(self, i):
        return np.asarray(self.d["depth"][i], np.float32)

    def depth_mask(self, i):
        return None

    def video_mask(self):
        return np.asarray(self.d["mask"], np.float32)

    def pose(self, i):
        return np.asarray(self.d["poses"][i], np.float64)

    def intrinsics(self):
        # stored at depth resolution; _build_triplet rescales to out_hw
        return np.asarray(self.d["intrinsics"]).reshape(-1)[:4]

    def sample(self) -> Triplet:
        return _build_triplet(self, self.out_hw, self.in_hw, self.cfg, self.rng)


class SyntheticTripletDataset:
    """Textured plane under known lateral motion (test fixture)."""

    def __init__(self, height=32, width=40, num_keypoints=32, seed=0):
        self.h, self.w = height, width
        self.rng = np.random.default_rng(seed)
        self.k = num_keypoints
        self.cam = PinholeCamera(
            fx=width * 1.2, fy=width * 1.2, cx=width / 2 - 0.5,
            cy=height / 2 - 0.5, width=width, height=height,
        )
        yy, xx = np.meshgrid(
            np.arange(height * 4), np.arange(width * 4), indexing="ij"
        )
        self.tex = np.stack(
            [
                0.5 + 0.5 * np.sin(0.13 * xx + 0.09 * yy + p)
                for p in (0.0, 2.0, 4.0)
            ]
        ).astype(np.float32)

    def sample(self) -> Triplet:
        h2, w2 = self.h * 2, self.w * 2  # input res
        shift = int(self.rng.integers(1, 4))

        def window(ox):
            return self.tex[:, :h2, ox : ox + w2]

        depth = np.full((self.h, self.w), 1.5, np.float32)
        mask = np.ones((self.h, self.w), np.float32)
        # lateral translation: shift pixels at input res = shift/2 at out
        tx = shift / 2 / self.cam.fx * 1.5  # world units
        rel = np.eye(4, dtype=np.float32)
        rel[0, 3] = -tx
        kps, matches = _project_gt_keypoints(
            depth, rel, self.cam, mask, self.k, self.rng
        )
        return Triplet(
            image_src=window(0),
            image_close=window(shift),
            image_far=window(w2),
            mask=mask,
            depth_src=depth,
            depth_close=depth,
            rel_pose_close_src=rel,
            keypoints_src=kps,
            gt_match_close=matches,
            camera=self.cam,
        )


def _project_gt_keypoints(depth_src, rel, cam, mask, k, rng):
    """GT correspondences by projecting random valid src pixels into the
    close frame with the GT depth + relative pose (test fixture path)."""
    h, w = depth_src.shape
    valid = np.flatnonzero((mask.reshape(-1) > 0.5) & (depth_src.reshape(-1) > 1e-6))
    kps = rng.choice(valid, size=min(k, len(valid)), replace=False)
    u, v, _ = _project_points(kps, depth_src, rel, cam, 1e-6)
    ui = np.clip(np.round(u), 0, w - 1).astype(np.int64)
    vi = np.clip(np.round(v), 0, h - 1).astype(np.int64)
    return kps.astype(np.int64), (vi * w + ui)
