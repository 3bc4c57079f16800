"""Dataset readers (port of sage_slam_tpu/io/dataset.py; numpy, the
port's own copy).

URL-prefix factory like the reference's CameraInterfaceFactory:
  hdf5://path     -> HDF5 endoscopy dataset (fusion_data.hdf5 layout:
                     color [N,H,W,3], mask [H,W,1], intrinsics)
  tum://dir       -> TUM RGB-D directory (rgb.txt)
  icl://dir       -> ICL-NUIM directory (associate.txt + groundtruth.txt)
  scannet://dir   -> ScanNet sequence (color/ depth/ pose/ intrinsic/)
  synthetic://    -> procedurally rendered test sequence
  bowl3d://?k=v   -> the analytic 3D cavity with exact ground truth

Every reader returns numpy frames and the port's PinholeCamera; the
frames become tensors where the system takes them (SlamDriver.run).
h5py and PIL are imported inside the readers that need them, so importing
this module needs neither.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..geometry.camera import PinholeCamera


@dataclasses.dataclass
class FrameRecord:
    timestamp: float
    image: np.ndarray  # [3, H, W] float32 in [0, 1]
    # optional ground-truth payloads (ICL/ScanNet readers; eval only)
    depth: Optional[np.ndarray] = None  # [H, W] float32 meters
    pose_wf: Optional[np.ndarray] = None  # [4, 4] world-from-frame


class CameraInterface:
    """Iterator over frames + intrinsics + mask
    (drivers/camera_interface.h)."""

    def intrinsics(self) -> PinholeCamera:
        raise NotImplementedError

    def mask(self) -> np.ndarray:  # [H, W] float32
        raise NotImplementedError

    def frames(self) -> Iterator[FrameRecord]:
        raise NotImplementedError


def from_url(url: str, **kwargs) -> CameraInterface:
    if url.startswith("hdf5://"):
        return HDF5Interface(url[len("hdf5://") :], **kwargs)
    if url.startswith("tum://"):
        return TumInterface(url[len("tum://") :], **kwargs)
    if url.startswith("icl://"):
        return IclInterface(url[len("icl://") :], **kwargs)
    if url.startswith("scannet://"):
        return ScanNetInterface(url[len("scannet://") :], **kwargs)
    if url.startswith("synthetic://"):
        return SyntheticInterface(**kwargs)
    if url.startswith("bowl3d://"):
        # bowl3d://?orbit_radius=0.2&seed=1 — query params map onto
        # Bowl3DInterface kwargs (ints/floats inferred)
        from urllib.parse import parse_qsl, urlparse

        q = dict(parse_qsl(urlparse(url).query))
        for k, v in q.items():
            # URL query overrides caller defaults; booleans (revisit=
            # true) and numerics both parse, anything else errors with
            # the parameter name
            if v.lower() in ("true", "false"):
                kwargs[k] = v.lower() == "true"
                continue
            try:
                kwargs[k] = (
                    float(v) if ("." in v or "e" in v.lower()) else int(v)
                )
            except ValueError:
                raise ValueError(
                    f"bowl3d:// parameter {k}={v!r} is neither numeric "
                    "nor true/false"
                ) from None
        return Bowl3DInterface(**kwargs)
    raise ValueError(f"unknown dataset url scheme: {url}")


def _load_image(path: str) -> np.ndarray:
    """[3, H, W] float32 in [0, 1] via PIL (replaces cv::imread)."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return img.transpose(2, 0, 1)


def _load_depth_png(path: str, scale: float) -> np.ndarray:
    """16-bit depth PNG -> meters (cv::IMREAD_ANYDEPTH + convertTo)."""
    from PIL import Image

    return np.asarray(Image.open(path), np.float32) * scale


def _quat_to_rot(qx, qy, qz, qw) -> np.ndarray:
    q = np.array([qx, qy, qz, qw], np.float64)
    q = q / np.linalg.norm(q)
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


class HDF5Interface(CameraInterface):
    """fusion_data.hdf5 reader (hdf5_interface.cpp:9-112): datasets
    'color' [N,H,W,3] uint8, 'mask' [H,W,1], 'intrinsics' [4] (fx,fy,cx,cy)."""

    def __init__(self, path: str, stride: int = 1):
        try:
            import h5py  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "h5py is not available in this environment; convert the "
                "HDF5 sequence to .npz (color/mask/intrinsics) and use "
                "NpzInterface, or install h5py."
            ) from e
        import h5py

        self._f = h5py.File(path, "r")
        self.stride = stride
        intr = np.array(self._f["intrinsics"]).reshape(-1)
        h, w = self._f["mask"].shape[:2]
        self._cam = PinholeCamera(
            fx=float(intr[0]), fy=float(intr[1]), cx=float(intr[2]),
            cy=float(intr[3]), width=w, height=h,
        )

    def intrinsics(self) -> PinholeCamera:
        return self._cam

    def mask(self) -> np.ndarray:
        return np.array(self._f["mask"]).reshape(
            self._cam.height, self._cam.width
        ).astype(np.float32)

    def frames(self) -> Iterator[FrameRecord]:
        color = self._f["color"]
        for i in range(0, color.shape[0], self.stride):
            img = np.asarray(color[i], np.float32) / 255.0
            yield FrameRecord(float(i), img.transpose(2, 0, 1))


class NpzInterface(CameraInterface):
    """A .npz with color [N,H,W,3] (uint8 or float), mask [H,W],
    intrinsics [4], optional timestamps [N]."""

    def __init__(self, path: str, stride: int = 1):
        self._d = np.load(path)
        self.stride = stride
        intr = self._d["intrinsics"].reshape(-1)
        h, w = self._d["mask"].shape[:2]
        self._cam = PinholeCamera(
            fx=float(intr[0]), fy=float(intr[1]), cx=float(intr[2]),
            cy=float(intr[3]), width=w, height=h,
        )

    def intrinsics(self) -> PinholeCamera:
        return self._cam

    def mask(self) -> np.ndarray:
        return self._d["mask"].astype(np.float32).reshape(
            self._cam.height, self._cam.width
        )

    def frames(self) -> Iterator[FrameRecord]:
        color = self._d["color"]
        ts = self._d.get("timestamps", np.arange(color.shape[0], dtype=np.float64))
        for i in range(0, color.shape[0], self.stride):
            img = np.asarray(color[i], np.float32)
            if img.max() > 1.5:
                img = img / 255.0
            yield FrameRecord(float(ts[i]), img.transpose(2, 0, 1))


class TumInterface(CameraInterface):
    """TUM RGB-D directory: rgb.txt lists 'timestamp filename'
    (tum_interface.cpp)."""

    # TUM fr1 default intrinsics
    DEFAULT = (517.3, 516.5, 318.6, 255.3, 640, 480)

    def __init__(self, root: str, intrinsics: Optional[Tuple] = None):
        self.root = root
        vals = intrinsics or self.DEFAULT
        self._cam = PinholeCamera(
            fx=vals[0], fy=vals[1], cx=vals[2], cy=vals[3],
            width=int(vals[4]), height=int(vals[5]),
        )
        self._list = []
        with open(os.path.join(root, "rgb.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                self._list.append((float(ts), os.path.join(root, rel)))

    def intrinsics(self) -> PinholeCamera:
        return self._cam

    def mask(self) -> np.ndarray:
        return np.ones((self._cam.height, self._cam.width), np.float32)

    def frames(self) -> Iterator[FrameRecord]:
        from PIL import Image  # pillow ships with torch envs

        for ts, path in self._list:
            img = np.asarray(Image.open(path), np.float32) / 255.0
            yield FrameRecord(ts, img.transpose(2, 0, 1))


class IclInterface(CameraInterface):
    """ICL-NUIM directory reader (icl_interface.cpp).

    Layout: ``associate.txt`` lines ``dpt_ts dpt_path img_ts img_path``
    (:114-135), 16-bit depth PNGs at 1/5000 m (:77), optional
    ``groundtruth.txt`` TUM poses made relative to the first pose
    (:137-...), fixed ICL intrinsics 481.2/480.0/319.5/239.5 at 640x480
    (:57-59). The last association is dropped — its pose is always
    missing (:22-24)."""

    DEPTH_SCALE = 1.0 / 5000.0

    def __init__(self, root: str, stride: int = 1):
        self.root = root
        self.stride = stride
        self._cam = PinholeCamera(
            fx=481.2, fy=480.0, cx=319.5, cy=239.5, width=640, height=480
        )
        self._frames: List[Tuple[float, str, str]] = []
        with open(os.path.join(root, "associate.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or "#" in line:
                    continue
                parts = line.split()
                # dpt_ts dpt_path img_ts img_path
                self._frames.append(
                    (float(parts[2]), parts[3], parts[1])
                )
        if self._frames:
            self._frames.pop()  # last pose always missing (:22-24)
        self._poses = self._load_poses(os.path.join(root, "groundtruth.txt"))

    @staticmethod
    def _load_poses(path: str) -> List[np.ndarray]:
        """TUM-format poses, re-expressed relative to the first pose
        (AssignPoses, icl_interface.cpp:137-...)."""
        if not os.path.exists(path):
            return []
        raw = []
        with open(path) as f:
            for line in f:
                if "#" in line or not line.strip():
                    continue
                v = [float(x) for x in line.split()]
                # ts tx ty tz qx qy qz qw
                raw.append((np.array(v[1:4]), _quat_to_rot(*v[4:8])))
        if not raw:
            return []
        t0, r0 = raw[0]
        # "fix ICL-NUIM pose issues" (icl_interface.cpp AssignPoses):
        # relPose = (Sy * rel^-1 * Sy)^-1 with Sy = diag(1,-1,1,1), which
        # simplifies to Sy @ rel @ Sy since Sy is involutive — ICL ground
        # truth uses a y-down convention that must be conjugated away.
        sy = np.diag([1.0, -1.0, 1.0, 1.0])
        out = []
        for t, r in raw:
            rel = np.eye(4)
            rel[:3, :3] = r0.T @ r
            rel[:3, 3] = r0.T @ (t - t0)
            out.append(sy @ rel @ sy)
        return out

    def intrinsics(self) -> PinholeCamera:
        return self._cam

    def mask(self) -> np.ndarray:
        return np.ones((self._cam.height, self._cam.width), np.float32)

    def frames(self) -> Iterator[FrameRecord]:
        for i in range(0, len(self._frames), self.stride):
            ts, img_rel, dpt_rel = self._frames[i]
            yield FrameRecord(
                ts,
                _load_image(os.path.join(self.root, img_rel)),
                depth=_load_depth_png(
                    os.path.join(self.root, dpt_rel), self.DEPTH_SCALE
                ),
                pose_wf=self._poses[i] if i < len(self._poses) else None,
            )


class ScanNetInterface(CameraInterface):
    """ScanNet sequence reader (scannet_interface.cpp).

    Layout: ``color/<i>.jpg``, ``depth/<i>.png`` (16-bit, 1/1000 m,
    :122), ``pose/<i>.txt`` (4x4 world-from-frame), ``intrinsic/
    intrinsic_color.txt`` (4x4 K, :130-150). Images and intrinsics are
    rescaled to 640x480 like the reference (:67-68); timestamps are the
    frame indices (:115)."""

    DEPTH_SCALE = 1.0 / 1000.0
    VIEW_W, VIEW_H = 640, 480

    def __init__(self, root: str, stride: int = 1, resize: bool = True):
        self.root = root
        self.stride = stride
        self.resize = resize
        color_dir = os.path.join(root, "color")
        self._n = len(
            [f for f in os.listdir(color_dir) if f.endswith(".jpg")]
        )
        self._has_depth = os.path.isdir(os.path.join(root, "depth"))
        k = np.loadtxt(
            os.path.join(root, "intrinsic", "intrinsic_color.txt")
        ).reshape(4, 4)
        from PIL import Image

        with Image.open(os.path.join(color_dir, "0.jpg")) as im:
            w0, h0 = im.size
        cam = PinholeCamera(
            fx=float(k[0, 0]), fy=float(k[1, 1]),
            cx=float(k[0, 2]), cy=float(k[1, 2]), width=w0, height=h0,
        )
        self._cam = (
            cam.resized(self.VIEW_W, self.VIEW_H) if resize else cam
        )

    def intrinsics(self) -> PinholeCamera:
        return self._cam

    def mask(self) -> np.ndarray:
        return np.ones((self._cam.height, self._cam.width), np.float32)

    def frames(self) -> Iterator[FrameRecord]:
        from PIL import Image

        # scannet_interface.cpp LoadPoses: poses are returned relative to
        # the first (finite) pose, and non-finite poses — which ScanNet
        # pose files routinely contain (-inf rows) — are dropped.
        first_inv = None
        for i in range(0, self._n, self.stride):
            path = os.path.join(self.root, "color", f"{i}.jpg")
            im = Image.open(path).convert("RGB")
            if self.resize:
                im = im.resize((self._cam.width, self._cam.height))
            img = (
                np.asarray(im, np.float32) / 255.0
            ).transpose(2, 0, 1)
            depth = None
            if self._has_depth:
                depth = _load_depth_png(
                    os.path.join(self.root, "depth", f"{i}.png"),
                    self.DEPTH_SCALE,
                )
            pose_path = os.path.join(self.root, "pose", f"{i}.txt")
            pose = (
                np.loadtxt(pose_path).reshape(4, 4)
                if os.path.exists(pose_path)
                else None
            )
            if pose is not None and not np.isfinite(pose).all():
                pose = None
            if pose is not None:
                if first_inv is None:
                    first_inv = np.linalg.inv(pose)
                pose = first_inv @ pose
            yield FrameRecord(float(i), img, depth=depth, pose_wf=pose)


class SyntheticInterface(CameraInterface):
    """Procedural textured-plane sequence with a known trajectory —
    the fixture for end-to-end tests without data on disk."""

    def __init__(
        self,
        num_frames: int = 20,
        height: int = 64,
        width: int = 80,
        seed: int = 0,
        motion_scale: float = 0.01,
    ):
        self.n = num_frames
        self.h, self.w = height, width
        self.rng = np.random.default_rng(seed)
        self.motion = motion_scale
        self._cam = PinholeCamera(
            fx=width * 1.2, fy=width * 1.2, cx=width / 2 - 0.5,
            cy=height / 2 - 0.5, width=width, height=height,
        )
        yy, xx = np.meshgrid(
            np.arange(height * 2), np.arange(width * 2), indexing="ij"
        )
        # multi-scale texture: gratings with wavelengths from ~half the
        # image down to ~6 px so photometric alignment has localizable
        # structure at every pyramid level (a single near-DC sinusoid is
        # untrackable — its band-passed content is ~0 at these sizes)
        freqs = [
            (0.11, 0.07), (0.31, -0.19), (-0.23, 0.41),
            (0.47, 0.23), (0.35, -0.52), (0.58, 0.13),
        ]
        chans = []
        for ci, p in enumerate((0.0, 2.1, 4.2)):
            acc = np.zeros_like(xx, np.float32)
            for fi, (fx_, fy_) in enumerate(freqs):
                amp = 1.0 / (1.0 + 0.35 * fi)
                acc += amp * np.sin(
                    fx_ * xx + fy_ * yy + p + 1.7 * fi + 0.9 * ci
                )
            acc /= np.abs(acc).max()
            chans.append(0.5 + 0.5 * acc)
        self.texture = np.stack(chans).astype(np.float32)

    def intrinsics(self) -> PinholeCamera:
        return self._cam

    def mask(self) -> np.ndarray:
        return np.ones((self.h, self.w), np.float32)

    def frames(self) -> Iterator[FrameRecord]:
        for i in range(self.n):
            # translate the texture window -> EXACT lateral motion of a
            # camera over a fronto-parallel plane at unit depth: a window
            # shift of ox pixels equals a translation of ox/fx (the
            # ground-truth pose emitted in pose_wf, used by the ATE
            # regression test)
            ox = int(i * self.motion * self.w)
            oy = int(i * self.motion * self.h * 0.5)
            img = self.texture[:, oy : oy + self.h, ox : ox + self.w]
            pose = np.eye(4)
            pose[0, 3] = ox / self._cam.fx
            pose[1, 3] = oy / self._cam.fy
            yield FrameRecord(
                float(i),
                img.copy(),
                depth=np.ones((self.h, self.w), np.float32),
                pose_wf=pose,
            )


class Bowl3DInterface(CameraInterface):
    """Analytic textured 3D cavity: the camera orbits INSIDE a sphere
    ``|X - (0, 0, z0)| = radius`` with exact ray-cast depth, nontrivial
    rotation, and an exact revisit at the end of the orbit (a
    guaranteed loop closure).

    This is the repo's `bag_1` substitute (the reference demo sequence,
    system/configs/slam_run.flags:1, is not shipped): a deterministic
    full-3D sequence with ground-truth poses and depths for end-to-end
    ATE/depth-RMSE evaluation at the reference operating point.
    Everything is closed-form:

    * ray o + t*d vs the sphere is a quadratic in t with a GUARANTEED
      unique forward root from any interior camera (any FOV, any
      rotation — see _raycast for why the surface is a sphere),
    * depth = camera-frame z of the hit point,
    * texture = broadband sum of 3D sinusoids evaluated at the hit
      point (see the frequency-bank note below).
    """

    def __init__(
        self,
        num_frames: int = 40,
        height: int = 64,
        width: int = 80,
        seed: int = 0,
        z0: float = 1.0,
        radius: float = 1.3,
        orbit_radius: float = 0.12,
        rot_amp: float = 0.12,
        revisit: bool = True,
        mask_margin: int = 0,
        focal: float = 0.7,
        orbits: float = 1.0,
        light_falloff: float = 0.0,
        specular: float = 0.0,
        spec_power: float = 32.0,
        noise: float = 0.0,
    ):
        self.n = num_frames
        self.h, self.w = height, width
        self.z0 = z0
        self.radius = radius
        self.r_orbit = orbit_radius
        self.rot_amp = rot_amp
        self.revisit = revisit
        # number of full orbits over the sequence (orbits > 1 gives a
        # MULTI-REVISIT trajectory: the camera passes the start region
        # at every integer multiple of 2*pi, each pass a loop-closure
        # opportunity AFTER drift has accumulated — the eval the
        # reference's pose-scale loop graph is built for,
        # deepfactors.cpp:81-386)
        self.orbits = float(orbits)
        # ---- "hard mode": the endoscopy photometric nuisances the
        # analytic texture lacks. All are
        # VIEW-DEPENDENT, so they violate the brightness-constancy
        # assumption exactly the way the reference's endoscope does
        # (co-located light + wet tissue): light_falloff k gives a
        # camera-attached point light with 1/(1 + k d^2) intensity,
        # specular adds a Phong lobe from the same light (half-vector =
        # view direction), noise adds per-frame seeded sensor noise.
        # Defaults 0 = the exact legacy Lambertian-texture renderer.
        self.light_falloff = float(light_falloff)
        self.specular = float(specular)
        self.spec_power = float(spec_power)
        self.noise = float(noise)
        # video-mask border (the reference's endoscopy mask zeroes the
        # frame borders, so conv border artifacts never enter training
        # or the runtime; mask_margin reproduces that property)
        self.mask_margin = int(mask_margin)
        # geometry defaults follow the reference's DOMAIN, not a generic
        # plane: a camera inside a genuinely 3D cavity with a wide-ish
        # FOV. A narrow-FOV shallow scene leaves the classic bas-relief
        # translation/rotation valley nearly flat — no tracker can
        # resolve per-pair motion there, and the eval would measure
        # scene conditioning, not estimator quality. Steepness is
        # bounded by the sphere itself: grazing incidence (which
        # aliases the analytic texture and was measured to bias the
        # photometric optimum 5-15% off the true poses via a pure-numpy
        # GT-warp alpha scan on the old paraboloid) cannot occur from
        # well inside a sphere.
        self._cam = PinholeCamera(
            fx=width * focal, fy=width * focal, cx=width / 2 - 0.5,
            cy=height / 2 - 0.5, width=width, height=height,
        )
        self._seed = int(seed)
        rng = np.random.default_rng(seed)
        # texture banks: per-channel frequencies/phases. BROADBAND on
        # purpose: a narrow band (the original 18-42 rad/unit ~ 7-17 px
        # projected period) makes the photometric landscape periodic —
        # alias minima every texture period trap any tracker regardless
        # of quality. The low-frequency octaves give the coarse pyramid
        # levels monotone structure (wide basins), the high ones give
        # the fine levels localization, like real broadband images.
        self._freqs = np.concatenate(
            [
                rng.uniform(3.0, 9.0, size=(3, 2, 3)),
                rng.uniform(9.0, 20.0, size=(3, 2, 3)),
                rng.uniform(20.0, 42.0, size=(3, 2, 3)),
            ],
            axis=1,
        )
        self._phases = rng.uniform(0.0, 2 * np.pi, size=(3, 6))
        self._amps = np.array([0.30, 0.24, 0.14, 0.11, 0.07, 0.05])

    def intrinsics(self) -> PinholeCamera:
        return self._cam

    def mask(self, height=None, width=None) -> np.ndarray:
        h = height or self.h
        w = width or self.w
        m = np.ones((h, w), np.float32)
        if self.mask_margin > 0:
            # margin scales with the viewport like the reference's mask
            my = max(1, round(self.mask_margin * h / self.h))
            mx = max(1, round(self.mask_margin * w / self.w))
            m[:my] = 0.0
            m[-my:] = 0.0
            m[:, :mx] = 0.0
            m[:, -mx:] = 0.0
        return m

    # -- trajectory ---------------------------------------------------

    def pose_at(self, i: int) -> np.ndarray:
        """World-from-camera pose of frame i: a closed orbit with yaw +
        pitch rotation; the final frame returns to the first view when
        ``revisit`` (theta wraps to 2*pi)."""
        denom = max(self.n - 1, 1)
        theta = 2 * np.pi * self.orbits * i / denom if self.revisit else (
            1.5 * i / denom
        )
        c = np.array(
            [
                self.r_orbit * np.sin(theta),
                self.r_orbit * (1.0 - np.cos(theta)) * 0.6,
                0.04 * np.sin(theta),
            ]
        )
        yaw = self.rot_amp * np.sin(theta)
        pitch = 0.6 * self.rot_amp * (1.0 - np.cos(theta))
        cy_, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        ry = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        pose = np.eye(4)
        pose[:3, :3] = ry @ rx
        pose[:3, 3] = c
        return pose

    # -- rendering ----------------------------------------------------

    def _raycast(self, pose_wc: np.ndarray, h: int, w: int, cam):
        """Returns (depth [h,w] camera-frame z, hit points [h,w,3] world).

        The cavity is the INTERIOR of a sphere centered at (0, 0, z0)
        with radius ``radius``: from any interior camera, EVERY ray has
        exactly one forward intersection, at any field of view and any
        rotation — unlike a paraboloid, whose corner rays could miss
        the surface at wide FOV."""
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        rc = np.stack(
            [
                (xs - cam.cx) / cam.fx,
                (ys - cam.cy) / cam.fy,
                np.ones_like(xs, np.float64),
            ],
            axis=-1,
        )  # [h, w, 3] camera-frame ray dirs (z component 1 -> t = depth)
        rot, c = pose_wc[:3, :3], pose_wc[:3, 3]
        d = rc @ rot.T  # world-frame dirs
        e = c[None, None, :]
        center = np.array([0.0, 0.0, self.z0])
        oc = e - center
        if float(np.linalg.norm(c - center)) >= self.radius:
            raise ValueError(
                "Bowl3DInterface: camera left the cavity "
                f"(|c - center| >= radius {self.radius}); reduce "
                "orbit_radius or increase radius"
            )
        qa = np.sum(d * d, axis=-1)
        qb = 2.0 * np.sum(d * oc, axis=-1)
        qc = float(np.sum(oc[0, 0] ** 2) - self.radius**2)
        # qc < 0 inside the sphere -> disc > 0 and a unique forward root
        disc = qb**2 - 4 * qa * qc
        t = (-qb + np.sqrt(disc)) / (2 * qa)
        hit = e + d * t[..., None]
        return t.astype(np.float32), hit

    def _texture(self, hit: np.ndarray) -> np.ndarray:
        """[3, h, w] procedural texture from world hit points."""
        out = np.empty((3,) + hit.shape[:2], np.float32)
        for ch in range(3):
            v = 0.5 * np.ones(hit.shape[:2])
            for k in range(self._freqs.shape[1]):
                f = self._freqs[ch, k]
                v = v + self._amps[k] * np.sin(
                    f[0] * hit[..., 0]
                    + f[1] * hit[..., 1]
                    + f[2] * hit[..., 2]
                    + self._phases[ch, k]
                )
            out[ch] = np.clip(v, 0.0, 1.0)
        return out

    def render(self, i: int, height=None, width=None):
        """(image [3,h,w], depth [h,w], pose_wc [4,4]) at any resolution
        (intrinsics rescale with the viewport)."""
        h = height or self.h
        w = width or self.w
        cam = self._cam.resized(w, h)
        pose = self.pose_at(i)
        depth, hit = self._raycast(pose, h, w, cam)
        img = self._texture(hit)
        if self.light_falloff > 0 or self.specular > 0 or self.noise > 0:
            eye = pose[:3, 3]
            to_eye = eye[None, None, :] - hit  # [h, w, 3]
            dist = np.linalg.norm(to_eye, axis=-1)
            if self.light_falloff > 0:
                img = img / (1.0 + self.light_falloff * dist[None] ** 2)
            if self.specular > 0:
                center = np.array([0.0, 0.0, self.z0])
                normal = center[None, None, :] - hit  # interior normal
                normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
                view = to_eye / np.maximum(dist[..., None], 1e-9)
                ndv = np.clip((normal * view).sum(-1), 0.0, 1.0)
                spec = self.specular * ndv**self.spec_power
                if self.light_falloff > 0:
                    spec = spec / (1.0 + self.light_falloff * dist**2)
                img = img + spec[None]
            if self.noise > 0:
                # deterministic per (dataset seed, frame): renders are
                # reproducible across processes and resolutions rescale
                # independently
                rng = np.random.default_rng([self._seed, 7919, int(i)])
                img = img + rng.normal(
                    0.0, self.noise, img.shape
                ).astype(np.float32)
            img = np.clip(img, 0.0, 1.0).astype(np.float32)
        return img, depth, pose

    def frames(self) -> Iterator[FrameRecord]:
        for i in range(self.n):
            img, depth, pose = self.render(i)
            yield FrameRecord(
                float(i), img, depth=depth, pose_wf=pose
            )

    def to_arrays(self, height=None, width=None) -> dict:
        """Materialize the sequence for the training triplet pipeline:
        dict(color [N,H,W,3], depth [N,H,W], mask, intrinsics, poses)."""
        h = height or self.h
        w = width or self.w
        cam = self._cam.resized(w, h)
        color = np.empty((self.n, h, w, 3), np.float32)
        depth = np.empty((self.n, h, w), np.float32)
        poses = np.empty((self.n, 4, 4), np.float64)
        for i in range(self.n):
            img, d, pose = self.render(i, h, w)
            color[i] = img.transpose(1, 2, 0)
            depth[i] = d
            poses[i] = pose
        return dict(
            color=color,
            depth=depth,
            mask=self.mask(h, w),
            intrinsics=np.array(
                [cam.fx, cam.fy, cam.cx, cam.cy], np.float32
            ),
            poses=poses,
        )
