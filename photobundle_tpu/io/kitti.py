"""KITTI odometry dataset ingestion (host side) + dataset factory.

Counterpart of the reference's dataset layer (pb:src/dataset.h/.cc:
`Dataset::Create` factory, `KittiDataset`/`StereoDataset`, `Calibration`,
`StereoFrame`, `StereoAlgorithm`). Per SURVEY.md section 2a the disparity
pipeline is input preparation only, so image decode stays on the host (the
native libpng loader, or io/png.py) while stereo matching itself runs as the
JAX block matcher in image/stereo.py (on-device), the native matcher, or,
as an explicit opt-in (OPENCV_BM), OpenCV.

Directory layout (KITTI odometry):
    <root>/sequences/<NN>/image_0/??????.png   left gray
    <root>/sequences/<NN>/image_1/??????.png   right gray
    <root>/sequences/<NN>/calib.txt            P0..P3 projection rows
    <root>/sequences/<NN>/times.txt
    <root>/poses/<NN>.txt                      ground truth (if present)
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np

from ..config import PBAConfig
from ..geometry.camera import Camera
from . import png


class StereoFrame(NamedTuple):
    image: np.ndarray       # (H, W) float32 in [0, 1], left gray
    depth: np.ndarray       # (H, W) float32 metric depth (0 = invalid)
    depth_valid: np.ndarray  # (H, W) bool
    timestamp: float
    index: int


def _imread_gray(path: str) -> np.ndarray:
    img = png.to_gray(png.read_png(path))
    # Multiply by the f32 reciprocal (not /255) so pixels match the
    # device-side uint8 dequantization bitwise (engine transport path).
    return img.astype(np.float32) * np.float32(1.0 / 255.0)


def parse_kitti_calib(path: str):
    """calib.txt -> dict of 3x4 projection matrices {P0: ..., P1: ...}."""
    mats = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, _, vals = line.partition(":")
            v = np.fromstring(vals, sep=" ")
            if v.size == 12:
                mats[key.strip()] = v.reshape(3, 4)
    return mats


def calibration_from_projections(p0: np.ndarray, p1: np.ndarray) -> Camera:
    """fx, fy, cx, cy from P0; stereo baseline from P1 (b = -P1[0,3]/fx)."""
    fx = p0[0, 0]
    fy = p0[1, 1]
    cx = p0[0, 2]
    cy = p0[1, 2]
    baseline = -p1[0, 3] / fx
    return Camera.create(fx=fx, fy=fy, cx=cx, cy=cy, baseline=baseline)


@dataclass
class KittiStereoDataset:
    """Sequence reader + stereo-depth producer (reference `getFrame`,
    SURVEY.md 3.5)."""

    root: str
    sequence: int
    cfg: PBAConfig
    first_frame: int = 0
    num_frames: int = -1

    def __post_init__(self):
        seq = f"{self.sequence:02d}"
        self.seq_dir = os.path.join(self.root, "sequences", seq)
        self.left_files = sorted(glob.glob(os.path.join(self.seq_dir, "image_0", "*.png")))
        self.right_files = sorted(glob.glob(os.path.join(self.seq_dir, "image_1", "*.png")))
        if not self.left_files:
            raise FileNotFoundError(f"no images under {self.seq_dir}/image_0")
        calib = parse_kitti_calib(os.path.join(self.seq_dir, "calib.txt"))
        self.camera = calibration_from_projections(calib["P0"], calib["P1"])
        times_path = os.path.join(self.seq_dir, "times.txt")
        self.times = (np.loadtxt(times_path) if os.path.exists(times_path)
                      else np.arange(len(self.left_files), dtype=np.float64))
        end = len(self.left_files) if self.num_frames < 0 else min(
            len(self.left_files), self.first_frame + self.num_frames)
        self.indices = list(range(self.first_frame, end))
        self._stereo_fn = None
        self._native = None
        mode = getattr(self.cfg, "dataLoader", "auto")

        # Depth cache (cfg.depthCacheDir): depth depends only on the stereo
        # parameters + calibration + producer, so repeated runs (accuracy
        # sweeps, golden tables — many solver configs over one sequence)
        # reuse it. When EVERY frame is already cached, the stereo pipeline
        # (native prefetch pool included) is not started at all.
        self._cache_dir = None
        self._cache_all_hit = False
        if getattr(self.cfg, "depthCacheDir", ""):
            cfg = self.cfg
            native_producer = False
            if mode in ("auto", "native") and cfg.stereoAlgorithm.upper() in (
                    "BM", "SGBM"):
                from .. import native as _nat

                native_producer = _nat.available()
            # Dataset identity fingerprint: without it, two datasets that
            # share a cache dir, sequence number, and stereo parameters
            # would silently serve each other's depths (and a re-rendered
            # synthetic dataset would serve stale ones). The first image's
            # path+size+mtime changes whenever the underlying data does.
            import hashlib

            probe = self.left_files[self.indices[0]]
            st = os.stat(probe)
            ident = hashlib.md5(
                f"{os.path.abspath(probe)}|{st.st_size}|{st.st_mtime_ns}"
                .encode()).hexdigest()[:10]
            key = "_".join(str(v) for v in (
                cfg.stereoAlgorithm.upper(), cfg.numDisparities,
                cfg.minDisparity, cfg.sadWindowSize, cfg.speckleWindowSize,
                cfg.speckleRange, cfg.minDepth, cfg.maxDepth,
                f"{float(self.camera.fx):.6g}",
                f"{float(self.camera.baseline):.6g}",
                "native" if native_producer else "jax", ident))
            # Appended only when on so pre-existing cache keys stay valid.
            if cfg.preFilterCap > 0:
                key += f"_pfc{cfg.preFilterCap}"
            self._cache_dir = os.path.join(
                self.cfg.depthCacheDir, f"seq{self.sequence:02d}_{key}")
            os.makedirs(self._cache_dir, exist_ok=True)
            self._cache_all_hit = all(
                os.path.exists(self._cache_path(i)) for i in self.indices)

        if (not self._cache_all_hit and mode in ("auto", "native")
                and self.cfg.stereoAlgorithm.upper() in ("BM", "SGBM")):
            from .. import native

            if native.available():
                self._native = native.PrefetchingLoader(
                    [self.left_files[i] for i in self.indices],
                    [self.right_files[i] for i in self.indices],
                    num_disparities=self.cfg.numDisparities,
                    min_disparity=self.cfg.minDisparity,
                    sad_radius=self.cfg.sadWindowSize // 2,
                    uniqueness_ratio=0.97, texture_threshold=0.02,
                    fx=float(self.camera.fx),
                    baseline=float(self.camera.baseline),
                    min_depth=self.cfg.minDepth, max_depth=self.cfg.maxDepth,
                    n_threads=max(2, self.cfg.numThreads),
                    prefetch_ahead=4,
                    algorithm=self.cfg.stereoAlgorithm.upper(),
                    speckle_size=self.cfg.speckleWindowSize,
                    speckle_range=self.cfg.speckleRange,
                    prefilter_cap=self.cfg.preFilterCap)
            elif mode == "native":
                from .. import native as _n

                raise RuntimeError(
                    f"dataLoader=native requested but unavailable: "
                    f"{_n.build_error()}")

    def __len__(self):
        return len(self.indices)

    @property
    def image_shape(self):
        img = _imread_gray(self.left_files[self.indices[0]])
        return img.shape

    def pose_file(self) -> str:
        return os.path.join(self.root, "poses", f"{self.sequence:02d}.txt")

    def _compute_depth(self, left: np.ndarray, right: np.ndarray):
        cfg = self.cfg
        if cfg.stereoAlgorithm.upper() in ("BM", "SGBM"):
            from ..image import stereo as stereo_mod
            import jax

            match = (stereo_mod.semi_global_match
                     if cfg.stereoAlgorithm.upper() == "SGBM"
                     else stereo_mod.block_match)
            disp, valid = match(
                left, right,
                num_disparities=cfg.numDisparities,
                min_disparity=cfg.minDisparity,
                sad_radius=cfg.sadWindowSize // 2,
                prefilter_cap=cfg.preFilterCap,
            )
            disp = np.asarray(jax.device_get(disp))
            valid = np.asarray(jax.device_get(valid))
            if cfg.speckleWindowSize > 0:
                from .. import native

                if native.available():
                    disp, valid = native.speckle_filter(
                        disp, valid, max_diff=cfg.speckleRange,
                        min_region=cfg.speckleWindowSize)
                else:
                    # Same semantics, pure Python (slow) — never silently
                    # drop a configured filter just because the toolchain
                    # is missing.
                    if not getattr(self, "_warned_speckle", False):
                        from ..utils import logging as _log

                        _log.warn(
                            "speckleWindowSize=%d but the native library is "
                            "unavailable (%s); using the slow pure-Python "
                            "speckle filter", cfg.speckleWindowSize,
                            native.build_error())
                        self._warned_speckle = True
                    disp, valid = native.speckle_filter_numpy(
                        disp, valid, max_diff=cfg.speckleRange,
                        min_region=cfg.speckleWindowSize)
        elif cfg.stereoAlgorithm.upper() == "OPENCV_BM":
            import cv2

            bm = cv2.StereoBM_create(numDisparities=cfg.numDisparities,
                                     blockSize=cfg.sadWindowSize)
            disp16 = bm.compute((left * 255).astype(np.uint8),
                                (right * 255).astype(np.uint8))
            disp = disp16.astype(np.float32) / 16.0
            valid = disp > cfg.minDisparity
        else:
            raise ValueError(f"unknown stereoAlgorithm {cfg.stereoAlgorithm}")
        fx = float(self.camera.fx)
        b = float(self.camera.baseline)
        with np.errstate(divide="ignore"):
            depth = np.where(valid & (disp > 0), fx * b / np.maximum(disp, 1e-6), 0.0)
        ok = valid & (depth > self.cfg.minDepth) & (depth < self.cfg.maxDepth)
        return depth.astype(np.float32), ok

    def _cache_path(self, idx: int) -> str:
        return os.path.join(self._cache_dir, f"{idx:06d}.npz")

    def seek(self, i: int) -> None:
        """Resume support: tell the prefetch pipeline to start at frame i
        instead of producing (and caching) the whole prefix."""
        if self._native is not None:
            self._native.seek(i)

    def get_frame(self, i: int) -> StereoFrame:
        idx = self.indices[i]
        # Per-frame cache hits serve even from a PARTIAL cache (an
        # interrupted first sweep must not recompute the frames it already
        # paid for); the prefetch pipeline is resynced past the served
        # frame so its sequential consumption stays aligned.
        if self._cache_dir is not None and os.path.exists(
                self._cache_path(idx)):
            left = _imread_gray(self.left_files[idx])
            z = np.load(self._cache_path(idx))
            if self._native is not None:
                self._native.seek(i + 1)
            return StereoFrame(image=left, depth=z["depth"],
                               depth_valid=z["ok"],
                               timestamp=float(self.times[idx]), index=idx)
        if self._native is not None:
            # Native pipeline: decode + stereo + depth were computed by the
            # prefetch workers while the previous window was being solved.
            left, depth, ok = self._native.get(i)
        else:
            left = _imread_gray(self.left_files[idx])
            right = _imread_gray(self.right_files[idx])
            depth, ok = self._compute_depth(left, right)
        if self._cache_dir is not None:
            # tmp + replace: a concurrent run over the same cache must
            # never load a half-written file.
            path = self._cache_path(idx)
            if not os.path.exists(path):
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as f:
                    np.savez_compressed(f, depth=depth.astype(np.float32),
                                        ok=np.asarray(ok, bool))
                os.replace(tmp, path)
        return StereoFrame(image=left, depth=depth, depth_valid=ok,
                           timestamp=float(self.times[idx]), index=idx)

    def __iter__(self):
        for i in range(len(self)):
            yield self.get_frame(i)


@dataclass
class PrecomputedDepthDataset:
    """Frames from arrays already in memory (synthetic tests, custom data)."""

    images: list
    depths: list
    camera: Camera
    times: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.images)

    @property
    def image_shape(self):
        return np.asarray(self.images[0]).shape

    def get_frame(self, i: int) -> StereoFrame:
        img = np.asarray(self.images[i], np.float32)
        depth = np.asarray(self.depths[i], np.float32)
        t = float(self.times[i]) if self.times is not None else float(i)
        return StereoFrame(image=img, depth=depth, depth_valid=depth > 0,
                           timestamp=t, index=i)

    def __iter__(self):
        for i in range(len(self)):
            yield self.get_frame(i)


def create_dataset(cfg: PBAConfig):
    """Factory mirroring `Dataset::Create(ConfigFile)` (pb:src/dataset.cc)."""
    return KittiStereoDataset(
        root=cfg.dataDir, sequence=cfg.sequence, cfg=cfg,
        first_frame=cfg.firstFrame, num_frames=cfg.numFrames,
    )
