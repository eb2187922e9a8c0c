"""ctypes bindings for the native host runtime (pb_native.cpp).

The shared library is built on first use with the system toolchain (g++,
libpng, zlib, OpenMP — all baked into the image); no pip/apt involved.
Everything here is host-side I/O + preprocessing — the device compute path
stays in JAX. Callers must tolerate `available() == False`
(e.g. missing toolchain) and fall back to the pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "pb_native.cpp")
_LIB = os.path.join(_DIR, "libpb_native.so")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> str | None:
    # Build to a private file and rename it into place: processes that
    # start together (test workers, spawned workers) may all build, and
    # none may load a library another is still writing.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        "-std=c++17", _SRC, "-o", tmp, "-lpng", "-lz", "-lpthread",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except Exception as e:  # toolchain missing
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return proc.stderr[-2000:]
    os.replace(tmp, _LIB)
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build_error = _build()
            if _build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as e:   # built elsewhere, or a runtime library missing
            _build_error = f"cannot load {_LIB}: {e}"
            return None
        lib.pb_png_size.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
        lib.pb_png_size.restype = ctypes.c_int
        lib.pb_png_read_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int]
        lib.pb_png_read_gray.restype = ctypes.c_int
        lib.pb_block_match.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
        lib.pb_block_match.restype = ctypes.c_int
        lib.pb_prefilter_xsobel.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_float]
        lib.pb_prefilter_xsobel.restype = ctypes.c_int
        lib.pb_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int]
        lib.pb_speckle_filter.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int]
        lib.pb_speckle_filter.restype = ctypes.c_int
        lib.pb_sgbm.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.pb_sgbm.restype = ctypes.c_int
        lib.pb_loader_create.restype = ctypes.c_void_p
        lib.pb_loader_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
        lib.pb_loader_get.restype = ctypes.c_int
        lib.pb_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.pb_loader_destroy.restype = None
        lib.pb_loader_seek.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pb_loader_seek.restype = None
        lib.pb_omp_max_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def png_size(path: str) -> tuple[int, int]:
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.pb_png_size(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc:
        raise IOError(f"pb_png_size({path}) -> {rc}")
    return h.value, w.value


def imread_gray(path: str) -> np.ndarray:
    """float32 grayscale in [0, 1] — native replacement for PIL/cv2 decode."""
    lib = _load()
    h, w = png_size(path)
    out = np.empty((h, w), np.float32)
    rc = lib.pb_png_read_gray(path.encode(), _fptr(out), w, h)
    if rc:
        raise IOError(f"pb_png_read_gray({path}) -> {rc}")
    return out


def prefilter_xsobel(img: np.ndarray, cap: float) -> np.ndarray:
    """cv::StereoBM PREFILTER_XSOBEL analog; same kernel as
    image/stereo.prefilter_xsobel."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape
    out = np.empty((h, w), np.float32)
    rc = lib.pb_prefilter_xsobel(_fptr(img), _fptr(out), h, w, cap)
    if rc:
        raise RuntimeError(f"pb_prefilter_xsobel -> {rc}")
    return out


def semi_global_match(left: np.ndarray, right: np.ndarray, *,
                      num_disparities: int = 64, min_disparity: int = 1,
                      sad_radius: int = 2, p1: float = 0.03, p2: float = 0.4,
                      uniqueness_ratio: float = 0.97,
                      texture_threshold: float = 0.02,
                      prefilter_cap: float = 0.0):
    """OpenMP 4-path SGM; same semantics as image/stereo.semi_global_match."""
    lib = _load()
    left = np.ascontiguousarray(left, np.float32)
    right = np.ascontiguousarray(right, np.float32)
    if prefilter_cap > 0.0:
        left = prefilter_xsobel(left, prefilter_cap)
        right = prefilter_xsobel(right, prefilter_cap)
    h, w = left.shape
    disp = np.empty((h, w), np.float32)
    valid = np.empty((h, w), np.uint8)
    rc = lib.pb_sgbm(
        _fptr(left), _fptr(right), h, w, num_disparities, min_disparity,
        sad_radius, p1, p2, uniqueness_ratio, texture_threshold, _fptr(disp),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc:
        raise RuntimeError(f"pb_sgbm -> {rc}")
    return disp, valid.astype(bool)


def speckle_filter(disp: np.ndarray, valid: np.ndarray, *,
                   max_diff: float = 1.0, min_region: int = 50):
    """cv::filterSpeckles: invalidate small connected disparity components
    (in place on copies; returns the filtered (disp, valid))."""
    lib = _load()
    disp = np.ascontiguousarray(disp, np.float32).copy()
    valid = np.ascontiguousarray(valid, np.uint8).copy()
    h, w = disp.shape
    lib.pb_speckle_filter(
        _fptr(disp), valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, max_diff, min_region)
    return disp, valid.astype(bool)


def speckle_filter_numpy(disp: np.ndarray, valid: np.ndarray, *,
                         max_diff: float = 1.0, min_region: int = 50):
    """Pure-Python fallback for pb_speckle_filter when the native library
    is unavailable: identical DFS traversal (same neighbor order, same
    popped-pixel similarity test), so the same config yields the same depth
    validity regardless of toolchain availability. ~1-2 s/frame at KITTI
    resolution — the native path is the production one."""
    disp = np.ascontiguousarray(disp, np.float32).copy()
    valid = np.ascontiguousarray(valid, bool).copy()
    h, w = disp.shape
    d = disp.ravel()
    v = valid.ravel()
    label = np.full(h * w, -1, np.int32)
    cur = 0
    for seed in range(h * w):
        if not v[seed] or label[seed] >= 0:
            continue
        stack = [seed]
        label[seed] = cur
        members = []
        while stack:
            p = stack.pop()
            members.append(p)
            y, x = divmod(p, w)
            dp = d[p]
            for q in ((p - w if y > 0 else -1),
                      (p + w if y < h - 1 else -1),
                      (p - 1 if x > 0 else -1),
                      (p + 1 if x < w - 1 else -1)):
                if q < 0 or not v[q] or label[q] >= 0:
                    continue
                if abs(d[q] - dp) > max_diff:
                    continue
                label[q] = cur
                stack.append(q)
        if len(members) < min_region:
            idx = np.asarray(members, np.int64)
            v[idx] = False
            d[idx] = 0.0
        cur += 1
    return d.reshape(h, w), v.reshape(h, w)


def block_match(left: np.ndarray, right: np.ndarray, *,
                num_disparities: int = 64, min_disparity: int = 1,
                sad_radius: int = 4, uniqueness_ratio: float = 0.97,
                texture_threshold: float = 0.02,
                prefilter_cap: float = 0.0):
    """OpenMP SAD block matcher; same semantics as image/stereo.block_match."""
    lib = _load()
    left = np.ascontiguousarray(left, np.float32)
    right = np.ascontiguousarray(right, np.float32)
    if prefilter_cap > 0.0:
        left = prefilter_xsobel(left, prefilter_cap)
        right = prefilter_xsobel(right, prefilter_cap)
    h, w = left.shape
    disp = np.empty((h, w), np.float32)
    valid = np.empty((h, w), np.uint8)
    rc = lib.pb_block_match(
        _fptr(left), _fptr(right), h, w, num_disparities, min_disparity,
        sad_radius, uniqueness_ratio, texture_threshold, _fptr(disp),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc:
        raise RuntimeError(f"pb_block_match -> {rc}")
    return disp, valid.astype(bool)


class PrefetchingLoader:
    """Threaded decode + stereo + depth pipeline over a frame list.

    Workers stay `prefetch_ahead` frames in front of the consumer, so PNG
    decode and block matching for frame t+1..t+k overlap the solver's work
    on frame t (the reference does all of this serially on the main
    thread)."""

    def __init__(self, left_paths, right_paths, *, num_disparities: int,
                 min_disparity: int, sad_radius: int,
                 uniqueness_ratio: float, texture_threshold: float,
                 fx: float, baseline: float, min_depth: float,
                 max_depth: float, n_threads: int = 2,
                 prefetch_ahead: int = 4, algorithm: str = "BM",
                 speckle_size: int = 0, speckle_range: float = 1.0,
                 prefilter_cap: float = 0.0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        assert len(left_paths) == len(right_paths)
        self._n = len(left_paths)
        self.shape = png_size(left_paths[0])
        h, w = self.shape
        self._lbuf = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in left_paths])
        self._rbuf = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in right_paths])
        algo = 1 if algorithm.upper() == "SGBM" else 0
        self._handle = lib.pb_loader_create(
            self._lbuf, self._rbuf, self._n, h, w, num_disparities,
            min_disparity, sad_radius, algo, uniqueness_ratio,
            texture_threshold, speckle_size, speckle_range, prefilter_cap,
            fx, baseline, min_depth, max_depth, n_threads, prefetch_ahead)
        self._lib = lib

    def __len__(self):
        return self._n

    def seek(self, i: int):
        """Resume support: skip production of frames before i."""
        self._lib.pb_loader_seek(self._handle, i)

    def get(self, i: int):
        """(image, depth, depth_valid) for frame i; blocks until ready."""
        h, w = self.shape
        img = np.empty((h, w), np.float32)
        depth = np.empty((h, w), np.float32)
        ok = np.empty((h, w), np.uint8)
        rc = self._lib.pb_loader_get(
            self._handle, i, _fptr(img), _fptr(depth),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc:
            raise IOError(f"frame {i} failed to load (status {rc})")
        return img, depth, ok.astype(bool)

    def close(self):
        if self._handle:
            self._lib.pb_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
