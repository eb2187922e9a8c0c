"""Pinhole camera model: calibration, projection, and analytic Jacobians.

JAX replacement for the reference's `Calibration` struct and the
projection math inside the photometric cost functor (reference:
pb:src/photobundle.cc `DescriptorError`-style functor; pb:src/dataset.cc
`Calibration{fx,fy,cx,cy,b}` parsed from KITTI calib.txt).

All functions broadcast over leading batch dims and are float32 by default.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Camera(NamedTuple):
    """Pinhole intrinsics + stereo baseline (meters).

    Stored as plain scalars so a `Camera` is a pytree of leaves and can be
    closed over or passed through `jit` boundaries freely.
    """

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    baseline: jax.Array  # stereo baseline in meters (0.0 for monocular)

    @staticmethod
    def create(fx, fy, cx, cy, baseline=0.0, dtype=jnp.float32) -> "Camera":
        return Camera(*(jnp.asarray(v, dtype=dtype) for v in (fx, fy, cx, cy, baseline)))

    def matrix(self) -> jax.Array:
        """3x3 intrinsic matrix K."""
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx], -1),
                jnp.stack([z, self.fy, self.cy], -1),
                jnp.stack([z, z, o], -1),
            ],
            -2,
        )

    def scaled(self, s: float) -> "Camera":
        """Intrinsics for a pyramid level scaled by factor `s` (<1 = coarser).

        Follows the standard half-pixel-centered convention:
        c' = (c + 0.5) * s - 0.5, which keeps pixel centers aligned across
        levels for the 2x average-pool downsampling in image/pyramid.py.
        """
        s = jnp.asarray(s, dtype=self.fx.dtype)
        return Camera(
            fx=self.fx * s,
            fy=self.fy * s,
            cx=(self.cx + 0.5) * s - 0.5,
            cy=(self.cy + 0.5) * s - 0.5,
            baseline=self.baseline,
        )


def project(cam: Camera, x_cam: jax.Array, eps: float = 1e-6):
    """Project camera-frame points (..., 3) -> pixel coords (..., 2) [x, y].

    Returns (uv, valid_z) where valid_z marks points safely in front of the
    camera. Z is clamped away from zero so gradients stay finite; invalid
    projections must be masked by the caller (they always are — see
    core/residuals.py).
    """
    x, y, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    valid = z > eps
    zc = jnp.maximum(z, eps)
    u = cam.fx * (x / zc) + cam.cx
    v = cam.fy * (y / zc) + cam.cy
    return jnp.stack([u, v], axis=-1), valid


def project_jacobian(cam: Camera, x_cam: jax.Array, eps: float = 1e-6) -> jax.Array:
    """d(u,v)/d(x_cam): (..., 3) -> (..., 2, 3), analytic.

    [ fx/z    0    -fx x/z^2 ]
    [  0    fy/z   -fy y/z^2 ]
    """
    x, y, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    zc = jnp.maximum(z, eps)
    iz = 1.0 / zc
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    row0 = jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2], axis=-1)
    row1 = jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def backproject(cam: Camera, uv: jax.Array, depth: jax.Array) -> jax.Array:
    """Pixels (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def disparity_to_depth(cam: Camera, disparity: jax.Array, min_disparity: float = 1e-3):
    """Z = fx * b / d. Invalid (d <= min) -> depth 0 and valid=False.

    Reference: pb:src/imgproc.cc `disparityToDepth` (OpenMP loop); here a
    single fused elementwise XLA op.
    """
    valid = disparity > min_disparity
    d = jnp.maximum(disparity, min_disparity)
    depth = cam.fx * cam.baseline / d
    return jnp.where(valid, depth, 0.0), valid
