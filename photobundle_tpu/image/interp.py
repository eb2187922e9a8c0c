"""Bilinear image sampling with analytic spatial gradients.

JAX replacement for Ceres' `Grid2D` + `BiCubicInterpolator`
(reference: pb:src/photobundle.cc photometric cost; the reference gets image
derivatives for free from autodiff through the bicubic interpolator). Per the
north-star spec (BASELINE.json), this framework uses *bilinear* interpolation
with hand-derived gradients.

Two gradient modes (config.gradientMode):
- 'exact': the true derivative of the bilinear surface (piecewise constant
  per cell). Matches `jax.grad` of the forward sampling to float precision —
  this is what the Jacobian unit tests pin down.
- 'sampled': bilinearly interpolate precomputed central-difference gradient
  images (DSO-style). Smoother objective, better LM convergence; the engine
  default.

Implementation notes: sampling is a gather. We flatten (y, x) into a
single linear index and use `jnp.take` on the flattened image, which XLA
lowers to a single 1D gather. All out-of-bounds coordinates are clamped and
reported via a validity mask; values remain finite so downstream masking is
safe under `grad`.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _gather2d(img: jax.Array, iy: jax.Array, ix: jax.Array) -> jax.Array:
    """img: (H, W) or (C, H, W); iy/ix: integer arrays of identical shape S.

    Returns (S,) or (C,) + S values. Indices must already be in-bounds.
    """
    H, W = img.shape[-2], img.shape[-1]
    lin = iy * W + ix
    if img.ndim == 2:
        return jnp.take(img.reshape(-1), lin, axis=0)
    flat = img.reshape(img.shape[0], -1)
    return jnp.take(flat, lin, axis=1).reshape(img.shape[0], *iy.shape)


def bilinear(img: jax.Array, uv: jax.Array, eps_margin: float = 0.0):
    """Bilinear sample. img: (H, W) or (C, H, W); uv: (..., 2) as [x, y].

    Returns (values, valid):
      values: (...,) for 2D img, (C, ...) for 3D img
      valid:  (...,) bool — True where the full 2x2 support is inside the
              image (and `eps_margin` pixels away from the border).
    """
    H, W = img.shape[-2], img.shape[-1]
    x = uv[..., 0]
    y = uv[..., 1]
    valid = (
        (x >= eps_margin)
        & (x <= W - 1 - eps_margin)
        & (y >= eps_margin)
        & (y <= H - 1 - eps_margin)
    )
    xc = jnp.clip(x, 0.0, W - 1.000001)
    yc = jnp.clip(y, 0.0, H - 1.000001)
    x0 = jnp.floor(xc).astype(jnp.int32)
    y0 = jnp.floor(yc).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    fx = xc - x0.astype(img.dtype)
    fy = yc - y0.astype(img.dtype)

    v00 = _gather2d(img, y0, x0)
    v01 = _gather2d(img, y0, x1)
    v10 = _gather2d(img, y1, x0)
    v11 = _gather2d(img, y1, x1)

    w00 = (1.0 - fx) * (1.0 - fy)
    w01 = fx * (1.0 - fy)
    w10 = (1.0 - fx) * fy
    w11 = fx * fy
    values = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
    return values, valid


def bilinear_with_grad(img: jax.Array, uv: jax.Array):
    """Bilinear sample + the exact gradient of the bilinear surface.

    Returns (values, grad, valid) where grad[..., 0] = d/dx, grad[..., 1] = d/dy
    (shape (C, ..., 2) for 3D img). Matches jax.grad of `bilinear` exactly in
    the interior of each pixel cell.
    """
    H, W = img.shape[-2], img.shape[-1]
    x = uv[..., 0]
    y = uv[..., 1]
    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    xc = jnp.clip(x, 0.0, W - 1.000001)
    yc = jnp.clip(y, 0.0, H - 1.000001)
    x0 = jnp.floor(xc).astype(jnp.int32)
    y0 = jnp.floor(yc).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    fx = xc - x0.astype(img.dtype)
    fy = yc - y0.astype(img.dtype)

    v00 = _gather2d(img, y0, x0)
    v01 = _gather2d(img, y0, x1)
    v10 = _gather2d(img, y1, x0)
    v11 = _gather2d(img, y1, x1)

    values = (
        v00 * (1.0 - fx) * (1.0 - fy)
        + v01 * fx * (1.0 - fy)
        + v10 * (1.0 - fx) * fy
        + v11 * fx * fy
    )
    gx = (v01 - v00) * (1.0 - fy) + (v11 - v10) * fy
    gy = (v10 - v00) * (1.0 - fx) + (v11 - v01) * fx
    grad = jnp.stack([gx, gy], axis=-1)
    return values, grad, valid


def _catmull_rom_weights(t: jax.Array):
    """Catmull-Rom weights for taps at offsets (-1, 0, 1, 2), t in [0, 1).

    The same cubic Hermite spline Ceres' BiCubicInterpolator evaluates
    (reference: pb:src/photobundle.cc samples channels through
    ceres::BiCubicInterpolator<Grid2D>; SURVEY.md 3.4)."""
    t2 = t * t
    t3 = t2 * t
    w0 = 0.5 * (-t3 + 2.0 * t2 - t)
    w1 = 0.5 * (3.0 * t3 - 5.0 * t2 + 2.0)
    w2 = 0.5 * (-3.0 * t3 + 4.0 * t2 + t)
    w3 = 0.5 * (t3 - t2)
    return w0, w1, w2, w3


def _catmull_rom_dweights(t: jax.Array):
    """d/dt of the Catmull-Rom weights (for analytic spatial gradients)."""
    t2 = t * t
    d0 = 0.5 * (-3.0 * t2 + 4.0 * t - 1.0)
    d1 = 0.5 * (9.0 * t2 - 10.0 * t)
    d2 = 0.5 * (-9.0 * t2 + 8.0 * t + 1.0)
    d3 = 0.5 * (3.0 * t2 - 2.0 * t)
    return d0, d1, d2, d3


def bicubic_with_grad(img: jax.Array, uv: jax.Array):
    """Catmull-Rom bicubic sample + analytic surface gradient.

    img: (H, W) or (C, H, W); uv (..., 2) as [x, y]. Returns
    (values, grad (..., 2), valid) like bilinear_with_grad. The 4x4 support
    needs one pixel of margin on every side; `valid` is True where the full
    support is interior. Out-of-range taps are clamped (finite values,
    masked downstream). C1-continuous — smoother LM convergence than
    bilinear at ~4x the sampling cost; this is the Ceres-parity mode."""
    H, W = img.shape[-2], img.shape[-1]
    x = uv[..., 0]
    y = uv[..., 1]
    valid = (x >= 1) & (x <= W - 3) & (y >= 1) & (y <= H - 3)
    xc = jnp.clip(x, 1.0, jnp.asarray(W - 3, img.dtype) - 1e-5)
    yc = jnp.clip(y, 1.0, jnp.asarray(H - 3, img.dtype) - 1e-5)
    x0 = jnp.floor(xc).astype(jnp.int32)
    y0 = jnp.floor(yc).astype(jnp.int32)
    tx = xc - x0.astype(img.dtype)
    ty = yc - y0.astype(img.dtype)

    wx = _catmull_rom_weights(tx)
    wy = _catmull_rom_weights(ty)
    dwx = _catmull_rom_dweights(tx)
    dwy = _catmull_rom_dweights(ty)

    # Row-interpolate 4 rows (value + x-derivative), then column-combine.
    rows = []
    drows = []
    for j in range(4):
        yj = jnp.clip(y0 + (j - 1), 0, H - 1)
        taps = [_gather2d(img, yj, jnp.clip(x0 + (i - 1), 0, W - 1))
                for i in range(4)]
        rows.append(sum(w * p for w, p in zip(wx, taps)))
        drows.append(sum(d * p for d, p in zip(dwx, taps)))
    values = sum(w * r for w, r in zip(wy, rows))
    gx = sum(w * r for w, r in zip(wy, drows))
    gy = sum(d * r for d, r in zip(dwy, rows))
    grad = jnp.stack([gx, gy], axis=-1)
    return values, grad, valid


def image_gradients(img: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Central-difference gradients (gx, gy), replicated borders.

    Reference: pb:src/imgproc.cc `imgradient` (OpenMP loop over rows); here a
    pair of fused XLA shifts. img: (..., H, W).
    """
    left = jnp.concatenate([img[..., :, :1], img[..., :, :-1]], axis=-1)
    right = jnp.concatenate([img[..., :, 1:], img[..., :, -1:]], axis=-1)
    up = jnp.concatenate([img[..., :1, :], img[..., :-1, :]], axis=-2)
    down = jnp.concatenate([img[..., 1:, :], img[..., -1:, :]], axis=-2)
    gx = 0.5 * (right - left)
    gy = 0.5 * (down - up)
    return gx, gy
