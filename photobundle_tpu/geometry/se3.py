"""SE(3) / SO(3) Lie-group operations, batched and jit-friendly.

JAX replacement for the reference's pose handling
(reference: pb:src/pose_utils.*, and the Ceres angle-axis parameterization
used by the photometric cost in pb:src/photobundle.cc). Everything here is
pure JAX, float32-first, and broadcasts over leading batch dimensions so that
window-sized pose stacks ([W, 4, 4]) flow through `vmap`/`jit` unchanged.

Conventions
-----------
- Poses are 4x4 row-major homogeneous matrices, `T_wc` = world-from-camera
  (the KITTI odometry convention: the pose file stores world-from-camera).
- Twists are 6-vectors `[rho | omega]` (translation first, rotation second).
- `exp` uses the full closed-form SE(3) exponential (Rodrigues + left
  Jacobian V), with small-angle Taylor guards that are branch-free
  (`jnp.where`), so it is safe under `jit`/`grad`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jax.Array) -> jax.Array:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc_coeffs(theta2: jax.Array):
    """Branch-free (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3)."""
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta))
    return a, b, c


def so3_exp(w: jax.Array) -> jax.Array:
    """SO(3) exponential (Rodrigues): (..., 3) -> (..., 3, 3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    a, b, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: jax.Array) -> jax.Array:
    """SO(3) logarithm: (..., 3, 3) -> (..., 3). Safe for angles in [0, pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    w_raw = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    sin_t = jnp.sin(theta)
    # theta / sin(theta), Taylor-guarded near zero.
    scale = jnp.where(theta < 1e-4, 1.0 + theta * theta / 6.0, theta / jnp.where(sin_t == 0, 1.0, sin_t))
    w_small = w_raw * scale[..., None]
    # Near theta = pi the sin-based formula degrades; recover the axis from
    # the diagonal of R = I + 2*sin^2(t/2)*(aa^T - I) ... use symmetric part.
    near_pi = theta > 3.0
    S = 0.5 * (R + jnp.swapaxes(R, -1, -2)) - jnp.eye(3, dtype=R.dtype)
    # aa^T = S / (1 - cos t) + I ... diag gives axis magnitudes.
    denom = jnp.where(jnp.abs(1.0 - cos_t) < 1e-12, 1.0, 1.0 - cos_t)
    aaT_diag = jnp.clip(
        jnp.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], axis=-1) / denom[..., None] + 1.0,
        0.0,
        1.0,
    )
    axis_abs = jnp.sqrt(aaT_diag)
    # Signs from the skew part (may vanish exactly at pi; fall back to +).
    sign = jnp.where(w_raw >= 0, 1.0, -1.0)
    w_pi = axis_abs * sign * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w_small)


def se3_exp(xi: jax.Array) -> jax.Array:
    """SE(3) exponential: twist (..., 6) [rho|omega] -> (..., 4, 4)."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    a, b, c = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = jnp.eye(3, dtype=xi.dtype)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return _rt_to_mat(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """SE(3) logarithm: (..., 4, 4) -> twist (..., 6) [rho|omega]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = jnp.sum(w * w, axis=-1)
    a, b, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = jnp.eye(3, dtype=T.dtype)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2  (standard closed form)
    coef = jnp.where(
        theta2 < 1e-8,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - a / (2.0 * b)) / jnp.where(theta2 == 0, 1.0, theta2),
    )
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    rho = jnp.einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([rho, w], axis=-1)


def _rt_to_mat(R: jax.Array, t: jax.Array) -> jax.Array:
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_inverse(T: jax.Array) -> jax.Array:
    """Inverse of a rigid transform: (..., 4, 4) -> (..., 4, 4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return _rt_to_mat(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: jax.Array, x: jax.Array) -> jax.Array:
    """Apply (..., 4, 4) to points (..., 3) with broadcasting."""
    return jnp.einsum("...ij,...j->...i", T[..., :3, :3], x) + T[..., :3, 3]


def retract_right(T: jax.Array, xi: jax.Array) -> jax.Array:
    """Right-multiplicative retraction: T <- T @ exp(xi).

    This is the local parameterization the LM solver optimizes over; its
    Jacobians (see core/residuals.py) are the simple camera-frame forms
    d(x_cam)/d(rho) = -I and d(x_cam)/d(omega) = [x_cam]_x for the inverse
    pose action, matching the reference's 6-dof per-frame pose blocks.
    """
    return T @ se3_exp(xi)


def rotation_geodesic_distance(Ra: jax.Array, Rb: jax.Array) -> jax.Array:
    """Angle (rad) between rotations, batched."""
    RtR = jnp.swapaxes(Ra, -1, -2) @ Rb
    trace = RtR[..., 0, 0] + RtR[..., 1, 1] + RtR[..., 2, 2]
    return jnp.arccos(jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0))


def adjoint(T: jax.Array) -> jax.Array:
    """SE3 adjoint Ad_T (6x6, batched over leading dims) mapping twists
    between frames: Ad_T @ xi changes the frame a right-perturbation acts
    in. Twist convention [rho | omega] (translation first, matching
    se3_exp/se3_log)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    z = jnp.zeros_like(R)
    top = jnp.concatenate([R, hat(t) @ R], axis=-1)     # d rho
    bot = jnp.concatenate([z, R], axis=-1)              # d omega
    return jnp.concatenate([top, bot], axis=-2)
