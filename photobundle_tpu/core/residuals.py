"""Photometric residuals and analytic Jacobians — the innermost hot path.

JAX replacement for the reference's Ceres autodiff cost functor
(`AutoDiffCostFunction<DescriptorError, DYNAMIC, 6, 3>` over a
`BiCubicInterpolator`; pb:src/photobundle.cc, SURVEY.md section 3.4). The
reference evaluates residuals point-by-point inside Ceres with autodiff; here
the entire (point x frame x pixel) residual tensor is evaluated in one fused
batched program with hand-derived Jacobians.

Residual model (SURVEY.md 3.4). For point p with world position X, reference
descriptor patch d (mean-normalized), observed in window frame f with pose
T_wc[f], patch offsets {o_k}:

    y      = T_wc[f]^{-1} . X                      (camera-frame point)
    u      = pi(K y)                               (projected pixel)
    s_ck   = I_c(u + o_k)                          (bilinear sample)
    r_ck   = (s_ck - mean_k s_ck) - d_ck           (brightness-normalized)

Jacobian structure — the key fact: patches are fronto-parallel, so every
pixel of a patch moves with the same projected displacement du/dtheta. The
per-observation Jacobian therefore FACTORS:

    dr/dtheta = Gc @ A,   Gc = patch-mean-centered sampled gradients (D, 2)
                          A  = du/d[pose(6) | point(3)]          (2, 9)

so residual/Jacobian/Gauss-Newton assembly is batched dense algebra instead
of per-pixel autodiff. Pose Jacobians use the right-multiplicative
local parameterization T <- T @ exp(xi) (geometry/se3.py):

    dy/drho = -I,  dy/domega = [y]_x,  dy/dX = R_wc^T

Robustness: Huber loss on the per-observation residual norm, folded in as
IRLS whitening sqrt(w) (reference: ceres::HuberLoss(robustThreshold)).

Inverse-depth prior (improvement over the reference): an optional extra
residual row per (point, reference-frame) observation,

    r_prior = w_d * s * (1/z_ref(X, T_ref) - q_seed),   s = fx * baseline

pulling each point's INVERSE depth in its reference frame toward its stereo
seed. The scale s converts to disparity-pixel units: stereo disparity noise
is approximately constant in disparity, hence constant in inverse depth
(sigma_q = sigma_d / (fx b)) — so this weighting is statistically calibrated
(a z-ratio prior would overweight far points, whose seeds are worst).
The reference relies on a frozen first pose + LM damping to hold the
monocular scale gauge, which compounds scale drift across sliding windows;
the prior anchors scale to stereo *per window* with no compounding. It is
appended as one extra pseudo-pixel of the residual tensor (D -> D+1), so
the Schur/LM machinery is untouched. Disabled when weight == 0.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..image import interp
from ..image import patches as patches_mod


class Residuals(NamedTuple):
    r: jax.Array        # (N, W, D) whitened residuals (zero where invalid)
    j_pose: jax.Array   # (N, W, D, 6) whitened d r / d pose twist
    j_point: jax.Array  # (N, W, D, 3) whitened d r / d X
    valid: jax.Array    # (N, W) observation validity
    cost: jax.Array     # () robust cost sum_{p,f} rho(||r||^2)
    n_residuals: jax.Array  # () number of valid observations


ROBUST_KINDS = ("huber", "cauchy", "tukey", "none")


def robust_weight(r_norm2: jax.Array, delta: float, kind: str = "huber"):
    """IRLS weight w = rho'(s) and loss rho(s) on s = ||r||^2.

    Ceres loss-function conventions (reference: photobundle passes
    ceres::HuberLoss(robustThreshold); the others are the standard Ceres
    family, offered because photometric outliers — occlusions, specular
    highlights — are heavier-tailed than Huber's linear tail assumes):

      huber:  rho = s                        if s <= delta^2
                    2 delta sqrt(s) - delta^2     otherwise      (Ceres HuberLoss)
      cauchy: rho = delta^2 log(1 + s/delta^2)                   (Ceres CauchyLoss)
      tukey:  rho = delta^2/3 (1 - (1 - s/delta^2)^3) capped at
                    delta^2/3 for s > delta^2 — gross outliers get
                    EXACTLY zero weight                          (Ceres TukeyLoss)
      none:   rho = s (plain least squares)                      (Ceres TrivialLoss)

    All satisfy rho(s) ~ s for small s, so `delta` keeps one meaning across
    kinds: the per-observation residual norm where downweighting starts.
    The solver whitens by sqrt(w) (first-order IRLS, Triggs et al.), so only
    w = rho'(s) and rho are needed — no second-order loss corrections.
    """
    if kind == "none":
        return jnp.ones_like(r_norm2), r_norm2
    b = delta * delta
    if kind == "huber":
        rn = jnp.sqrt(jnp.maximum(r_norm2, 1e-20))
        w = jnp.minimum(1.0, delta / rn)
        rho = jnp.where(rn <= delta, r_norm2, 2.0 * delta * rn - b)
        return w, rho
    if kind == "cauchy":
        u = r_norm2 / b
        return 1.0 / (1.0 + u), b * jnp.log1p(u)
    if kind == "tukey":
        t = jnp.maximum(1.0 - r_norm2 / b, 0.0)
        return t * t, (b / 3.0) * (1.0 - t * t * t)
    raise ValueError(f"unknown robust loss '{kind}' (want one of {ROBUST_KINDS})")


def _normalize_sampled(s, g, mode: str):
    """Apply the patch normalization to warped samples and propagate it
    EXACTLY through to the sampled gradients (so Jacobians stay analytic):

      mean:   c = s - s̄,                dc/dθ = G_c = g - ḡ
      affine: ŝ = c / n, n = sqrt(Σc²+ε²), dŝ/dθ = (G_c - ŝ(ŝᵀG_c)) / n

    The affine form keeps the rank-2 J = G·A factoring (G_eff is still
    (D, 2)), so the compressed statistics pipeline is unchanged.
    s: (..., C, P); g: (..., C, P, 2) or None (cost-only pass).
    """
    if mode == "off":
        return s, g
    s = s - jnp.mean(s, axis=-1, keepdims=True)
    if g is not None:
        g = g - jnp.mean(g, axis=-2, keepdims=True)
    if mode == "mean":
        return s, g
    eps = patches_mod.AFFINE_NORM_EPS
    n = jnp.sqrt(jnp.sum(s * s, axis=-1, keepdims=True) + eps * eps)
    s = s / n                                             # ŝ
    if g is not None:
        proj = jnp.sum(s[..., None] * g, axis=-2, keepdims=True)  # ŝᵀG_c
        g = (g - s[..., None] * proj) / n[..., None]
    return s, g


def _observation_geometry(cam, t_wc_f, x_world):
    """Per-(frame) geometry for all points: camera point y, pixel u, and the
    A = du/d[pose|point] (2, 9) chain. Shapes: x_world (N, 3).

    All tiny matmuls are unrolled into broadcast multiplies: exact f32
    elementwise arithmetic whatever the matmul precision setting (see
    photobundle_tpu/__init__.py), and no batched-matmul launch per
    point."""
    t_cw = se3.se3_inverse(t_wc_f)
    r_cw = t_cw[:3, :3]
    # y = R_cw x + t_cw — unrolled (9 fused multiplies on (N,) lanes).
    y = (x_world[:, None, :] * r_cw[None, :, :]).sum(-1) + t_cw[:3, 3]
    uv, in_front = cam_mod.project(cam, y)                # (N, 2), (N,)
    jproj = cam_mod.project_jacobian(cam, y)              # (N, 2, 3)
    # dy/d(pose twist) under T <- T @ exp(xi): [-I | hat(y)]  -> (N, 3, 6)
    n = x_world.shape[0]
    dy_dpose = jnp.concatenate(
        [jnp.broadcast_to(-jnp.eye(3, dtype=y.dtype), (n, 3, 3)), se3.hat(y)], axis=-1
    )
    a_pose = (jproj[..., :, :, None] * dy_dpose[..., None, :, :]).sum(-2)
    a_point = (jproj[..., :, :, None] * r_cw[None, None, :, :]).sum(-2)
    return y, uv, in_front, jnp.concatenate([a_pose, a_point], axis=-1)  # A: (N, 2, 9)


# The patch-grid warp clamp (cfg.patchWarp — see patch_warp_frame).
PATCH_SCALE_MIN = 0.5
PATCH_SCALE_MAX = 2.0


def patch_warp_ref_geometry(t_wc, x_world, ref_slot):
    """Per-point REFERENCE-frame geometry for patch warping (cfg.patchWarp),
    evaluated at the CURRENT estimates.

    Returns (z_ref (N,), r_wc_ref (N, 3, 3)): each point's depth in its own
    reference frame and the reference camera's world rotation. z_ref carries
    the sentinel -1.0 where ref_slot < 0 (ref frame not in the window) —
    downstream warp factors become the identity there.

    Why CURRENT estimates and not the stereo seed: the round-4 golden
    measured the frozen-seed variant (rho = z_seed/z_f, z_seed from point
    creation) DEGRADING ATE (+14.1% vs +29.5% without it — BASELINE.md
    "Round-4 sharp-texture re-measurement"). Mechanism: once the optimizer
    refines a point's depth away from its seed, the reference frame itself
    gets sampled at rho != 1 while its template was extracted at grid scale
    exactly 1 — the photometric term then pulls inverse depth back toward
    the noisy stereo seed, an unmodeled prior that biases translation (ATE)
    even as the cross-frame scale correction helps rotation. Evaluating
    BOTH depths at the current estimate (rho_f = z_ref(X)/z_f(X)) makes the
    reference-frame factor identically 1 — no pull — and the cross-frame
    factor asymptotically correct.

    `t_wc` must be the FULL replicated window poses (under frames sharding
    the ref frame may live on another shard; poses are replicated, images
    are not — lm_solve computes this before slicing frames).
    """
    w = t_wc.shape[0]
    t_cw = jax.vmap(se3.se3_inverse)(t_wc)                 # (W, 4, 4)
    safe = jnp.clip(ref_slot, 0, w - 1)
    row2 = t_cw[safe, 2]                                   # (N, 4)
    z_ref = jnp.einsum("nj,nj->n", row2[:, :3], x_world) + row2[:, 3]
    z_ref = jnp.where(ref_slot >= 0, z_ref, -1.0)
    r_wc_ref = t_wc[safe][:, :3, :3]                       # (N, 3, 3)
    return z_ref, r_wc_ref


def patch_warp_frame(mode: str, cam, t_wc_f, y, z_ref, r_wc_ref):
    """Patch-grid warp factor for ONE window frame at the linearization
    point: (N,) scale rho for mode='scale', (N, 2, 2) affine M for
    mode='affine'. Identity wherever z_ref <= 0 (no ref frame in window /
    behind camera).

    The reference's residual model samples the SAME fixed fronto-parallel
    pixel grid in every frame (pb:src/photobundle.cc; SURVEY.md 3.4); under
    camera motion a surface patch's appearance warps, which sets the
    measured accuracy floor on sharp texture (BASELINE.md "Texture-
    sharpness probe"). Model: back-project the template offsets o at depth
    z_ref on a fronto-parallel plane in the REFERENCE camera, transport to
    frame f, project:

        M_f = Jproj(y_f) @ (R_cw_f @ R_wc_ref)[:, :2] @ diag(z_ref/fx,
                                                             z_ref/fy)

    mode='scale' keeps only the isotropic part via the depth ratio
    rho_f = z_ref/z_f (exact for pure translation along the optical axis);
    mode='affine' uses the full 2x2 M — anisotropic scale, shear and
    rotation from inter-frame rotation and projection obliquity. Both are
    the identity in the reference frame by construction. The overall scale
    sqrt|det M| (resp. rho) is clamped to [0.5, 2]: beyond a 2x footprint
    change the planar model itself has broken down (ZNCC tracking drops
    such observations). Jacobians hold the warp FROZEN at the
    linearization point — d(warp)/d(theta) terms scale with |o| * dz/z,
    second order at patch-radius offsets; LM accept/reject tests the TRUE
    warped cost, so step quality is all the freeze can affect.
    """
    z_f = jnp.maximum(y[:, 2], 1e-6)
    if mode == "scale":
        rho = jnp.clip(z_ref / z_f, PATCH_SCALE_MIN, PATCH_SCALE_MAX)
        return jnp.where(z_ref > 0, rho, 1.0)
    if mode != "affine":
        raise ValueError(f"unknown patch warp mode '{mode}'")
    r_cw = se3.se3_inverse(t_wc_f)[:3, :3]
    rel = jnp.einsum("ij,njk->nik", r_cw, r_wc_ref)        # (N, 3, 3)
    f_xy = jnp.asarray([cam.fx, cam.fy], dtype=z_ref.dtype)
    dy = rel[:, :, :2] * (z_ref[:, None, None] / f_xy)     # (N, 3, 2)
    jproj = cam_mod.project_jacobian(cam, y)               # (N, 2, 3)
    m = jnp.einsum("nij,njk->nik", jproj, dy)              # (N, 2, 2)
    det = jnp.abs(m[:, 0, 0] * m[:, 1, 1] - m[:, 0, 1] * m[:, 1, 0])
    s = jnp.sqrt(jnp.maximum(det, 1e-12))
    m = m * (jnp.clip(s, PATCH_SCALE_MIN, PATCH_SCALE_MAX)
             / s)[:, None, None]
    eye = jnp.broadcast_to(jnp.eye(2, dtype=m.dtype), m.shape)
    # Near-singular M (patch viewed edge-on): the clip/s renormalization
    # would AMPLIFY the junk directions by up to clip_min/s — unbounded as
    # det -> 0 (round-5 review). Far below the clamp floor the planar
    # model carries no usable direction; fall back to the reference's
    # fixed grid (identity) instead.
    ok = ((z_ref > 0) & (s > 0.1 * PATCH_SCALE_MIN))[:, None, None]
    return jnp.where(ok, m, eye)


def _sample_patches(channels_f, grads_f, uv, offsets, gradient_mode: str,
                    scale=None):
    """Sample patch values and gradients for one frame.

    channels_f (C, H, W), grads_f (C, H, W, 2), uv (N, 2), offsets (P, 2).
    scale: optional per-point patch-grid warp (cfg.patchWarp): (N,)
    isotropic scale or (N, 2, 2) affine map applied to the offset grid.
    Returns s (N, C, P), g (N, C, P, 2), valid (N,).
    """
    if scale is not None:
        if scale.ndim == 1:
            offsets = scale[:, None, None] * offsets      # (N, P, 2)
        else:
            offsets = jnp.einsum("nij,pj->npi", scale, offsets)
    pts = uv[:, None, :] + offsets                        # (N, P, 2)
    if gradient_mode == "bicubic":
        # Ceres-parity mode: Catmull-Rom surface with its exact gradient
        # (the reference samples through ceres::BiCubicInterpolator).
        s, g, ok = interp.bicubic_with_grad(channels_f, pts)
        s = jnp.moveaxis(s, 0, 1)
        g = jnp.moveaxis(g, 0, 1)
    elif gradient_mode == "exact":
        s, g, ok = interp.bilinear_with_grad(channels_f, pts)   # (C,N,P), (C,N,P,2)
        s = jnp.moveaxis(s, 0, 1)
        g = jnp.moveaxis(g, 0, 1)
    else:
        c, h, w = channels_f.shape
        # One fused gather over C*3 planes: values + both gradient components.
        stacked = jnp.concatenate(
            [channels_f, grads_f[..., 0], grads_f[..., 1]], axis=0
        )                                                  # (3C, H, W)
        vals, ok = interp.bilinear(stacked, pts)          # (3C, N, P)
        vals = jnp.moveaxis(vals, 0, 1)                   # (N, 3C, P)
        s = vals[:, :c]
        g = jnp.stack([vals[:, c:2 * c], vals[:, 2 * c:]], axis=-1)  # (N, C, P, 2)
    return s, g, jnp.all(ok, axis=-1)                     # valid: (N,)


def evaluate(cam, t_wc, x_world, patch, channels, grads, obs_mask,
             offsets, huber_delta: float, gradient_mode: str = "sampled",
             with_jacobians: bool = True,
             depth_prior: tuple | None = None,
             normalize: bool = True,
             robust_kind: str = "huber",
             patch_warp: tuple | None = None) -> Residuals:
    """Evaluate all (point, window-frame) photometric residuals at once.

    Args:
      cam: Camera (at the refinement pyramid level).
      t_wc: (W, 4, 4) window poses.
      x_world: (N, 3) point positions.
      patch: (N, C, P) mean-normalized reference descriptors.
      channels / grads: (W, C, H, Wi) / (W, C, H, Wi, 2) window images.
      obs_mask: (N, W) bool — active & observed (from tracking).
      offsets: (P, 2) patch offset grid.
      huber_delta: Huber threshold on the per-observation residual norm.
      with_jacobians: False for the cheap cost-only pass (LM candidate test).
      depth_prior: optional (ref_slot (N,) int32, inv_depth_seed (N,),
        weight float) — appends the inverse-depth prior pseudo-pixel on each
        point's reference-frame observation (see module docstring).
      normalize: per-patch brightness normalization (cfg.normalizePatches,
        the reference's per-patch mean removal). False compares raw
        intensities; `patch` must then be raw (un-normalized) too. The
        Jacobian centering is skipped in lockstep (d/dtheta of the patch
        mean is the gradient mean).
      patch_warp: optional (mode, z_ref, r_wc_ref) — per-observation patch
        grid warping (cfg.patchWarp), with mode 'scale' | 'affine' and
        (z_ref, r_wc_ref) from patch_warp_ref_geometry evaluated at the
        SAME (t_wc, x_world) passed here (self-consistent: identity in the
        reference frame). Frame f samples at u + warp_f(o_k) — see
        patch_warp_frame for the model, the clamp, and the frozen-warp
        Jacobian argument. Sampled gradients are taken at the warped
        positions, so dr/du stays exact and the rank-2 J = G @ A factoring
        is preserved. LM's accept/reject tests the TRUE cost, so the
        approximation affects step quality only, never correctness.

    Returns Residuals with whitened r/J (zeros where invalid).
    """
    n, w = obs_mask.shape
    c = patch.shape[1]
    p = patch.shape[2]
    d = c * p
    use_prior = depth_prior is not None and depth_prior[2] > 0.0

    norm_mode = patches_mod.norm_mode(normalize)

    def per_frame(f, t_wc_f, channels_f, grads_f, obs_f):
        y, uv, in_front, a = _observation_geometry(cam, t_wc_f, x_world)
        rho = (patch_warp_frame(patch_warp[0], cam, t_wc_f, y,
                                patch_warp[1], patch_warp[2])
               if patch_warp is not None else None)
        s, g, in_bounds = _sample_patches(channels_f, grads_f, uv, offsets,
                                          gradient_mode, scale=rho)
        valid = obs_f & in_front & in_bounds              # (N,)
        s, g = _normalize_sampled(s, g if with_jacobians else None,
                                  norm_mode)
        r = (s - patch).reshape(n, d)                     # (N, D)
        if with_jacobians:
            j = g.reshape(n, d, 2) @ a                    # (N, D, 9)
        else:
            j = jnp.zeros((n, d, 9), r.dtype)
        if use_prior:
            ref_slot, q_seed, wd = depth_prior
            z = jnp.maximum(y[:, 2], 1e-6)
            is_ref = (ref_slot == f) & valid
            m = is_ref.astype(r.dtype)
            # r_prior = wd * (1/z - q_seed), wd already includes the fx*b
            # disparity-unit scale (see engine): constant inverse-depth
            # weighting, matching stereo noise statistics.
            r_p = wd * (1.0 / z - q_seed) * m             # (N,)
            r = jnp.concatenate([r, r_p[:, None]], axis=1)
            if with_jacobians:
                # d r_p / d z = -wd / z^2 ; chain with dy/dpose = [-I|hat(y)],
                # dy/dX = R_cw (rebuild the e_z row directly).
                coef = (-wd / (z * z)) * m                # (N,)
                t_cw = se3.se3_inverse(t_wc_f)
                r_cw = t_cw[:3, :3]
                dz_dpose = jnp.concatenate(
                    [jnp.broadcast_to(-jnp.eye(3, dtype=r.dtype)[2], (n, 3)),
                     se3.hat(y)[:, 2, :]], axis=-1)       # (N, 6)
                dz_dx = jnp.broadcast_to(r_cw[2], (n, 3))  # (N, 3)
                j_p = coef[:, None] * jnp.concatenate([dz_dpose, dz_dx], -1)
                j = jnp.concatenate([j, j_p[:, None, :]], axis=1)
            else:
                j = jnp.concatenate([j, jnp.zeros((n, 1, 9), r.dtype)], axis=1)
        return r, j, valid

    r, j, valid = jax.vmap(per_frame, in_axes=(0, 0, 0, 0, 1), out_axes=(1, 1, 1))(
        jnp.arange(w, dtype=jnp.int32), t_wc, channels, grads, obs_mask
    )  # r (N, W, D'), j (N, W, D', 9), valid (N, W)
    if use_prior:
        d = d + 1

    vf = valid.astype(r.dtype)
    r = r * vf[..., None]
    r_norm2 = jnp.sum(r * r, axis=-1)                     # (N, W)
    w_huber, rho = robust_weight(r_norm2, huber_delta, robust_kind)
    sw = jnp.sqrt(w_huber) * vf
    r = r * sw[..., None]
    if with_jacobians:
        j = j * sw[..., None, None]
        j_pose, j_point = j[..., :6], j[..., 6:]
    else:
        j_pose = jnp.zeros((n, w, d, 6), r.dtype)
        j_point = jnp.zeros((n, w, d, 3), r.dtype)
    cost = 0.5 * jnp.sum(rho * vf)
    return Residuals(
        r=r, j_pose=j_pose, j_point=j_point, valid=valid,
        cost=cost, n_residuals=jnp.sum(valid.astype(jnp.int32)),
    )


def cost_only(cam, t_wc, x_world, patch, channels, grads, obs_mask, offsets,
              huber_delta: float, gradient_mode: str = "sampled",
              depth_prior: tuple | None = None, normalize: bool = True,
              robust_kind: str = "huber",
              patch_warp: tuple | None = None):
    """Robust cost without Jacobians — used for LM step acceptance."""
    res = evaluate(cam, t_wc, x_world, patch, channels, grads, obs_mask,
                   offsets, huber_delta, gradient_mode, with_jacobians=False,
                   depth_prior=depth_prior, normalize=normalize,
                   robust_kind=robust_kind, patch_warp=patch_warp)
    return res.cost, res.n_residuals


class CompressedResiduals(NamedTuple):
    """Rank-2-factored residual/Jacobian statistics.

    Because every pixel of a fronto-parallel patch shares the same projected
    displacement, the per-observation Jacobian factors as J = G @ A with
    G (D, 2) the centered sampled gradients and A (2, 9) the geometry chain.
    Gauss-Newton therefore only needs the tiny sufficient statistics

        gtg = w * G^T G   (2, 2)      J^T J = A^T gtg A
        gtr = w * G^T r   (2,)        J^T r = A^T gtr

    (w = Huber IRLS weight x validity). The (N, W, D, 9) Jacobian tensor of
    the naive path never materializes — at D = 25 this cuts the HBM traffic
    of normal-equation assembly by ~12x. The optional inverse-depth prior
    row does not share the A chain, so it is carried as an explicit rank-1
    (jp, rp) pair (whitened by sqrt(w)).

    LAYOUT: the POINT axis is MINOR (last), so every statistic is a dense
    (W, N) plane and the normal-equation assembly (core/schur.py) runs as
    fused elementwise reductions over contiguous memory."""

    a: jax.Array        # (W, 2, 9, N) du/d[pose(6) | point(3)]
    gtg: jax.Array      # (W, 2, 2, N) whitened gradient Gram
    gtr: jax.Array      # (W, 2, N)    whitened G^T r
    jp: jax.Array       # (W, 9, N)    whitened prior Jacobian row
    rp: jax.Array       # (W, N)       whitened prior residual
    valid: jax.Array    # (N, W)
    cost: jax.Array
    n_residuals: jax.Array


def _observation_geometry_pm(cam, t_wc, x_world):
    """Point-MINOR observation geometry for all window frames at once.

    The vmapped per-frame `_observation_geometry` builds point-major
    (N, 2, 9)/(N, 3, 6) intermediates and transposes them at the end. Here
    every quantity is a small stack of dense (W, N) planes and the A-chain
    is written closed form (zero entries of jproj/hat dropped).

    Returns y (W, 3, N), uv (W, 2, N), in_front (W, N), a (W, 2, 9, N),
    r_cw (W, 3, 3)."""
    t_cw = jax.vmap(se3.se3_inverse)(t_wc)                 # (W, 4, 4)
    r_cw = t_cw[:, :3, :3]
    tt = t_cw[:, :3, 3]
    xt = x_world.T                                         # (3, N)
    y = (r_cw[:, :, 0, None] * xt[0] + r_cw[:, :, 1, None] * xt[1]
         + r_cw[:, :, 2, None] * xt[2]) + tt[:, :, None]   # (W, 3, N)
    xc, yc, zc_raw = y[:, 0], y[:, 1], y[:, 2]             # (W, N)
    in_front = zc_raw > 1e-6
    zc = jnp.maximum(zc_raw, 1e-6)
    iz = 1.0 / zc
    iz2 = iz * iz
    u = cam.fx * (xc / zc) + cam.cx
    v = cam.fy * (yc / zc) + cam.cy
    uv = jnp.stack([u, v], axis=1)                         # (W, 2, N)
    zero = jnp.zeros_like(xc)
    j00 = cam.fx * iz
    j02 = -cam.fx * xc * iz2
    j11 = cam.fy * iz
    j12 = -cam.fy * yc * iz2
    # A = jproj @ [-I | hat(y) | R_cw], zeros of jproj/hat dropped:
    #   hat(y) = [[0,-z,y],[z,0,-x],[-y,x,0]]
    r2 = r_cw[..., None]                                   # (W, 3, 3, 1)
    row0 = jnp.stack([
        -j00, zero, -j02,
        -j02 * yc, -j00 * zc_raw + j02 * xc, j00 * yc,
        j00 * r2[:, 0, 0] + j02 * r2[:, 2, 0],
        j00 * r2[:, 0, 1] + j02 * r2[:, 2, 1],
        j00 * r2[:, 0, 2] + j02 * r2[:, 2, 2]], axis=1)    # (W, 9, N)
    row1 = jnp.stack([
        zero, -j11, -j12,
        j11 * zc_raw - j12 * yc, j12 * xc, -j11 * xc,
        j11 * r2[:, 1, 0] + j12 * r2[:, 2, 0],
        j11 * r2[:, 1, 1] + j12 * r2[:, 2, 1],
        j11 * r2[:, 1, 2] + j12 * r2[:, 2, 2]], axis=1)
    a = jnp.stack([row0, row1], axis=1)                    # (W, 2, 9, N)
    return y, uv, in_front, a, r_cw


def _prior_terms_pm(r_cw, y, valid, depth_prior, dtype):
    """Inverse-depth prior rows, point-minor: rp (W, N), jp (W, 9, N).
    Same math as the per-frame prior in `evaluate_compressed`
    (dz/dpose = [-e_z | hat(y) row 2], dz/dX = R_cw row 2)."""
    w = y.shape[0]
    ref_slot, q_seed, wd = depth_prior
    z = jnp.maximum(y[:, 2], 1e-6)                         # (W, N)
    f_idx = jnp.arange(w, dtype=ref_slot.dtype)[:, None]
    m = ((ref_slot[None, :] == f_idx) & valid).astype(dtype)
    rp = wd * (1.0 / z - q_seed[None]) * m
    coef = (-wd / (z * z)) * m
    xc, yc = y[:, 0], y[:, 1]
    zero = jnp.zeros_like(z)
    r2 = r_cw[:, 2]                                        # (W, 3)
    jp = jnp.stack([
        zero, zero, -coef,
        coef * (-yc), coef * xc, zero,
        coef * r2[:, 0, None], coef * r2[:, 1, None], coef * r2[:, 2, None]],
        axis=1)                                            # (W, 9, N)
    return rp, jp


TRITON_MODES = ("sampled",)


def triton_supports(gradient_mode: str, normalize, patch_warp) -> bool:
    """Whether the fused sampler (ops/triton_stats) implements this mode:
    fixed-grid bilinear 'sampled' gradients under 'mean' or 'off'
    normalization. Bicubic, exact-surface gradients, patch warps and
    'affine' normalization run on the XLA path."""
    return (gradient_mode in TRITON_MODES and patch_warp is None
            and patches_mod.norm_mode(normalize) in ("mean", "off"))


def _evaluate_compressed_triton(cam, t_wc, x_world, patch, channels, grads,
                                obs_mask, huber_delta, depth_prior,
                                normalize, robust_kind, interpret):
    """evaluate_compressed with sampling, descriptor subtraction, centring
    and the six per-observation sums fused in one kernel
    (ops/triton_stats); the geometry, validity and robust weights are the
    same point-minor XLA algebra as the other path's."""
    from ..ops import triton_stats

    n, w = obs_mask.shape
    pr = (int(round(patch.shape[2] ** 0.5)) - 1) // 2
    use_prior = depth_prior is not None and depth_prior[2] > 0.0
    img_h, img_w = channels.shape[-2], channels.shape[-1]
    y_pm, uv, in_front, a, r_cw = _observation_geometry_pm(cam, t_wc, x_world)
    # Full bilinear support of every patch pixel — the same float sums the
    # XLA path tests (interp.bilinear on u + o_k).
    u, v = uv[:, 0], uv[:, 1]
    in_bounds = ((u + (-pr) >= 0) & (u + pr <= img_w - 1)
                 & (v + (-pr) >= 0) & (v + pr <= img_h - 1))
    valid = obs_mask.T & in_front & in_bounds              # (W, N)
    if use_prior:
        rp, jp = _prior_terms_pm(r_cw, y_pm, valid, depth_prior, uv.dtype)
    else:
        rp = jnp.zeros((w, n), uv.dtype)
        jp = jnp.zeros((w, 9, n), uv.dtype)
    g00, g01, g11, gxr, gyr, rnorm2 = triton_stats.patch_stats(
        channels, grads, uv, patch, radius=pr,
        center=(patches_mod.norm_mode(normalize) == "mean"),
        interpret=interpret)
    gtg = jnp.stack([jnp.stack([g00, g01], axis=1),
                     jnp.stack([g01, g11], axis=1)], axis=1)  # (W, 2, 2, N)
    gtr = jnp.stack([gxr, gyr], axis=1)                       # (W, 2, N)
    vf = valid.astype(gtg.dtype)
    rnorm2 = (rnorm2 + rp * rp) * vf
    w_huber, rho = robust_weight(rnorm2, huber_delta, robust_kind)
    wv = w_huber * vf
    sw = jnp.sqrt(w_huber) * vf
    return CompressedResiduals(
        a=a, gtg=gtg * wv[:, None, None, :], gtr=gtr * wv[:, None, :],
        jp=jp * sw[:, None, :], rp=rp * sw, valid=valid.T,
        cost=0.5 * jnp.sum(rho * vf),
        n_residuals=jnp.sum(valid.astype(jnp.int32)))


def evaluate_compressed(cam, t_wc, x_world, patch, channels, grads, obs_mask,
                        offsets, huber_delta: float,
                        gradient_mode: str = "sampled",
                        depth_prior: tuple | None = None,
                        backend: str = "xla",
                        interpret: bool = False,
                        normalize: bool = True,
                        robust_kind: str = "huber",
                        patch_warp: tuple | None = None) -> CompressedResiduals:
    """Like `evaluate` but returns the factored Gauss-Newton statistics.

    Produces bitwise-equivalent normal equations (see
    schur.build_normal_equations_compressed) at a fraction of the memory
    traffic. This is the production path; `evaluate` remains as the oracle.

    backend='xla' is the gather-based path for every sampling mode.
    backend='triton' fuses sampling and the per-observation sums in one GPU
    kernel (ops/triton_stats) for the modes `triton_supports` lists;
    `interpret=True` runs that kernel in the Pallas interpreter (tests on a
    host without a GPU).
    """
    if backend == "triton":
        if not triton_supports(gradient_mode, normalize, patch_warp):
            raise ValueError(
                "backend 'triton' implements fixed-grid 'sampled' gradients "
                "with 'mean'/'off' normalization only; use backend 'xla'")
        return _evaluate_compressed_triton(
            cam, t_wc, x_world, patch, channels, grads, obs_mask,
            huber_delta, depth_prior, normalize, robust_kind, interpret)
    if backend != "xla":
        raise ValueError(f"unknown backend '{backend}'")
    n, w = obs_mask.shape
    use_prior = depth_prior is not None and depth_prior[2] > 0.0

    norm_mode = patches_mod.norm_mode(normalize)

    def per_frame(f, t_wc_f, channels_f, grads_f, obs_f):
        y, uv, in_front, a = _observation_geometry(cam, t_wc_f, x_world)
        rho = (patch_warp_frame(patch_warp[0], cam, t_wc_f, y,
                                patch_warp[1], patch_warp[2])
               if patch_warp is not None else None)
        s, g, in_bounds = _sample_patches(channels_f, grads_f, uv, offsets,
                                          gradient_mode, scale=rho)
        valid = obs_f & in_front & in_bounds                  # (N,)
        s, g = _normalize_sampled(s, g, norm_mode)
        r = (s - patch).reshape(n, -1)                        # (N, D)
        g_c = g.reshape(n, -1, 2)
        gtg = jnp.einsum("ndi,ndj->nij", g_c, g_c)            # (N, 2, 2)
        gtr = jnp.einsum("ndi,nd->ni", g_c, r)                # (N, 2)
        r_norm2 = jnp.sum(r * r, axis=-1)                     # (N,)
        if use_prior:
            ref_slot, q_seed, wd = depth_prior
            z = jnp.maximum(y[:, 2], 1e-6)
            m = ((ref_slot == f) & valid).astype(r.dtype)
            rp = wd * (1.0 / z - q_seed) * m                  # (N,)
            coef = (-wd / (z * z)) * m
            t_cw = se3.se3_inverse(t_wc_f)
            r_cw = t_cw[:3, :3]
            dz_dpose = jnp.concatenate(
                [jnp.broadcast_to(-jnp.eye(3, dtype=r.dtype)[2], (n, 3)),
                 se3.hat(y)[:, 2, :]], axis=-1)               # (N, 6)
            dz_dx = jnp.broadcast_to(r_cw[2], (n, 3))         # (N, 3)
            jp = coef[:, None] * jnp.concatenate([dz_dpose, dz_dx], -1)
            r_norm2 = r_norm2 + rp * rp
        else:
            rp = jnp.zeros((n,), r.dtype)
            jp = jnp.zeros((n, 9), r.dtype)
        return a, gtg, gtr, jp, rp, valid, r_norm2

    a, gtg, gtr, jp, rp, valid, r_norm2 = jax.vmap(
        per_frame, in_axes=(0, 0, 0, 0, 1), out_axes=0
    )(jnp.arange(w, dtype=jnp.int32), t_wc, channels, grads, obs_mask)

    # Frame-major (W, N, ...) out of the vmap; whiten then emit the
    # point-minor layout (see CompressedResiduals docstring).
    vf = valid.astype(gtg.dtype)                              # (W, N)
    r_norm2 = r_norm2 * vf
    w_huber, rho = robust_weight(r_norm2, huber_delta, robust_kind)
    wv = w_huber * vf            # J^T J / J^T r carry the squared whitening
    sw = jnp.sqrt(w_huber) * vf
    return CompressedResiduals(
        a=jnp.moveaxis(a, 1, -1),                             # (W, 2, 9, N)
        gtg=jnp.moveaxis(gtg, 1, -1) * wv[:, None, None, :],
        gtr=jnp.moveaxis(gtr, 1, -1) * wv[:, None, :],
        jp=jnp.moveaxis(jp, 1, -1) * sw[:, None, :],
        rp=rp * sw,
        valid=valid.T,                                        # (N, W)
        cost=0.5 * jnp.sum(rho * vf),
        n_residuals=jnp.sum(valid.astype(jnp.int32)),
    )
