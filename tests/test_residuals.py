"""Residual/Jacobian correctness: analytic J vs jax autodiff (the SURVEY.md
'hard part': must match jax.grad through the interpolation)."""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from photobundle_tpu.core import residuals as res_mod
from photobundle_tpu.geometry import se3
from photobundle_tpu.geometry.camera import Camera
from photobundle_tpu.image import interp, patches

from synthetic import make_sequence


def setup_problem(rng, n_pts=12, w=3, radius=2, shape=(96, 144)):
    """Build a (points, frames, images) problem on the synthetic sphere.

    Points spread across the FULL image: pose observability demands wide
    FOV coverage (narrow point spreads leave near-null pose directions that
    interpolation bias exploits — found empirically, see tests/test_lm.py).
    """
    cam, images, depths, poses = make_sequence(rng, n_frames=w, shape=shape)
    offsets = patches.patch_offsets(radius)
    channels = jnp.asarray(np.stack(images))[:, None]            # (W, 1, H, Wi)
    gx, gy = interp.image_gradients(channels)
    grads = jnp.stack([gx, gy], axis=-1)

    # Points: backproject full-image pixels of frame 0 with true depth
    # (margin covers patch + per-frame optical flow over the window).
    h, wi = images[0].shape
    uv = rng.uniform([18, 18], [wi - 18, h - 18], size=(n_pts, 2)).astype(np.float32)
    z = np.stack([depths[0][int(v), int(u)] for u, v in uv])
    from photobundle_tpu.geometry import camera as cam_mod

    x_cam = cam_mod.backproject(cam, jnp.asarray(np.floor(uv)), jnp.asarray(z))
    x_world = se3.transform_points(jnp.asarray(poses[0]), x_cam)

    patch, ok = patches.extract_patches(channels[0], jnp.asarray(np.floor(uv)), offsets)
    patch = patches.mean_normalize(patch)
    assert bool(jnp.all(ok))

    obs = jnp.ones((n_pts, w), bool)
    t_wc = jnp.asarray(poses)
    return cam, t_wc, x_world, patch, channels, grads, obs, offsets


def test_forward_residual_near_zero_at_ground_truth(rng):
    """At ground-truth poses/points the photometric residual is tiny."""
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng)
    r = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off,
                         huber_delta=1e9, gradient_mode="exact")
    assert bool(jnp.all(r.valid))
    # Rendering is exact on frame 0 (patch source); other frames see the
    # same plane so residuals are interpolation error only.
    rms = float(jnp.sqrt(jnp.mean(r.r ** 2)))
    assert rms < 0.02, rms


def test_jacobians_match_autodiff(rng):
    """Analytic (factored G @ A) Jacobians == jax.jacfwd through the full
    residual, in 'exact' gradient mode, to ~1e-5."""
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=6)
    out = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off,
                           huber_delta=1e9, gradient_mode="exact")

    def residual_fn(xi_all, x_all):
        t = se3.retract_right(t_wc, xi_all)            # (W, 4, 4)
        r = res_mod.evaluate(cam, t, x_all, patch, ch, g, obs, off,
                             huber_delta=1e9, gradient_mode="exact",
                             with_jacobians=False)
        return r.r                                      # (N, W, D)

    w = t_wc.shape[0]
    xi0 = jnp.zeros((w, 6))
    j_pose_auto = jax.jacfwd(residual_fn, argnums=0)(xi0, x)   # (N, W, D, W, 6)
    j_point_auto = jax.jacfwd(residual_fn, argnums=1)(xi0, x)  # (N, W, D, N, 3)

    n, _, d = out.r.shape
    # Extract the block-diagonal entries: residual (p, f) depends only on
    # pose f and point p.
    jp_auto = np.stack([np.asarray(j_pose_auto[:, f, :, f, :]) for f in range(w)], 1)
    jx_auto = np.stack([np.asarray(j_point_auto[p, :, :, p, :]) for p in range(n)], 0)

    np.testing.assert_allclose(np.asarray(out.j_pose), jp_auto, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(out.j_point), jx_auto, atol=2e-4, rtol=1e-3)

    # And the cross blocks of autodiff are exactly zero (sparsity pattern).
    for f in range(w):
        for g2 in range(w):
            if f != g2:
                assert float(np.abs(np.asarray(j_pose_auto[:, f, :, g2, :])).max()) == 0.0


def test_huber_whitening(rng):
    """With a small delta, large residual blocks are downweighted so that
    ||r_whitened||^2 <= delta * ||r_raw|| asymptotically."""
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng)
    # Perturb points to create large residuals.
    x_bad = x + 0.05
    big = res_mod.evaluate(cam, t_wc, x_bad, patch, ch, g, obs, off,
                           huber_delta=1e9, gradient_mode="exact")
    small = res_mod.evaluate(cam, t_wc, x_bad, patch, ch, g, obs, off,
                             huber_delta=1e-3, gradient_mode="exact")
    assert float(small.cost) < float(big.cost)
    n_big = np.asarray(jnp.sum(big.r ** 2, axis=-1))
    n_small = np.asarray(jnp.sum(small.r ** 2, axis=-1))
    assert (n_small <= n_big + 1e-9).all()


def test_cost_matches_residuals(rng):
    """With huge delta (no robustness), cost == 0.5 * sum r^2."""
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng)
    out = res_mod.evaluate(cam, t_wc, x + 0.01, patch, ch, g, obs, off,
                           huber_delta=1e9, gradient_mode="exact")
    np.testing.assert_allclose(float(out.cost), 0.5 * float(jnp.sum(out.r ** 2)),
                               rtol=1e-5)


def test_invalid_observations_zeroed(rng):
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng)
    obs = obs.at[0, :].set(False)
    out = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off,
                           huber_delta=1e9, gradient_mode="exact")
    assert float(jnp.abs(out.r[0]).max()) == 0.0
    assert float(jnp.abs(out.j_pose[0]).max()) == 0.0
    assert not bool(out.valid[0].any())


def test_sampled_mode_close_to_exact(rng):
    """'sampled' gradients (smoothed) agree with 'exact' to first order on
    smooth images — sanity that the default engine mode is well-scaled."""
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng)
    a = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off,
                         huber_delta=1e9, gradient_mode="exact")
    b = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off,
                         huber_delta=1e9, gradient_mode="sampled")
    np.testing.assert_allclose(np.asarray(a.r), np.asarray(b.r), atol=1e-6)
    # Gradients differ by interpolation scheme but should correlate strongly.
    ja = np.asarray(a.j_pose).reshape(-1)
    jb = np.asarray(b.j_pose).reshape(-1)
    corr = np.corrcoef(ja, jb)[0, 1]
    assert corr > 0.85, corr


@pytest.mark.slow
def test_bicubic_jacobians_match_autodiff(rng):
    """gradient_mode='bicubic' (Ceres-parity sampling): the factored
    analytic Jacobians must match jax.grad through the Catmull-Rom
    interpolation, as the reference's autodiff does."""
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=5)
    x = x + 0.01

    def residual_fn(xi_all, x_all):
        t = jnp.einsum("wij,wjk->wik", t_wc, se3.se3_exp(xi_all))
        out = res_mod.evaluate(cam, t, x_all, patch, ch, g, obs, off,
                               huber_delta=1e9, gradient_mode="bicubic")
        return out.r

    out = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off,
                           huber_delta=1e9, gradient_mode="bicubic")
    xi0 = jnp.zeros((t_wc.shape[0], 6))
    j_pose_auto = jax.jacfwd(residual_fn, argnums=0)(xi0, x)
    j_point_auto = jax.jacfwd(residual_fn, argnums=1)(xi0, x)
    n, w, d = out.r.shape
    for p in range(n):
        for f in range(w):
            np.testing.assert_allclose(
                np.asarray(out.j_pose[p, f]),
                np.asarray(j_pose_auto[p, f, :, f, :]), atol=2e-4,
                err_msg=f"pose jac p={p} f={f}")
            np.testing.assert_allclose(
                np.asarray(out.j_point[p, f]),
                np.asarray(j_point_auto[p, f, :, p, :]), atol=2e-4,
                err_msg=f"point jac p={p} f={f}")


def test_bicubic_compressed_matches_full(rng):
    from photobundle_tpu.core import schur

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=7)
    kw = dict(huber_delta=0.05, gradient_mode="bicubic")
    full = res_mod.evaluate(cam, t_wc, x + 0.01, patch, ch, g, obs, off, **kw)
    comp = res_mod.evaluate_compressed(cam, t_wc, x + 0.01, patch, ch, g,
                                       obs, off, **kw)
    np.testing.assert_allclose(float(comp.cost), float(full.cost), rtol=1e-5)
    eq_a = schur.to_point_major(schur.build_normal_equations_compressed(comp))
    eq_b = schur.build_normal_equations(full)
    for name in ("hpp", "hpc", "hcc", "bp", "bc"):
        np.testing.assert_allclose(np.asarray(getattr(eq_a, name)),
                                   np.asarray(getattr(eq_b, name)),
                                   atol=2e-3, rtol=1e-4, err_msg=name)


def test_gauge_invariance_of_cost(rng):
    """Property (SURVEY.md section 4): the photometric cost is invariant
    under a global rigid transform of all poses and points (the gauge
    freedom the frozen poses pin down)."""
    from photobundle_tpu.geometry import se3 as se3_mod

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=10, w=3)
    out0 = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off,
                            huber_delta=0.05)
    gauge = se3_mod.se3_exp(jnp.asarray(
        rng.standard_normal(6).astype(np.float32) * 0.3))
    t2 = jnp.einsum("ij,wjk->wik", gauge, t_wc)
    x2 = se3_mod.transform_points(gauge, x)
    out1 = res_mod.evaluate(cam, t2, x2, patch, ch, g, obs, off,
                            huber_delta=0.05)
    np.testing.assert_allclose(float(out1.cost), float(out0.cost), rtol=2e-3)
    assert int(out1.n_residuals) == int(out0.n_residuals)


def test_brightness_invariance_with_normalization(rng):
    """Per-frame constant exposure bias is EXACTLY removed by the per-patch
    mean normalization (cfg.normalizePatches, the reference's brightness
    normalization: pb:src/photobundle.cc DescriptorFrame): residuals and
    Jacobians are unchanged when every window image gains a different
    constant offset. Without normalization the bias leaks into the
    residual."""
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng)
    bias = jnp.asarray(
        rng.uniform(0.05, 0.25, size=(ch.shape[0],)).astype(np.float32))
    ch_b = ch + bias[:, None, None, None]
    # Central-difference gradients of (I + c) equal those of I: reuse g.
    kw = dict(huber_delta=0.05, gradient_mode="sampled")
    r0 = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off, **kw)
    r1 = res_mod.evaluate(cam, t_wc, x, patch, ch_b, g, obs, off, **kw)
    np.testing.assert_allclose(np.asarray(r1.r), np.asarray(r0.r), atol=1e-5)
    np.testing.assert_allclose(np.asarray(r1.j_pose), np.asarray(r0.j_pose),
                               atol=1e-5)
    np.testing.assert_allclose(float(r1.cost), float(r0.cost), rtol=1e-5)

    # Sanity: with normalize=False the same bias shifts the (unwhitened)
    # residuals by ~the bias itself — the exposure leaks into the cost.
    # huber_delta=1e9 disables the IRLS whitening that would otherwise
    # shrink the shift (w ~ delta/||r||).
    u0 = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off,
                          huber_delta=1e9, normalize=False)
    u1 = res_mod.evaluate(cam, t_wc, x, patch, ch_b, g, obs, off,
                          huber_delta=1e9, normalize=False)
    dmax = float(np.abs(np.asarray(u1.r) - np.asarray(u0.r)).max())
    assert dmax > 0.5 * float(bias.min()), (dmax, float(bias.min()))


def test_unnormalized_jacobians_match_autodiff(rng):
    """normalize=False skips the gradient centering in lockstep with the
    sample centering — the analytic J must still equal autodiff of the
    (unnormalized) residual."""
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=5)
    kw = dict(huber_delta=1e9, gradient_mode="exact", normalize=False)
    out = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off, **kw)

    def residual_fn(xi_all, x_all):
        t = se3.retract_right(t_wc, xi_all)
        r = res_mod.evaluate(cam, t, x_all, patch, ch, g, obs, off,
                             with_jacobians=False, **kw)
        return r.r

    w = t_wc.shape[0]
    xi0 = jnp.zeros((w, 6))
    j_pose_auto = jax.jacfwd(residual_fn, argnums=0)(xi0, x)
    jp_auto = np.stack(
        [np.asarray(j_pose_auto[:, f, :, f, :]) for f in range(w)], 1)
    np.testing.assert_allclose(np.asarray(out.j_pose), jp_auto,
                               atol=2e-4, rtol=1e-3)


def test_unnormalized_compressed_matches_full(rng):
    """Compressed (XLA and Triton-interpret) statistics honor
    normalize=False identically to the full oracle."""
    from photobundle_tpu.core import schur

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=7)
    kw = dict(huber_delta=0.05, gradient_mode="sampled", normalize=False)
    full = res_mod.evaluate(cam, t_wc, x + 0.01, patch, ch, g, obs, off, **kw)
    eq_b = schur.build_normal_equations(full)
    for backend, extra in (("xla", {}), ("triton", {"interpret": True})):
        comp = res_mod.evaluate_compressed(cam, t_wc, x + 0.01, patch, ch, g,
                                           obs, off, backend=backend,
                                           **extra, **kw)
        np.testing.assert_allclose(float(comp.cost), float(full.cost),
                                   rtol=1e-5, err_msg=backend)
        eq_a = schur.to_point_major(
            schur.build_normal_equations_compressed(comp))
        for name in ("hpp", "hpc", "hcc", "bp", "bc"):
            np.testing.assert_allclose(np.asarray(getattr(eq_a, name)),
                                       np.asarray(getattr(eq_b, name)),
                                       atol=2e-3, rtol=1e-4,
                                       err_msg=f"{backend}:{name}")


def test_robust_weight_families():
    """Every loss kind matches its Ceres closed form (f64 oracle), satisfies
    w = d rho / d s (the IRLS consistency that makes the whitened GN system
    a true first-order model), behaves like plain least squares for small
    residuals, and tukey hard-zeroes gross outliers."""
    delta = 0.3
    b = delta * delta
    s = np.linspace(0.0, 0.5, 2001).astype(np.float64)
    closed = {
        "none": (np.ones_like(s), s),
        "huber": (np.minimum(1.0, delta / np.sqrt(np.maximum(s, 1e-20))),
                  np.where(s <= b, s, 2.0 * delta * np.sqrt(s) - b)),
        "cauchy": (1.0 / (1.0 + s / b), b * np.log1p(s / b)),
        "tukey": (np.maximum(1.0 - s / b, 0.0) ** 2,
                  (b / 3.0) * (1.0 - np.maximum(1.0 - s / b, 0.0) ** 3)),
    }
    h = s[1] - s[0]
    for kind, (w_ref, rho_ref) in closed.items():
        w, rho = res_mod.robust_weight(jnp.asarray(s, jnp.float32), delta,
                                       kind)
        np.testing.assert_allclose(np.asarray(w, np.float64), w_ref,
                                   rtol=3e-5, atol=2e-6, err_msg=kind)
        np.testing.assert_allclose(np.asarray(rho, np.float64), rho_ref,
                                   rtol=3e-5, atol=2e-6, err_msg=kind)
        # IRLS consistency: w == d rho / d s (centered differences on the
        # f64 closed form; exclude a neighborhood of the huber/tukey kink
        # at s = delta^2 where the one-sided derivative jumps).
        fd = np.gradient(rho_ref, s)
        mask = np.abs(s - b) > 2.5 * h
        np.testing.assert_allclose(w_ref[mask], fd[mask], rtol=5e-3,
                                   atol=5e-4, err_msg=kind)
        # Small-residual equivalence: rho(s) ~ s, w ~ 1 (delta keeps ONE
        # meaning across kinds: where downweighting starts).
        tiny = s[(s > 0) & (s < 0.02 * b)]
        _, rho_t = res_mod.robust_weight(jnp.asarray(tiny, jnp.float32),
                                         delta, kind)
        np.testing.assert_allclose(np.asarray(rho_t, np.float64), tiny,
                                   rtol=2e-2, err_msg=kind)
    # Redescending property: tukey gives EXACTLY zero weight past delta.
    w_out, rho_out = res_mod.robust_weight(
        jnp.asarray([b * 1.01, 10.0], jnp.float32), delta, "tukey")
    assert float(jnp.max(w_out)) == 0.0
    np.testing.assert_allclose(np.asarray(rho_out), b / 3.0, rtol=1e-6)


def test_robust_kind_threads_through_compressed_paths(rng):
    """evaluate / evaluate_compressed (xla + Triton-interpret) agree on the
    robust cost for every loss kind (the weight algebra lives OUTSIDE the
    sampling kernel, so all backends must match)."""
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=7)
    for kind in ("cauchy", "tukey", "none"):
        kw = dict(huber_delta=0.05, gradient_mode="sampled",
                  robust_kind=kind)
        full = res_mod.evaluate(cam, t_wc, x + 0.02, patch, ch, g, obs, off,
                                **kw)
        for backend, extra in (("xla", {}), ("triton", {"interpret": True})):
            comp = res_mod.evaluate_compressed(
                cam, t_wc, x + 0.02, patch, ch, g, obs, off,
                backend=backend, **extra, **kw)
            np.testing.assert_allclose(float(comp.cost), float(full.cost),
                                       rtol=1e-5, err_msg=f"{backend}:{kind}")


def test_affine_jacobians_match_autodiff(rng):
    """patchNormalization='affine' (ZNCC-style unit-norm descriptors): the
    analytic G_eff = (G_c - ŝ(ŝᵀG_c))/n propagation must equal jax.jacfwd
    through the full normalized residual."""
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=6)
    from photobundle_tpu.image import patches as pm
    patch = pm.affine_normalize(patch)  # stored descriptor matches the mode
    kw = dict(huber_delta=1e9, gradient_mode="exact", normalize="affine")
    out = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off, **kw)

    def residual_fn(xi_all, x_all):
        t = se3.retract_right(t_wc, xi_all)
        r = res_mod.evaluate(cam, t, x_all, patch, ch, g, obs, off,
                             with_jacobians=False, **kw)
        return r.r

    w = t_wc.shape[0]
    xi0 = jnp.zeros((w, 6))
    j_pose_auto = jax.jacfwd(residual_fn, argnums=0)(xi0, x)
    j_point_auto = jax.jacfwd(residual_fn, argnums=1)(xi0, x)
    n = x.shape[0]
    jp_auto = np.stack([np.asarray(j_pose_auto[:, f, :, f, :])
                        for f in range(w)], 1)
    jx_auto = np.stack([np.asarray(j_point_auto[p, :, :, p, :])
                        for p in range(n)], 0)
    np.testing.assert_allclose(np.asarray(out.j_pose), jp_auto,
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(out.j_point), jx_auto,
                               atol=2e-4, rtol=1e-3)


def test_affine_normalization_gain_offset_invariance(rng):
    """Under 'affine' normalization the residual AND its Jacobians are
    invariant to a per-frame gain+offset change of the target image
    (bilinear sampling commutes with affine image maps, centering removes
    the offset, unit-norm removes the gain). 'mean' removes only the
    offset, so the same gain change must move its cost."""
    from photobundle_tpu.image import patches as pm

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=8)
    ch2 = ch.at[2].multiply(1.3).at[2].add(0.1)
    gx2, gy2 = interp.image_gradients(ch2)
    g2 = jnp.stack([gx2, gy2], axis=-1)
    kw = dict(huber_delta=1e9, gradient_mode="exact")

    patch_a = pm.affine_normalize(patch)
    a = res_mod.evaluate(cam, t_wc, x + 0.02, patch_a, ch, g, obs, off,
                         normalize="affine", **kw)
    b = res_mod.evaluate(cam, t_wc, x + 0.02, patch_a, ch2, g2, obs, off,
                         normalize="affine", **kw)
    assert abs(float(a.cost) - float(b.cost)) < 1e-6
    np.testing.assert_allclose(np.asarray(a.r), np.asarray(b.r), atol=5e-6)
    np.testing.assert_allclose(np.asarray(a.j_pose), np.asarray(b.j_pose),
                               atol=2e-4)
    # Gain leaks through mean-only normalization (the reference's scheme).
    m1 = res_mod.evaluate(cam, t_wc, x + 0.02, patch, ch, g, obs, off,
                          normalize="mean", **kw)
    m2 = res_mod.evaluate(cam, t_wc, x + 0.02, patch, ch2, g2, obs, off,
                          normalize="mean", **kw)
    assert abs(float(m1.cost) - float(m2.cost)) > 1e-3


def test_affine_compressed_matches_full(rng):
    """Compressed statistics under 'affine' normalization (XLA path; the
    Triton sampler refuses the mode) reproduce the oracle's cost and normal
    equations."""
    from photobundle_tpu.core import schur
    from photobundle_tpu.image import patches as pm

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=7)
    patch = pm.affine_normalize(patch)
    kw = dict(huber_delta=1e9, gradient_mode="sampled", normalize="affine")
    full = res_mod.evaluate(cam, t_wc, x + 0.02, patch, ch, g, obs, off, **kw)
    eq_b = schur.build_normal_equations(full)
    comp = res_mod.evaluate_compressed(cam, t_wc, x + 0.02, patch, ch, g,
                                       obs, off, **kw)
    np.testing.assert_allclose(float(comp.cost), float(full.cost), rtol=1e-5)
    eq_a = schur.to_point_major(schur.build_normal_equations_compressed(comp))
    for name in ("hpp", "hpc", "hcc", "bp", "bc"):
        np.testing.assert_allclose(np.asarray(getattr(eq_a, name)),
                                   np.asarray(getattr(eq_b, name)),
                                   atol=2e-3, rtol=1e-3, err_msg=name)


# ---------------------------------------------------------------------------
# patchWarp (cfg.patchWarp): self-consistent patch-grid warping
# ---------------------------------------------------------------------------

def _warp_problem(rng, dz=0.0, n_pts=10, radius=2, z0=2.0, frame1_only=True):
    """Two-frame problem for exact warp-factor checks: frame 0 = identity
    pose (the reference frame), frame 1 = the camera advanced along +z by
    `dz`, every point at EXACT depth z0 in frame 0. The self-consistent
    depth ratio rho_1 = z0 / (z0 - dz) takes exact float values for
    power-of-two z0/z1, so bitwise comparisons are meaningful.
    frame1_only masks out the frame-0 observations so the evaluation
    isolates the warped frame."""
    from photobundle_tpu.geometry import camera as cam_mod

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(
        rng, n_pts=n_pts, w=2, radius=radius)
    t = jnp.tile(jnp.eye(4, dtype=t_wc.dtype)[None], (2, 1, 1))
    t = t.at[1, 2, 3].set(dz)              # camera 1 at z = dz, facing +z
    h, wi = ch.shape[-2], ch.shape[-1]
    # Keep frame-1 projections in bounds: at z1 = z0 - dz the image
    # positions scale by z0/z1 around the principal point.
    m = 0.45 / max(z0 / max(z0 - dz, 0.125), 1.0)
    lo = np.array([wi, h]) * (0.5 - m)
    hi = np.array([wi, h]) * (0.5 + m)
    uv = rng.uniform(lo, hi, size=(n_pts, 2)).astype(np.float32)
    z = jnp.full((n_pts,), z0, jnp.float32)
    x_world = cam_mod.backproject(cam, jnp.asarray(uv), z)  # identity pose
    if frame1_only:
        obs = obs.at[:, 0].set(False)
    ref_slot = jnp.zeros((n_pts,), jnp.int32)
    return cam, t, x_world, patch, ch, g, obs, off, ref_slot


def _warp_tuple(mode, t, x, ref_slot):
    z_ref, r_wc_ref = res_mod.patch_warp_ref_geometry(t, x, ref_slot)
    return (mode, z_ref, r_wc_ref)


def test_patch_warp_identity_bitwise_neutral(rng):
    """dz = 0 -> z_ref == z_f exactly -> rho == 1.0 -> the warped
    evaluation must reproduce the fixed-grid evaluation BITWISE (oracle
    and compressed paths). This is the property the round-4 frozen-seed
    variant LOST once depth drifted from the stereo seed."""
    cam, t, x, patch, ch, g, obs, off, rs = _warp_problem(
        rng, dz=0.0, frame1_only=False)
    kw = dict(huber_delta=0.07, gradient_mode="sampled")
    pw = _warp_tuple("scale", t, x, rs)
    a = res_mod.evaluate(cam, t, x, patch, ch, g, obs, off, **kw)
    b = res_mod.evaluate(cam, t, x, patch, ch, g, obs, off,
                         patch_warp=pw, **kw)
    np.testing.assert_array_equal(np.asarray(a.r), np.asarray(b.r))
    np.testing.assert_array_equal(np.asarray(a.j_pose), np.asarray(b.j_pose))
    np.testing.assert_array_equal(np.asarray(a.j_point),
                                  np.asarray(b.j_point))
    assert float(a.cost) == float(b.cost)
    ca = res_mod.evaluate_compressed(cam, t, x, patch, ch, g, obs, off,
                                     backend="xla", **kw)
    cb = res_mod.evaluate_compressed(cam, t, x, patch, ch, g, obs, off,
                                     backend="xla", patch_warp=pw, **kw)
    np.testing.assert_array_equal(np.asarray(ca.gtg), np.asarray(cb.gtg))
    np.testing.assert_array_equal(np.asarray(ca.gtr), np.asarray(cb.gtr))
    assert float(ca.cost) == float(cb.cost)
    # affine: M == I up to one rounding in (f/z)*(z/f); residuals match to
    # float precision.
    pa = _warp_tuple("affine", t, x, rs)
    c = res_mod.evaluate(cam, t, x, patch, ch, g, obs, off,
                         patch_warp=pa, **kw)
    np.testing.assert_allclose(np.asarray(c.r), np.asarray(a.r), atol=1e-5)


def test_patch_warp_ref_frame_always_unit(rng):
    """The self-consistent factor is 1 in the REFERENCE frame whatever the
    current depth estimate — the defining fix over the frozen-seed model
    (which pulled depth back toward the stereo seed)."""
    cam, t, x, patch, ch, g, obs, off, rs = _warp_problem(rng, dz=0.0)
    for x_cur in (x, x * 1.37):            # depth moved far from creation
        z_ref, r_wc_ref = res_mod.patch_warp_ref_geometry(t, x_cur, rs)
        rho = res_mod.patch_warp_frame("scale", cam, t[0],
                                       se3.transform_points(
                                           se3.se3_inverse(t[0]), x_cur),
                                       z_ref, r_wc_ref)
        np.testing.assert_array_equal(np.asarray(rho),
                                      np.ones_like(np.asarray(rho)))


@pytest.mark.parametrize("dz,rho", [(1.0, 2.0), (-2.0, 0.5)])
def test_patch_warp_scale_equals_prescaled_offsets(rng, dz, rho):
    """rho_1 = z0/z1 exact: the warped evaluation of the non-reference
    frame must equal evaluating with the offsets pre-multiplied by rho
    (sampling, residuals AND the frozen-warp Jacobians are the same
    computation)."""
    cam, t, x, patch, ch, g, obs, off, rs = _warp_problem(rng, dz=dz)
    kw = dict(huber_delta=0.07, gradient_mode="sampled")
    a = res_mod.evaluate(cam, t, x, patch, ch, g, obs, off * rho, **kw)
    b = res_mod.evaluate(cam, t, x, patch, ch, g, obs, off,
                         patch_warp=_warp_tuple("scale", t, x, rs), **kw)
    np.testing.assert_array_equal(np.asarray(a.r), np.asarray(b.r))
    np.testing.assert_array_equal(np.asarray(a.j_pose), np.asarray(b.j_pose))
    assert float(a.cost) == float(b.cost)


@pytest.mark.parametrize("dz,bound", [(1.75, 2.0), (-14.0, 0.5)])
def test_patch_warp_scale_clamped_to_bounds(rng, dz, bound):
    """Depth ratios beyond [0.5, 2] clamp: an extreme ratio behaves exactly
    as the boundary scale (PATCH_SCALE_MIN/MAX) — beyond 2x the planar
    model has broken down and ZNCC tracking would have dropped the
    observation anyway."""
    cam, t, x, patch, ch, g, obs, off, rs = _warp_problem(rng, dz=dz)
    kw = dict(huber_delta=0.07, gradient_mode="sampled")
    a = res_mod.evaluate(cam, t, x, patch, ch, g, obs, off * bound, **kw)
    b = res_mod.evaluate(cam, t, x, patch, ch, g, obs, off,
                         patch_warp=_warp_tuple("scale", t, x, rs), **kw)
    np.testing.assert_array_equal(np.asarray(a.r), np.asarray(b.r))


def test_patch_warp_affine_matches_scale_on_axial_motion(rng):
    """Pure optical-axis translation is the one regime where the full
    affine model degenerates to the isotropic ratio: M = rho * I."""
    cam, t, x, patch, ch, g, obs, off, rs = _warp_problem(rng, dz=1.0)
    kw = dict(huber_delta=0.07, gradient_mode="sampled")
    a = res_mod.evaluate(cam, t, x, patch, ch, g, obs, off,
                         patch_warp=_warp_tuple("scale", t, x, rs), **kw)
    b = res_mod.evaluate(cam, t, x, patch, ch, g, obs, off,
                         patch_warp=_warp_tuple("affine", t, x, rs), **kw)
    np.testing.assert_allclose(np.asarray(b.r), np.asarray(a.r), atol=1e-5)
    assert float(b.cost) == pytest.approx(float(a.cost), rel=1e-5)


def test_patch_warp_affine_rotation_math():
    """Analytic check of patch_warp_frame('affine'): for a pure in-plane
    roll by theta between the reference and the observing camera, a point
    on the optical axis must get M = R(-theta) (the sampling grid counter-
    rotates to follow the template's appearance), at unit scale."""
    cam = Camera(fx=128.0, fy=128.0, cx=64.0, cy=48.0, baseline=0.5)
    theta = 0.3
    c, s = np.cos(theta), np.sin(theta)
    rz = np.eye(4, dtype=np.float32)
    rz[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t = jnp.stack([jnp.eye(4, dtype=jnp.float32), jnp.asarray(rz)])
    x = jnp.asarray([[0.0, 0.0, 2.0]], jnp.float32)       # on-axis point
    rs = jnp.zeros((1,), jnp.int32)
    z_ref, r_wc_ref = res_mod.patch_warp_ref_geometry(t, x, rs)
    y1 = se3.transform_points(se3.se3_inverse(t[1]), x)
    m = np.asarray(res_mod.patch_warp_frame("affine", cam, t[1], y1,
                                            z_ref, r_wc_ref))[0]
    expect = np.array([[c, s], [-s, c]], np.float32)      # R(-theta)
    np.testing.assert_allclose(m, expect, atol=1e-5)
    # and the ref frame itself gets the identity
    m0 = np.asarray(res_mod.patch_warp_frame(
        "affine", cam, t[0],
        se3.transform_points(se3.se3_inverse(t[0]), x), z_ref, r_wc_ref))[0]
    np.testing.assert_allclose(m0, np.eye(2), atol=1e-6)


@pytest.mark.parametrize("mode", ["scale", "affine"])
def test_patch_warp_lm_converges(rng, mode):
    """Frozen-warp Jacobians still drive LM downhill: a perturbed problem
    with patchWarp on converges and recovers the poses. The warp freeze
    affects step QUALITY only — accept/reject tests the true warped cost
    (recomputed self-consistently at every candidate inside lm_solve)."""
    from photobundle_tpu.core import lm

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=16, w=3)
    ref_slot = jnp.zeros((x.shape[0],), jnp.int32)
    pv = jnp.ones((x.shape[0],), bool)
    frozen = jnp.zeros((3,), bool).at[0].set(True)
    rng2 = np.random.default_rng(3)
    t_pert = t_wc.at[1:, :3, 3].add(
        jnp.asarray(rng2.normal(0, 5e-3, size=(2, 3)), jnp.float32))
    t_out, x_out, stats = lm.lm_solve(
        cam, t_pert, x, patch, ch, g, obs, pv, frozen, off,
        huber_delta=0.07, backend="xla", patch_warp=(mode, ref_slot),
        max_iterations=30)
    assert float(stats.final_cost) < float(stats.initial_cost)
    # Poses move back toward the truth.
    err0 = float(jnp.linalg.norm(t_pert[1:, :3, 3] - t_wc[1:, :3, 3]))
    err1 = float(jnp.linalg.norm(t_out[1:, :3, 3] - t_wc[1:, :3, 3]))
    assert err1 < err0
