"""LM solver tests: convergence on synthetic problems, gauge handling,
monotone accepted cost, termination codes.

Test-design notes (hard-won, keep in mind when editing):
- Points must span the FULL image: photometric BA's pose observability
  collapses with narrow point spreads, and the (systematic, smooth)
  bilinear-interpolation error field then drags the minimum away from
  ground truth along the near-null directions.
- TWO poses are frozen (numFixedPoses=2-style) to pin the monocular scale
  gauge; with one frozen pose, scene scaling about that camera's center is
  an exact cost null space.
- Initial perturbations correspond to ~1-5 px reprojection error (VO-like);
  sub-noise-floor perturbations are unrecoverable by construction.
"""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from photobundle_tpu.core import lm
from photobundle_tpu.geometry import se3

from synthetic import perturb_poses, pose_errors
from test_residuals import setup_problem


def run_lm(rng, perturb_points=0.0, perturb_pose=0.0, n_pts=128, w=5,
           max_iterations=40, n_frozen=2, radius=3, **kw):
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=n_pts, w=w,
                                                         radius=radius)
    poses0 = np.asarray(t_wc)
    x0 = np.asarray(x)
    t_init = jnp.asarray(perturb_poses(rng, poses0, perturb_pose,
                                       perturb_pose / 5, keep_first=n_frozen))
    x_init = jnp.asarray(x0 + rng.standard_normal(x0.shape).astype(np.float32) * perturb_points)
    frozen = jnp.asarray([True] * n_frozen + [False] * (w - n_frozen))
    t_ref, x_ref, stats = lm.lm_solve(
        cam, t_init, x_init, patch, ch, g, obs,
        jnp.ones((n_pts,), bool), frozen, off,
        huber_delta=1e9, gradient_mode="sampled",
        max_iterations=max_iterations, **kw,
    )
    return (poses0, x0, np.asarray(t_init), np.asarray(x_init),
            np.asarray(t_ref), np.asarray(x_ref), jax.device_get(stats))


def test_lm_reduces_cost(rng):
    _, _, _, _, _, _, stats = run_lm(rng, perturb_points=0.01, perturb_pose=0.02)
    assert stats.final_cost < 0.2 * stats.initial_cost
    assert stats.accepted_steps >= 1


def test_lm_recovers_poses(rng):
    """From VO-like perturbed poses, LM must pull poses back toward ground
    truth (the golden synthetic test of SURVEY.md section 4)."""
    gt, x_gt, t_init, x_init, t_ref, x_ref, stats = run_lm(
        rng, perturb_points=0.0, perturb_pose=0.05)
    t_err0, r_err0 = pose_errors(t_init, gt)
    t_err1, r_err1 = pose_errors(t_ref, gt)
    assert t_err1 < 0.25 * t_err0, (t_err0, t_err1)
    assert r_err1 < 0.25 * r_err0, (r_err0, r_err1)


def test_lm_recovers_points_and_poses_jointly(rng):
    gt, x_gt, t_init, x_init, t_ref, x_ref, stats = run_lm(
        rng, perturb_points=0.01, perturb_pose=0.03)
    t_err0, _ = pose_errors(t_init, gt)
    t_err1, _ = pose_errors(t_ref, gt)
    assert t_err1 < 0.5 * t_err0, (t_err0, t_err1)
    # Point depth is weakly observable along rays; require only that points
    # don't blow up while poses recover.
    x_err0 = float(np.abs(x_init - x_gt).mean())
    x_err1 = float(np.abs(x_ref - x_gt).mean())
    assert x_err1 < 2.0 * x_err0, (x_err0, x_err1)


def test_lm_accepted_cost_monotone(rng):
    """Property test (SURVEY.md section 4): cost never increases on accepted
    steps."""
    _, _, _, _, _, _, stats = run_lm(rng, perturb_points=0.01, perturb_pose=0.02,
                                     n_pts=48)
    costs = stats.cost_log[~np.isnan(stats.cost_log)]
    assert (np.diff(costs) <= 1e-6).all()


def test_lm_gauge_frozen_pose_unchanged(rng):
    gt, _, t_init, _, t_ref, _, _ = run_lm(rng, perturb_points=0.01,
                                           perturb_pose=0.02, n_pts=48)
    np.testing.assert_allclose(t_ref[0], t_init[0], atol=1e-7)
    np.testing.assert_allclose(t_ref[1], t_init[1], atol=1e-7)


def test_lm_terminates_with_valid_code(rng):
    _, _, _, _, _, _, stats = run_lm(rng, perturb_points=0.0, perturb_pose=0.0,
                                     n_pts=48, max_iterations=25)
    assert int(stats.termination) in (1, 2, 3, 4)
    assert stats.final_cost <= stats.initial_cost + 1e-9


def test_lm_jit_compiles_once(rng):
    """The whole solve must be traceable (no data-dependent Python flow)."""
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=8, w=3)
    frozen = jnp.asarray([True, True, False])

    @jax.jit
    def solve(t, xx):
        return lm.lm_solve(cam, t, xx, patch, ch, g, obs,
                           jnp.ones((8,), bool), frozen, off,
                           huber_delta=1e9, max_iterations=5)

    t1, x1, s1 = solve(t_wc, x)
    t2, x2, s2 = solve(t_wc + 0.0, x + 0.001)
    assert np.isfinite(float(s1.final_cost)) and np.isfinite(float(s2.final_cost))


def test_lm_gauge_invariance_of_relative_poses(rng):
    """Applying a global rigid transform to all inputs must not change the
    *relative* refined poses (gauge invariance; SURVEY.md section 4)."""
    n_pts, w = 48, 4
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=n_pts, w=w)
    rng2 = np.random.default_rng(7)
    t_init = jnp.asarray(perturb_poses(rng2, np.asarray(t_wc), 0.01, 0.002,
                                       keep_first=2))
    x_init = x + 0.005
    frozen = jnp.asarray([True, True, False, False])

    kw = dict(huber_delta=1e9, max_iterations=15)
    t_a, x_a, _ = lm.lm_solve(cam, t_init, x_init, patch, ch, g, obs,
                              jnp.ones((n_pts,), bool), frozen, off, **kw)

    g_xf = jnp.asarray(se3.se3_exp(jnp.asarray([0.3, -0.2, 0.1, 0.05, 0.02, -0.04])))
    t_b, x_b, _ = lm.lm_solve(cam, g_xf @ t_init, se3.transform_points(g_xf, x_init),
                              patch, ch, g, obs, jnp.ones((n_pts,), bool), frozen, off, **kw)

    rel_a = np.asarray(se3.se3_inverse(t_a[0]) @ t_a[3])
    rel_b = np.asarray(se3.se3_inverse(t_b[0]) @ t_b[3])
    np.testing.assert_allclose(rel_a, rel_b, atol=5e-4)


def test_motion_prior_holds_poses_without_texture(rng):
    """With a strong relative-pose prior and (near) zero photometric
    gradient, the solver must keep the window's relative poses at their
    initialization instead of wandering in the gauge null space."""
    from test_residuals import setup_problem
    from photobundle_tpu.geometry import se3

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=10, w=4)
    # Kill the texture: constant images -> zero gradients, zero residual
    # signal (patches re-extracted from the flat image are zero-mean too).
    ch = jnp.full_like(ch, 0.5)
    g = jnp.zeros_like(g)
    patch = jnp.zeros_like(patch)
    frozen = jnp.asarray([True] + [False] * 3)
    pv = jnp.ones((x.shape[0],), bool)

    t_out, x_out, stats = lm.lm_solve(
        cam, t_wc, x, patch, ch, g, obs, pv, frozen, off,
        huber_delta=0.05, motion_prior_weight=50.0, max_iterations=8)
    rel_in = np.asarray(se3.se3_inverse(t_wc[:-1]) @ t_wc[1:])
    rel_out = np.asarray(se3.se3_inverse(t_out[:-1]) @ t_out[1:])
    np.testing.assert_allclose(rel_out, rel_in, atol=1e-4)


def test_motion_prior_zero_matches_reference_path(rng):
    """Weight 0 must be bit-identical to the no-prior code path."""
    from test_residuals import setup_problem

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=8, w=3)
    frozen = jnp.asarray([True, False, False])
    pv = jnp.ones((x.shape[0],), bool)
    kw = dict(huber_delta=0.05, max_iterations=6)
    a = lm.lm_solve(cam, t_wc, x + 0.01, patch, ch, g, obs, pv, frozen, off,
                    motion_prior_weight=0.0, **kw)
    b = lm.lm_solve(cam, t_wc, x + 0.01, patch, ch, g, obs, pv, frozen, off,
                    **kw)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


@pytest.mark.slow
def test_motion_prior_strength_ordering(rng):
    """The prior anchors to the INITIALIZATION, so with a jittered init a
    stronger prior permits less correction — refinement quality must order
    monotonically with weight, and a weak prior must still correct most of
    the error."""
    from test_residuals import setup_problem
    from photobundle_tpu.geometry import se3
    from synthetic import pose_errors

    cam, t_wc_gt, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=24, w=4)
    xi = rng.standard_normal((4, 6)).astype(np.float32) * 0.01
    xi[:1] = 0
    t_init = jnp.asarray(np.asarray(t_wc_gt @ se3.se3_exp(jnp.asarray(xi))))
    frozen = jnp.asarray([True] + [False] * 3)
    pv = jnp.ones((x.shape[0],), bool)
    errs = {}
    for wm in (0.0, 1.0, 5.0):
        t_out, _, _ = lm.lm_solve(
            cam, t_init, x, patch, ch, g, obs, pv, frozen, off,
            huber_delta=0.05, motion_prior_weight=wm, max_iterations=25)
        errs[wm], _ = pose_errors(np.asarray(t_out), np.asarray(t_wc_gt))
    e_init, _ = pose_errors(np.asarray(t_init), np.asarray(t_wc_gt))
    assert errs[0.0] < 0.6 * e_init          # free solve corrects most
    assert errs[0.0] <= errs[1.0] <= errs[5.0] + 1e-9  # monotone anchoring
    assert errs[1.0] < 0.85 * e_init         # weak prior still refines


def test_gradient_tolerance_termination(rng):
    """At (numerical) optimum the gradient is tiny; gtol must fire."""
    from test_residuals import setup_problem

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=12, w=3)
    frozen = jnp.asarray([True, False, False])
    pv = jnp.ones((x.shape[0],), bool)
    # Start AT ground truth: residuals ~0, gradient ~0 -> immediate stop.
    t_out, x_out, stats = lm.lm_solve(
        cam, t_wc, x, patch, ch, g, obs, pv, frozen, off,
        huber_delta=0.05, gradient_tolerance=1e-1, max_iterations=20,
        function_tolerance=0.0, parameter_tolerance=0.0)
    assert int(stats.termination) == 5, lm.TERMINATION_NAMES[int(stats.termination)]
    assert int(stats.iterations) <= 2


def test_frozen_poses_bitwise_invariant_at_world_scale(rng):
    """Regression (round 2): frozen gauge poses must come out of the solve
    BITWISE unchanged, including at KITTI-scale world coordinates
    (|t| ~ 30 m). A reduced-precision default for f32 matmuls (bf16 on
    some accelerators, TF32 on GPUs) quantizes T @ exp(xi), so 'frozen'
    poses moved by ~0.05 m per solve (invisible at toy coordinate scales);
    the package forces full-precision matmuls and evaluates pose/point
    products as elementwise arithmetic."""
    from test_residuals import setup_problem
    from photobundle_tpu.geometry import se3 as se3_mod

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=24, w=4)
    # Shift the whole world to large coordinates (gauge-equivariant).
    shift = jnp.eye(4).at[:3, 3].set(jnp.asarray([120.0, -45.0, -28.0]))
    t_big = jnp.einsum("ij,wjk->wik", shift, t_wc)
    x_big = se3_mod.transform_points(shift, x)
    frozen = jnp.asarray([True, True, False, False])
    pv = jnp.ones((24,), bool)
    t_out, x_out, stats = jax.jit(lambda t, xx: lm.lm_solve(
        cam, t, xx, patch, ch, g, obs, pv, frozen, off,
        huber_delta=1e9, max_iterations=8))(t_big, x_big + 0.01)
    assert int(stats.accepted_steps) >= 1
    np.testing.assert_array_equal(np.asarray(t_out[0]), np.asarray(t_big[0]))
    np.testing.assert_array_equal(np.asarray(t_out[1]), np.asarray(t_big[1]))


def test_pose_prior_zero_matches_reference_path(rng):
    """posePriorWeight 0 (or None) must be bit-identical to the no-prior
    code path — the reference has no absolute prior."""
    from test_residuals import setup_problem

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=8, w=3)
    frozen = jnp.asarray([True, False, False])
    pv = jnp.ones((x.shape[0],), bool)
    kw = dict(huber_delta=0.05, max_iterations=6)
    a = lm.lm_solve(cam, t_wc, x + 0.01, patch, ch, g, obs, pv, frozen, off,
                    pose_prior=(t_wc, 0.0), **kw)
    b = lm.lm_solve(cam, t_wc, x + 0.01, patch, ch, g, obs, pv, frozen, off,
                    **kw)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def test_pose_prior_split_rot_weight(rng):
    """A rotation-only absolute prior (w_trans=0, w_rot large) must pin
    rotations to the anchor while leaving translations free to refine:
    the twist residual is [rho|omega]-ordered and the split weights must
    land on the right components."""
    from test_residuals import setup_problem
    from photobundle_tpu.geometry import se3

    cam, t_gt, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=24, w=4)
    xi = rng.standard_normal((4, 6)).astype(np.float32) * 0.01
    xi[:1] = 0
    t_init = jnp.asarray(np.asarray(t_gt @ se3.se3_exp(jnp.asarray(xi))))
    frozen = jnp.asarray([True] + [False] * 3)
    pv = jnp.ones((x.shape[0],), bool)
    kw = dict(huber_delta=0.05, max_iterations=10)

    t_free, _, _ = lm.lm_solve(cam, t_init, x, patch, ch, g, obs, pv,
                               frozen, off, **kw)
    t_rot, _, _ = lm.lm_solve(cam, t_init, x, patch, ch, g, obs, pv,
                              frozen, off,
                              pose_prior=(t_init, 0.0, 1e4), **kw)

    def rot_dev(t):  # rotation deviation from the anchor (rad, per pose)
        rel = se3.se3_inverse(t_init) @ t
        return np.linalg.norm(np.asarray(se3.se3_log(rel))[:, 3:], axis=-1)

    def trans_dev(t):
        return np.linalg.norm(np.asarray(t)[:, :3, 3]
                              - np.asarray(t_init)[:, :3, 3], axis=-1)

    # Rotations pinned: orders of magnitude closer to the anchor than the
    # unconstrained solve (which corrects the injected rotation error).
    assert rot_dev(t_rot).max() < 0.05 * max(rot_dev(t_free).max(), 1e-9)
    # Translations still free: the solve moved them materially.
    assert trans_dev(t_rot).max() > 0.2 * trans_dev(t_free).max()


def test_lm_redescending_loss_rejects_gross_outliers(rng):
    """A redescending loss (tukey) must recover poses on a problem where a
    block of points carries grossly corrupted reference patches (simulated
    occlusion/specular outliers), and must beat plain least squares there.

    delta sizing: inlier residual norms near convergence are ~0.1-0.2
    (rms < 0.02/px over D = 49 px); the corrupted patches sit at norm
    ~0.5*sqrt(49) = 3.5. delta = 0.6 cleanly separates the two."""
    n_pts, w, n_bad = 96, 5, 10
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=n_pts,
                                                         w=w, radius=3)
    # Gross photometric corruption on a contiguous block of points: a
    # +/-0.5 sawtooth survives mean normalization (the per-patch mean is
    # removed, so a constant offset would NOT be an outlier).
    d = patch.shape[-1]
    saw = jnp.asarray(np.where(np.arange(d) % 2 == 0, 0.5, -0.5),
                      patch.dtype)
    patch = patch.at[:n_bad].add(saw)
    poses0 = np.asarray(t_wc)
    t_init = jnp.asarray(perturb_poses(rng, poses0, 0.03, 0.006,
                                       keep_first=2))
    frozen = jnp.asarray([True, True] + [False] * (w - 2))
    pv = jnp.ones((n_pts,), bool)

    errs = {}
    for kind in ("none", "huber", "cauchy", "tukey"):
        t_ref, _, stats = lm.lm_solve(
            cam, t_init, x, patch, ch, g, obs, pv, frozen, off,
            huber_delta=0.6, robust_kind=kind, gradient_mode="sampled",
            max_iterations=40)
        errs[kind], _ = pose_errors(np.asarray(t_ref), poses0)
        costs = jax.device_get(stats).cost_log
        costs = costs[~np.isnan(costs)]
        assert (np.diff(costs) <= 1e-6).all(), kind  # monotone under IRLS
    err_init, _ = pose_errors(np.asarray(t_init), poses0)
    # Every robust kind must still converge on the 86 clean points.
    for kind in ("huber", "cauchy", "tukey"):
        assert errs[kind] < 0.5 * err_init, (kind, errs, err_init)
    # The redescending losses must beat plain least squares, whose solution
    # is dragged by the corrupted block.
    assert errs["tukey"] < errs["none"], errs
    assert errs["cauchy"] < errs["none"], errs


def test_lm_initial_cost_equals_eval_plus_prior_cost(rng):
    """Objective-equality invariant: lm_solve's reported initial cost is
    EXACTLY evaluate_compressed().cost + prior_cost() for the same inputs.
    The engine's coarse-to-fine warm-start guard reconstructs the solver
    objective from those two pieces (engine.fine_cost); if the solver ever
    counts a term the guard does not (or vice versa), the guard silently
    compares the wrong objective."""
    from photobundle_tpu.core import residuals as res_mod

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=16, w=4)
    rng2 = np.random.default_rng(5)
    t0 = t_wc.at[1:, :3, 3].add(
        jnp.asarray(rng2.normal(0, 3e-3, size=(3, 3)), jnp.float32))
    anchor = se3.se3_inverse(t0[:-1]) @ t0[1:]
    pp = (t_wc, 2.0, 4.0)
    kw = dict(huber_delta=0.07, gradient_mode="sampled", backend="xla")
    frozen = jnp.asarray([True, False, False, False])
    _, _, stats = lm.lm_solve(
        cam, t0, x, patch, ch, g, obs, jnp.ones((x.shape[0],), bool),
        frozen, off, motion_prior_weight=3.0, motion_prior_anchor=anchor,
        pose_prior=pp, max_iterations=1, **kw)
    res = res_mod.evaluate_compressed(cam, t0, x, patch, ch, g, obs, off,
                                      0.07, "sampled", backend="xla")
    expect = float(res.cost) + float(lm.prior_cost(
        t0, motion_prior_weight=3.0, rel0=anchor, pose_prior=pp))
    assert float(stats.initial_cost) == pytest.approx(expect, rel=1e-6, abs=0)


def test_tukey_with_affine_normalization_composes(rng):
    """robustLoss=tukey + patchNormalization=affine both rescale residual
    norms (tukey's redescending cutoff acts on the affine-normalized,
    O(1)-scale residuals). Pin the composition: the full/compressed paths
    agree, gross photometric outliers are suppressed, and the combination
    converges."""
    from photobundle_tpu.core import residuals as res_mod, schur
    from photobundle_tpu.image import patches as pm

    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=24, w=3)
    patch = pm.affine_normalize(patch)
    # Corrupt a block of one frame: gross occlusion-style outlier.
    ch = ch.at[1, :, 30:60, 40:90].set(1.0)
    kw = dict(huber_delta=0.3, robust_kind="tukey",
              gradient_mode="sampled", normalize="affine")
    full = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off, **kw)
    comp = res_mod.evaluate_compressed(cam, t_wc, x, patch, ch, g, obs, off,
                                       backend="xla", **kw)
    np.testing.assert_allclose(float(comp.cost), float(full.cost), rtol=1e-5)
    eq_a = schur.to_point_major(schur.build_normal_equations_compressed(comp))
    eq_b = schur.build_normal_equations(full)
    for name in ("hpp", "hpc", "hcc", "bp", "bc"):
        np.testing.assert_allclose(np.asarray(getattr(eq_a, name)),
                                   np.asarray(getattr(eq_b, name)),
                                   atol=2e-3, rtol=1e-3, err_msg=name)
    # Tukey on affine-normalized residuals: each residual norm is <= ~2
    # (unit-normalized patches), so delta=0.3 must leave most inliers at
    # weight ~1 while zero-weighting the corrupted block. Weights must be
    # computed from RAW (un-whitened) norms — full.r is already scaled by
    # sqrt(w_tukey).
    raw = res_mod.evaluate(cam, t_wc, x, patch, ch, g, obs, off,
                           huber_delta=0.3, robust_kind="none",
                           gradient_mode="sampled", normalize="affine")
    rn2 = jnp.sum(raw.r * raw.r, axis=-1)
    w_t, _ = res_mod.robust_weight(rn2, 0.3, "tukey")
    w_live = w_t[np.asarray(raw.valid)]
    assert float(jnp.max(w_live)) > 0.9     # inliers keep full weight
    assert float(jnp.min(w_live)) == 0.0    # outlier block fully cut
