"""Levenberg-Marquardt trust-region loop, fully inside `lax.while_loop`.

JAX replacement for Ceres' LEVENBERG_MARQUARDT trust region
(reference: pb:src/photobundle.cc `ceres::Solve`; SURVEY.md section 3.3 hot
loop no. 3). One LM iteration = one traced program: evaluate residuals +
Jacobians, Schur-eliminate points, solve the reduced camera system, test the
candidate with a cheap residual-only pass, accept/reject branch-free via
`jnp.where`. No recompiles across iterations, no host round-trips — the
whole solve is a single XLA computation.

Lambda policy: Nielsen's adaptive damping (the same policy Ceres uses):
  accept: lam *= max(1/3, 1 - (2*rho - 1)^3); nu = 2
  reject: lam *= nu; nu *= 2
Step acceptance uses the gain ratio rho = actual / predicted decrease.

Per-iteration records (cost, lambda, step norm, accepted) are written into
fixed-size arrays — the equivalent of Ceres' per-iteration summary table
(SURVEY.md section 5.1/5.5) — and returned to the host once per solve.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3
from . import residuals as residuals_mod
from . import schur
from .residuals import evaluate, evaluate_compressed


class LMStats(NamedTuple):
    initial_cost: jax.Array     # ()
    final_cost: jax.Array       # ()
    iterations: jax.Array       # () accepted + rejected iterations run
    accepted_steps: jax.Array   # ()
    termination: jax.Array      # () code: 0 running, 1 maxiter, 2 ftol,
                                #    3 xtol, 4 lambda overflow
    cost_log: jax.Array         # (max_iter,) cost after each iteration
    lambda_log: jax.Array       # (max_iter,)
    step_log: jax.Array         # (max_iter,) step norms
    accept_log: jax.Array       # (max_iter,) bool
    n_residuals: jax.Array      # () valid observation count
    obs_per_frame: jax.Array    # (W,) valid observations per window slot at
                                #     the initial point (observability
                                #     diagnostics: weakly-supported frames
                                #     are where solve noise enters)


class ShardCtx(NamedTuple):
    """Cross-shard reduction hooks for a ('frames', 'points') 2-D mesh —
    the 'ring-attention of BA' layout (SURVEY.md 5.7): window images are
    sharded over 'frames' (per-chip memory = W / n_frames frames), point
    tensors over 'points'. The distributed Schur assembly is then:

        hpp, bp          psum over 'frames'   (point blocks: all frames)
        hcc, bc          psum over 'points' then all_gather over 'frames'
        hpc              all_gather over 'frames' (axis 0) — the one
                         gathered tensor, point-minor (W_local, 3, 6,
                         N_local) -> (W, 3, 6, N_local): small next to
                         the sharded images
        S, rhs           psum over 'points'
        cost / n_res     psum over both axes

    The reduced 6W x 6W solve stays replicated on every chip. A plain
    points-only sharding is the degenerate ctx with identity frames hooks
    (see points_only_ctx)."""

    reduce_points: Callable     # psum over the points axis
    reduce_frames: Callable     # psum over the frames axis
    reduce_obs: Callable        # psum over BOTH axes (per-observation sums)
    gather_frames: Callable     # (x, axis) -> all_gather over frames, tiled
    frame_offset: jax.Array | int  # global slot index of local frame 0


def points_only_ctx(reduce_fn: Callable | None) -> ShardCtx:
    """The 1-D (points-sharded or unsharded) special case."""
    r = reduce_fn if reduce_fn is not None else (lambda x: x)
    return ShardCtx(
        reduce_points=r,
        reduce_frames=lambda x: x,
        reduce_obs=r,
        gather_frames=lambda x, axis: x,
        frame_offset=0,
    )


def prior_cost(t, *, motion_prior_weight: float = 0.0, rel0=None,
               pose_prior=None):
    """0.5*||r||^2 of the replicated pose-prior terms (relative-motion +
    absolute), exactly as lm_solve's objective counts them. ONE definition
    shared by the solver and the engine's coarse-to-fine warm-start guard:
    the guard must compare the FULL objective, or a coarse warm start that
    trades prior cost for photometric cost is accepted into the wrong
    basin. Replicated pose math — never psum this.

    rel0: (W-1, 4, 4) relative-pose anchor (required when
    motion_prior_weight > 0). pose_prior: (T_vo, w_trans[, w_rot]).
    """
    c = jnp.asarray(0.0, t.dtype)
    wm = float(motion_prior_weight)
    if wm > 0.0 and rel0 is not None:
        rel = se3.se3_inverse(t[:-1]) @ t[1:]
        r = wm * se3.se3_log(se3.se3_inverse(rel0) @ rel)
        c = c + 0.5 * jnp.sum(r * r)
    if pose_prior is not None:
        wa_t = float(pose_prior[1])
        wa_r = (wa_t if (len(pose_prior) < 3 or pose_prior[2] is None
                         or pose_prior[2] < 0) else float(pose_prior[2]))
        if wa_t > 0.0 or wa_r > 0.0:
            w6 = jnp.asarray(np.array([wa_t] * 3 + [wa_r] * 3, np.float32),
                             t.dtype)
            r = w6 * se3.se3_log(se3.se3_inverse(pose_prior[0]) @ t)
            c = c + 0.5 * jnp.sum(r * r)
    return c


class _LoopState(NamedTuple):
    t_wc: jax.Array
    x_world: jax.Array
    res: object           # CompressedResiduals at (t_wc, x_world)
    cost: jax.Array       # globally-reduced robust cost at (t_wc, x_world)
    lam: jax.Array
    nu: jax.Array
    it: jax.Array
    accepted: jax.Array
    term: jax.Array
    cost_log: jax.Array
    lambda_log: jax.Array
    step_log: jax.Array
    accept_log: jax.Array


def lm_solve(
    cam,
    t_wc: jax.Array,          # (W, 4, 4) initial window poses
    x_world: jax.Array,       # (N, 3) initial points
    patch: jax.Array,         # (N, C, P)
    channels: jax.Array,      # (W, C, H, Wi)
    grads: jax.Array,         # (W, C, H, Wi, 2)
    obs_mask: jax.Array,      # (N, W)
    point_valid: jax.Array,   # (N,)
    frozen: jax.Array,        # (W,) gauge-fixed poses
    offsets: jax.Array,       # (P, 2)
    *,
    huber_delta: float,
    robust_kind: str = "huber",
    gradient_mode: str = "sampled",
    backend: str = "xla",
    normalize: bool = True,
    depth_prior: tuple | None = None,
    patch_warp: tuple | None = None,
    motion_prior_weight: float = 0.0,
    motion_prior_anchor: jax.Array | None = None,
    pose_prior: tuple | None = None,
    max_iterations: int = 50,
    initial_lambda: float = 1e-4,
    min_lambda: float = 1e-10,
    max_lambda: float = 1e8,
    function_tolerance: float = 1e-6,
    parameter_tolerance: float = 1e-8,
    gradient_tolerance: float = 0.0,
    min_obs_per_frame: int = 1,
    reduce_fn: Callable | None = None,
    shard_ctx: ShardCtx | None = None,
):
    """Run LM to convergence. Returns (t_wc, x_world, LMStats).

    `backend` is the sampling path of every evaluation ('xla' or 'triton',
    see residuals.evaluate_compressed; callers resolve it with
    PBAConfig.resolve_backend). `reduce_fn(tree) -> tree` is the simple cross-shard reduction hook:
    identity on a single chip, `jax.lax.psum(..., 'points')` inside
    `shard_map` (parallel/sharded.py). For the 2-D ('frames', 'points')
    layout pass `shard_ctx` instead (see ShardCtx): `t_wc` stays the FULL
    replicated (W, 4, 4) window, while `channels`/`grads` hold only the
    local frame shard and `obs_mask` is (N_local, W_local).
    """
    sc = shard_ctx if shard_ctx is not None else points_only_ctx(reduce_fn)
    w_local = channels.shape[0]
    frames_sharded = shard_ctx is not None and w_local != t_wc.shape[0]

    obs_mask = obs_mask & point_valid[:, None]
    if depth_prior is not None and frames_sharded:
        # ref_slot holds GLOBAL window slots; evaluation compares against
        # local frame indices, so shift into the local frame (slots owned
        # by other shards fall outside [0, w_local) and never match).
        depth_prior = (depth_prior[0] - sc.frame_offset,
                       depth_prior[1], depth_prior[2])

    def slice_frames(t):
        if not frames_sharded:
            return t
        return jax.lax.dynamic_slice_in_dim(t, sc.frame_offset, w_local, 0)

    def eval_stats(t, x):
        # patch_warp = (mode, ref_slot GLOBAL): the warp factors are
        # self-consistent functions of the CURRENT iterate, recomputed at
        # every candidate evaluation from the FULL replicated poses (the
        # ref frame may live on another frame shard — poses are
        # replicated, images are not). See residuals.patch_warp_ref_geometry.
        pw = None
        if patch_warp is not None:
            z_ref, r_wc_ref = residuals_mod.patch_warp_ref_geometry(
                t, x, patch_warp[1])
            pw = (patch_warp[0], z_ref, r_wc_ref)
        return evaluate_compressed(cam, slice_frames(t), x, patch, channels,
                                   grads, obs_mask, offsets, huber_delta,
                                   gradient_mode, depth_prior=depth_prior,
                                   backend=backend, normalize=normalize,
                                   robust_kind=robust_kind,
                                   patch_warp=pw)

    # Relative-pose motion prior (no reference counterpart): anchors each
    # consecutive window pair's relative pose to its initialization,
    #   r_f = w_m * log(rel0_f^{-1} (T_{f-1}^{-1} T_f)),   f = 1..W-1,
    # with first-order Jacobians dr/dxi_f = w_m I and
    # dr/dxi_{f-1} = -w_m Ad(rel_f^{-1}). Suppresses gauge wander when the
    # photometric signal is weak (low texture, tiny windows); weight 0
    # reproduces reference behavior exactly. Everything here is replicated
    # pose math — identical on all shards, never psummed.
    wm = motion_prior_weight
    use_motion = wm > 0.0
    w_sz = t_wc.shape[0]
    # The anchor is the INITIAL relative trajectory. Coarse-to-fine warm
    # starts pass the original VO rel poses explicitly so finer levels
    # don't re-anchor to the (already-moved) coarse solution.
    if use_motion:
        rel0 = (motion_prior_anchor if motion_prior_anchor is not None
                else se3.se3_inverse(t_wc[:-1]) @ t_wc[1:])
    else:
        rel0 = None
    # Absolute pose prior (no reference counterpart; cfg.posePriorWeight):
    # anchors each window pose to its RAW VO input pose,
    #   r_f = w_a * log(T_vo_f^{-1} T_f),
    # first-order Jacobian dr/dxi_f = w_a I under right retraction. The
    # sliding chain re-anchors every window on its own previous refinement,
    # so photometric relative noise integrates into an unbounded walk; the
    # VO input's ABSOLUTE poses are the one unbiased measurement of that
    # walk (exactly so under an iid error model), and this term fuses them
    # back in. Weight 0 reproduces reference behavior exactly.
    # pose_prior = (T_vo, w_trans[, w_rot]); w_rot defaults to w_trans.
    # Splitting the weights is statistically correct: VO translation and
    # rotation noise have different units and very different relative
    # precision, and the twist residual mixes them ([rho|omega] order).
    wa_t = 0.0 if pose_prior is None else float(pose_prior[1])
    wa_r = (wa_t if (pose_prior is None or len(pose_prior) < 3
                     or pose_prior[2] is None or pose_prior[2] < 0)
            else float(pose_prior[2]))
    use_abs = wa_t > 0.0 or wa_r > 0.0
    t_anchor = pose_prior[0] if use_abs else None
    use_any_prior = use_motion or use_abs
    _w6 = np.array([wa_t] * 3 + [wa_r] * 3, np.float32)

    def abs_residual(t):
        w6 = jnp.asarray(_w6, t.dtype)
        return w6 * se3.se3_log(se3.se3_inverse(t_anchor) @ t)   # (W, 6)

    def prior_cost_terms(t):
        return prior_cost(t, motion_prior_weight=wm if use_motion else 0.0,
                          rel0=rel0,
                          pose_prior=pose_prior if use_abs else None)

    def prior_system(t):
        """(hcc_diag (W,6,6), coupling (W,W,6,6) off-diag | None, bc (W,6))."""
        eye6 = jnp.eye(6, dtype=t.dtype)
        hd = jnp.zeros((w_sz, 6, 6), t.dtype)
        bc = jnp.zeros((w_sz, 6), t.dtype)
        coup = None
        if use_motion:
            rel = se3.se3_inverse(t[:-1]) @ t[1:]
            r = wm * se3.se3_log(se3.se3_inverse(rel0) @ rel)     # (W-1, 6)
            ad = se3.adjoint(se3.se3_inverse(rel))                # (W-1, 6, 6)
            idx = jnp.arange(w_sz - 1)
            hd = hd.at[idx + 1].add(wm * wm * eye6[None])
            hd = hd.at[idx].add(wm * wm * jnp.einsum("fki,fkj->fij", ad, ad))
            coup = jnp.zeros((w_sz, w_sz, 6, 6), t.dtype)
            coup = coup.at[idx, idx + 1].add(
                -wm * wm * jnp.swapaxes(ad, -1, -2))
            coup = coup.at[idx + 1, idx].add(-wm * wm * ad)
            bc = bc.at[idx + 1].add(-wm * r)
            bc = bc.at[idx].add(wm * jnp.einsum("fki,fk->fi", ad, r))
        if use_abs:
            w6 = jnp.asarray(_w6, t.dtype)
            hd = hd + jnp.diag(w6 * w6)[None]
            bc = bc - w6 * abs_residual(t)
        return hd, coup, bc

    res0 = eval_stats(t_wc, x_world)
    init_cost = sc.reduce_obs(res0.cost) + prior_cost_terms(t_wc)
    n_res = sc.reduce_obs(res0.n_residuals)
    obs_per_frame0 = sc.gather_frames(
        sc.reduce_points(jnp.sum(res0.valid.astype(jnp.int32), axis=0)), 0)

    def body(st: _LoopState) -> _LoopState:
        # One residual/stat evaluation per iteration: the loop state carries
        # the stats at the CURRENT point (evaluated when that point was the
        # accepted candidate), so the candidate's full evaluation doubles as
        # both the acceptance test and, if accepted, the next iteration's
        # Gauss-Newton system. Halves the sampling work vs the classic
        # eval-then-test structure at identical numerics.
        res = st.res
        # Normal-equation assembly is plain XLA (core/schur.py).
        eq = schur.build_normal_equations_compressed(res)
        # Global assembly (see ShardCtx): point blocks summed over frames,
        # pose blocks summed over points then gathered over frames, the
        # point-pose coupling gathered over frames (axis 1). With the
        # points-only ctx this degenerates to the two classic psums.
        eq = eq._replace(
            hpp=sc.reduce_frames(eq.hpp),
            bp=sc.reduce_frames(eq.bp),
            hcc=sc.gather_frames(sc.reduce_points(eq.hcc), 0),
            bc=sc.gather_frames(sc.reduce_points(eq.bc), 0),
            hpc=sc.gather_frames(eq.hpc, 0),   # (W_local,3,6,N) -> (W,...)
        )
        coupling = None
        if use_any_prior:
            # Added AFTER the psum — the priors are replicated pose math.
            hd, coupling, bc_p = prior_system(st.t_wc)
            eq = eq._replace(hcc=eq.hcc + hd, bc=eq.bc + bc_p)
        # Freeze poses with too little support in addition to gauge: a
        # frame with < min_obs_per_frame observations has Ceres-equivalent
        # behavior at 1 (a pose with no residuals stays at its init); above
        # 1 it is an observability gate — a handful of patches cannot
        # constrain 6 DOF, and letting them try injects relative-pose noise
        # into the sliding chain (round-3 RPE diagnosis).
        obs_per_frame = sc.gather_frames(
            sc.reduce_points(jnp.sum(res.valid.astype(jnp.int32), axis=0)), 0)
        frz = frozen | (obs_per_frame < max(1, min_obs_per_frame))

        sys_parts = schur.reduce_camera_system(eq, st.lam, point_valid, frz,
                                               reduce_fn=sc.reduce_points,
                                               pose_coupling=coupling)
        dc, dp = schur.solve_reduced(sys_parts)

        t_new = se3.retract_right(st.t_wc, dc)
        x_new = st.x_world + dp
        res_new = eval_stats(t_new, x_new)
        new_cost = sc.reduce_obs(res_new.cost) + prior_cost_terms(t_new)

        pred = schur.predicted_reduction(eq, st.lam, dc, dp,
                                         reduce_fn=sc.reduce_points)
        pred = jnp.maximum(pred, 1e-20)
        actual = st.cost - new_cost
        rho = actual / pred
        accept = (rho > 0) & jnp.isfinite(new_cost)

        # Nielsen damping update.
        lam_acc = st.lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        lam_new = jnp.where(accept, jnp.clip(lam_acc, min_lambda, max_lambda),
                            jnp.minimum(st.lam * st.nu, max_lambda * 10.0))
        nu_new = jnp.where(accept, 2.0, st.nu * 2.0)

        step_norm2 = sc.reduce_points(jnp.sum(dp * dp)) + jnp.sum(dc * dc)
        param_norm2 = (sc.reduce_points(jnp.sum(st.x_world ** 2))
                       + jnp.sum(se3.se3_log(st.t_wc) ** 2))
        step_norm = jnp.sqrt(step_norm2)

        cost_out = jnp.where(accept, new_cost, st.cost)
        # Termination tests (only on accepted steps, Ceres-style).
        ftol_hit = accept & (actual <= function_tolerance * st.cost)
        xtol_hit = accept & (step_norm <= parameter_tolerance * (jnp.sqrt(param_norm2) + parameter_tolerance))
        lam_hit = ~accept & (st.lam >= max_lambda)
        # Gradient stop: ||J^T r||_2 over free poses + valid points (the
        # 2-norm composes with the cross-shard psum; Ceres uses max-norm).
        g2 = (jnp.sum((eq.bc * (~frz).astype(eq.bc.dtype)[:, None]) ** 2)
              + sc.reduce_points(jnp.sum(
                  (eq.bp * point_valid.astype(eq.bp.dtype)[None, :]) ** 2)))
        gtol_hit = (jnp.sqrt(g2) <= gradient_tolerance) & (gradient_tolerance > 0)
        term = jnp.where(gtol_hit, 5,
                         jnp.where(ftol_hit, 2,
                                   jnp.where(xtol_hit, 3,
                                             jnp.where(lam_hit, 4, 0))))

        i = st.it
        return _LoopState(
            t_wc=jnp.where(accept, t_new, st.t_wc),
            x_world=jnp.where(accept, x_new, st.x_world),
            res=jax.tree.map(lambda a, b: jnp.where(accept, a, b),
                             res_new, st.res),
            cost=cost_out,
            lam=lam_new,
            nu=nu_new,
            it=i + 1,
            accepted=st.accepted + accept.astype(jnp.int32),
            term=term.astype(jnp.int32),
            cost_log=st.cost_log.at[i].set(cost_out),
            lambda_log=st.lambda_log.at[i].set(st.lam),
            step_log=st.step_log.at[i].set(step_norm),
            accept_log=st.accept_log.at[i].set(accept),
        )

    def cond(st: _LoopState):
        return (st.it < max_iterations) & (st.term == 0)

    nan = jnp.nan
    st0 = _LoopState(
        t_wc=t_wc,
        x_world=x_world,
        res=res0,
        cost=init_cost,
        lam=jnp.asarray(initial_lambda, t_wc.dtype),
        nu=jnp.asarray(2.0, t_wc.dtype),
        it=jnp.asarray(0, jnp.int32),
        accepted=jnp.asarray(0, jnp.int32),
        term=jnp.asarray(0, jnp.int32),
        cost_log=jnp.full((max_iterations,), nan, t_wc.dtype),
        lambda_log=jnp.full((max_iterations,), nan, t_wc.dtype),
        step_log=jnp.full((max_iterations,), nan, t_wc.dtype),
        accept_log=jnp.zeros((max_iterations,), bool),
    )
    st = jax.lax.while_loop(cond, body, st0)

    stats = LMStats(
        initial_cost=init_cost,
        final_cost=st.cost,
        iterations=st.it,
        accepted_steps=st.accepted,
        termination=jnp.where(st.term == 0, 1, st.term),
        cost_log=st.cost_log,
        lambda_log=st.lambda_log,
        step_log=st.step_log,
        accept_log=st.accept_log,
        n_residuals=n_res,
        obs_per_frame=obs_per_frame0,
    )
    return st.t_wc, st.x_world, stats


TERMINATION_NAMES = {
    1: "max_iterations",
    2: "function_tolerance",
    3: "parameter_tolerance",
    4: "lambda_overflow",
    5: "gradient_tolerance",
}
