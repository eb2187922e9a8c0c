"""PhotometricBundleAdjustment — the sliding-window engine (reference L2).

JAX counterpart of the reference's `PhotometricBundleAdjustment`
class (pb:src/photobundle.h/.cc): `add_frame(image, depth, T_wc)` ingests a
frame, tracks/culls/selects points, and when the window is full runs the LM
+ Schur solve and emits refined poses.

Architecture (vs. the reference):
- The reference mutates std::vector/circular_buffer state and assembles a
  Ceres problem per window. Here ALL device state (point table, window ring)
  is a static-shape pytree; `add_frame` runs exactly two jitted programs:
  `_ingest` (descriptor build + push + track + cull + select) and, when the
  window is full, `_optimize` (the whole LM solve as one XLA computation).
- The host Python layer only moves camera frames in and refined poses out —
  there are no per-point host round-trips.

The frame loop itself stays on the host (it is inherently sequential and
I/O-bound); everything per-frame is device-side.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PBAConfig
from ..geometry.camera import Camera
from ..image import descriptor as descriptor_mod
from ..image import patches as patches_mod
from ..image import pyramid as pyramid_mod
from . import lm, selection, state, tracking


@dataclass
class WindowResult:
    """Per-window solve record — the analog of the reference's nested
    `Result` (initialCost/finalCost/iterations/message) enriched with the
    per-iteration table Ceres prints (SURVEY.md section 5.5)."""

    frame_ids: np.ndarray          # (W,) global frame ids in the window
    poses: np.ndarray              # (W, 4, 4) refined world-from-camera
    initial_cost: float = 0.0
    final_cost: float = 0.0
    iterations: int = 0
    accepted_steps: int = 0
    termination: str = ""
    num_points: int = 0
    num_residuals: int = 0
    cost_log: np.ndarray = field(default_factory=lambda: np.zeros(0))
    lambda_log: np.ndarray = field(default_factory=lambda: np.zeros(0))
    step_log: np.ndarray = field(default_factory=lambda: np.zeros(0))
    accept_log: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    solve_time_s: float = 0.0
    # Refined sparse points that participated in this solve (reference:
    # Result::refinedPoints) — (M, 3) world positions + their ref frame ids.
    points_xyz: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    points_frame: np.ndarray = field(default_factory=lambda: np.zeros(0, int))
    # Observability diagnostics (round-3 RPE instrumentation): how far the
    # solve moved each window pose from its pre-solve value, and how many
    # observations supported each slot.
    trans_correction: np.ndarray = field(default_factory=lambda: np.zeros(0))
    rot_correction: np.ndarray = field(default_factory=lambda: np.zeros(0))
    obs_per_frame: np.ndarray = field(default_factory=lambda: np.zeros(0, int))

    def message(self) -> str:
        return (
            f"window {self.frame_ids.tolist()}: cost {self.initial_cost:.6g} -> "
            f"{self.final_cost:.6g} in {self.iterations} iters "
            f"({self.accepted_steps} accepted), {self.num_points} pts / "
            f"{self.num_residuals} obs, {self.termination}"
        )


class PhotometricBundleAdjustment:
    """Sliding-window photometric BA engine.

    Usage (mirrors the reference driver, SURVEY.md 3.1):

        pba = PhotometricBundleAdjustment(camera, (H, W), cfg)
        for i, (image, depth, t_init) in enumerate(frames):
            result = pba.add_frame(image, depth, t_init)
            if result is not None:
                trajectory[result.frame_ids] = result.poses
    """

    def __init__(self, camera: Camera, image_shape, cfg: PBAConfig,
                 sharded_solver=None):
        cfg.validate()
        self.cfg = cfg
        self.camera_full = camera
        lvl = cfg.refinementLevel
        self.level_scale = 0.5 ** lvl
        self.camera = camera.scaled(self.level_scale) if lvl > 0 else camera
        h, w = image_shape
        self.image_shape = (h, w)
        self.level_shape = (h // (2 ** lvl), w // (2 ** lvl))
        self.offsets = patches_mod.patch_offsets(cfg.patchRadius)

        # Depth-prior scale in disparity-pixel units (core/residuals.py):
        # stereo noise is constant in inverse depth, sigma_q = sigma_d/(fx b).
        # Monocular (baseline 0) falls back to an fx * 0.3 m virtual baseline.
        fxb = float(self.camera.fx) * float(self.camera.baseline)
        self._prior_scale = cfg.depthPriorWeight * max(fxb, 0.3 * float(self.camera.fx))

        # Coarse-to-fine schedule: number of EXTRA coarse levels solved
        # before the standard refinement-level solve (levels
        # refinementLevel+1 .. refinementLevel+n_coarse, coarsest first).
        # Clamped so the coarsest image keeps >= 24 px on both axes.
        self._n_coarse = 0
        if cfg.coarseToFine:
            k = cfg.pyramidLevels - cfg.refinementLevel - 1
            h_l, w_l = self.level_shape
            while k > 0 and min(h_l >> k, w_l >> k) < 24:
                k -= 1
            self._n_coarse = k

        self.window = state.init_window(cfg, self.level_shape)
        self.points = state.init_point_table(cfg)
        self._frame_count = 0
        self._ingest_seq = 0    # ingested-frame ordinal: the age clock for
                                # re-tracking (robust to keyframe skipping,
                                # where global frame ids jump)
        self._window_count = 0  # host mirror of window.count (avoids a
                                # device readback per frame)
        self._sharded_solver = sharded_solver
        self._pending_result = None   # (future, t0) under pipelineResults
        self._fetch_pool = None
        self._mesh = None
        self._win_shardings = None   # frames-axis resting placement
        self._pt_shardings = None
        if cfg.meshPoints > 1 or cfg.meshFrames > 1:
            if cfg.maxNumPoints % cfg.meshPoints != 0:
                raise ValueError(
                    f"maxNumPoints {cfg.maxNumPoints} not divisible by "
                    f"meshPoints {cfg.meshPoints}")
        if cfg.meshFrames > 1:
            # ('frames', 'points') 2-D mesh (SURVEY.md 5.7 / BASELINE
            # config 4): the window ring's image leaves REST sharded over
            # 'frames' — per-chip window memory is W / meshFrames frames —
            # and the solve runs under the full ShardCtx.
            from jax.sharding import NamedSharding, PartitionSpec as P
            from ..parallel.sharded import (make_frames_mesh,
                                            window_frame_specs)

            self._mesh = make_frames_mesh(frames=cfg.meshFrames,
                                          points=cfg.meshPoints)
            ns = lambda spec: NamedSharding(self._mesh, spec)
            self._win_shardings = jax.tree.map(
                ns, window_frame_specs(P("frames"), P()))
            self._pt_shardings = jax.tree.map(
                lambda _: ns(P("points")), self.points)
            if jax.process_count() > 1:
                # Host-side frame routing across OS processes: every
                # process computes the identical initial state (and, below,
                # feeds identical replicated frame inputs); each supplies
                # only the shards its own devices address. The jitted
                # ingest's pinned out_shardings then KEEP each window slot
                # on its owning process — the cross-process frame movement
                # is XLA collective traffic, never a host hand-off.
                place = lambda a, sh: jax.make_array_from_callback(
                    np.shape(a), sh, lambda idx, _a=a: np.asarray(_a)[idx])
                self.window = jax.tree.map(place, self.window,
                                           self._win_shardings)
                self.points = jax.tree.map(place, self.points,
                                           self._pt_shardings)
            else:
                self.window = jax.device_put(self.window, self._win_shardings)
                self.points = jax.device_put(self.points, self._pt_shardings)
        elif cfg.meshPoints > 1:
            from ..parallel import make_mesh

            self._mesh = make_mesh(points=cfg.meshPoints)

        # Multi-process (multi-host) operation: when the mesh spans OS
        # processes, host inputs must become global (replicated) arrays and
        # sharded outputs must be resharded to replicated before a host
        # fetch. Every process runs the identical deterministic frame loop,
        # so replicated inputs are bitwise-identical across ranks.
        self._multiproc = (self._mesh is not None
                           and jax.process_count() > 1)
        if self._multiproc:
            from jax.sharding import NamedSharding, PartitionSpec as P

            rep = NamedSharding(self._mesh, P())
            if cfg.meshFrames <= 1:
                # Points-only meshes keep the (small) state replicated;
                # the frames mesh placed its state sharded above.
                globalize = lambda t: jax.tree.map(
                    lambda a: jax.make_array_from_process_local_data(
                        rep, np.asarray(a)), t)
                self.window = globalize(self.window)
                self.points = globalize(self.points)
            self._replicate = jax.jit(lambda t: t, out_shardings=rep)

        # Under frames sharding the ingest must keep the window's resting
        # placement (roll/update-slice would otherwise de-shard it): pin
        # the output shardings of the two state outputs.
        ingest_out = None
        if self._win_shardings is not None:
            ingest_out = (self._win_shardings, self._pt_shardings, None)
        self._ingest = jax.jit(self._ingest_impl, donate_argnums=(0, 1),
                               out_shardings=ingest_out)
        if cfg.meshFrames > 1:
            from ..parallel.sharded import wrap_engine_optimize_frames

            self._optimize = jax.jit(
                wrap_engine_optimize_frames(self._optimize_impl, self._mesh),
                donate_argnums=(0, 1))
        elif self._mesh is not None:
            from ..parallel.sharded import wrap_engine_optimize

            self._optimize = jax.jit(
                wrap_engine_optimize(self._optimize_impl, self._mesh),
                donate_argnums=(0, 1))
        else:
            self._optimize = jax.jit(
                functools.partial(self._optimize_impl, reduce_fn=None),
                donate_argnums=(0, 1))

    # ------------------------------------------------------------------ #
    # jitted implementations
    # ------------------------------------------------------------------ #
    def _prepare_level(self, image, depth, depth_ok):
        """Full-res image -> descriptor channels/grads/saliency + depth at
        the refinement level."""
        cfg = self.cfg
        levels = pyramid_mod.build_pyramid(image, cfg.pyramidLevels)
        img_l = levels[cfg.refinementLevel]
        lvl = descriptor_mod.build_descriptor_level(
            img_l, cfg.descriptor, cfg.sigmaPriorToCensusTransform,
            cfg.sigmaBitPlanes, cfg.gradientSigma
        )
        s = 2 ** cfg.refinementLevel
        depth_l = depth[::s, ::s]
        depth_ok_l = depth_ok[::s, ::s]
        return lvl, depth_l, depth_ok_l

    def _ingest_impl(self, window, points, image, depth, t_wc, frame_id,
                     age_id):
        cfg = self.cfg
        if image.dtype == jnp.uint8:
            image = image.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
        depth = depth.astype(jnp.float32)
        depth_ok = depth > 0
        lvl, depth_l, ok_l = self._prepare_level(image, depth, depth_ok)
        window, points = state.push_frame(
            window, lvl.channels, lvl.grads, lvl.saliency, t_wc, frame_id,
            depth_l, ok_l, points,
        )
        points = state.cull_points(points, window.frame_ids[0])
        slot = window.count - 1

        tr = tracking.track_into_frame(
            points, self.camera, t_wc, lvl.channels, frame_id, slot,
            self.offsets,
            min_score=cfg.minScore,
            max_frame_distance=cfg.maxFrameDistance,
            age_id=age_id,
            border_margin=cfg.patchRadius + 1,
            depth_new=depth_l,
            depth_ok_new=ok_l,
            occlusion_threshold=cfg.occlusionThreshold,
        )
        sel = selection.select_new_points(
            tr.points, self.camera, t_wc, lvl.channels, lvl.saliency,
            depth_l, ok_l, tr.uv, tr.tracked, frame_id, slot, self.offsets,
            max_new=cfg.maxPointsPerFrame,
            nms_radius=cfg.nonMaxSuppRadius,
            min_saliency=cfg.minSaliency,
            mask_radius=cfg.maskBlockRadius,
            min_depth=cfg.minDepth,
            max_depth=cfg.maxDepth,
            border=cfg.patchRadius + 2,
            edge_radius=cfg.patchRadius,
            edge_threshold=cfg.depthEdgeThreshold,
            normalize=cfg.resolve_normalization(),
            age_id=age_id,
        )
        diag = {
            "tracked": jnp.sum(tr.tracked.astype(jnp.int32)),
            "added": sel.num_added,
            "active": sel.points.num_active(),
        }
        return window, sel.points, diag

    def _optimize_impl(self, window, points, reduce_fn=None, shard_ctx=None):
        """One full window solve. Cross-shard hooks (all shard_map specs
        live in parallel/sharded, not here):
          reduce_fn  — plain psum over 'points' (wrap_engine_optimize);
          shard_ctx  — full ('frames','points') ShardCtx
                       (wrap_engine_optimize_frames): window image leaves
                       arrive as the LOCAL frame shard (W_local = W /
                       meshFrames), poses/ids replicated."""
        cfg = self.cfg
        w = cfg.slidingWindowSize
        w_local = window.channels.shape[0]
        frames_sharded = shard_ctx is not None and w_local != w

        def slice_obs(obs):
            """Point-table obs columns for the LOCAL frame shard."""
            if not frames_sharded:
                return obs
            return jax.lax.dynamic_slice_in_dim(
                obs, shard_ctx.frame_offset, w_local, 1)

        frozen = jnp.arange(w) < cfg.numFixedPoses
        # Points need >= 2 window observations to constrain anything
        # (reference: "for each ScenePoint p with >= 2 observations").
        n_obs = jnp.sum(points.obs, axis=1)
        point_valid = points.active & (n_obs >= 2)

        # Each point's reference-frame slot in the current window (for the
        # inverse-depth prior); -1 if the ref frame is not in the window.
        ref_slot = jnp.argmax(
            points.ref_frame[:, None] == window.frame_ids[None, :], axis=1
        ).astype(jnp.int32)
        in_window = jnp.any(points.ref_frame[:, None] == window.frame_ids[None, :], axis=1)
        ref_slot = jnp.where(in_window, ref_slot, -1)
        from ..geometry import camera as cam_mod
        from ..image import interp as interp_mod

        warp_mode = cfg.resolve_patch_warp()

        def solve(cam, prior_scale, max_iter, anchor,
                  t_wc0, x_world0, patch, channels, grads, obs, pv, frz,
                  ref_slot_s, seed_s, reduce_fn=None):
            depth_prior = (
                (ref_slot_s, seed_s, prior_scale)
                if cfg.depthPriorWeight > 0 else None
            )
            return lm.lm_solve(
                cam, t_wc0, x_world0, patch, channels, grads, slice_obs(obs),
                pv, frz, self.offsets,
                huber_delta=cfg.robustThreshold,
                robust_kind=cfg.robustLoss,
                gradient_mode=cfg.resolve_gradient_mode(),
                backend=cfg.resolve_backend(),
                normalize=cfg.resolve_normalization(),
                depth_prior=depth_prior,
                # Self-consistent patch warp (cfg.patchWarp): lm_solve
                # recomputes the warp factors from the CURRENT iterate each
                # evaluation; the ref-frame factor is identically 1, so no
                # per-level seed plumbing is needed (the round-4 frozen-seed
                # variant measurably biased depth toward the stereo seed —
                # see residuals.patch_warp_ref_geometry).
                # ref_slot_s (the parameter, not the closed-over global):
                # every ref-slot consumer inside one solve must see the
                # same slot array (round-5 review — a future caller passing
                # a shifted/filtered slot would otherwise get depth prior
                # and patch warp referencing different frames).
                patch_warp=((warp_mode, ref_slot_s)
                            if warp_mode is not None else None),
                motion_prior_weight=cfg.motionPriorWeight,
                motion_prior_anchor=anchor,
                pose_prior=((window.t_vo, cfg.posePriorWeight,
                             cfg.posePriorRotWeight)
                            if (cfg.posePriorWeight > 0
                                or cfg.posePriorRotWeight > 0) else None),
                max_iterations=max_iter,
                initial_lambda=cfg.initialLambda,
                min_lambda=cfg.minLambda,
                max_lambda=cfg.maxLambda,
                function_tolerance=cfg.functionTolerance,
                parameter_tolerance=cfg.parameterTolerance,
                gradient_tolerance=cfg.gradientTolerance,
                min_obs_per_frame=cfg.minObsPerFrame,
                reduce_fn=reduce_fn,
                shard_ctx=shard_ctx,
            )

        from ..geometry import se3 as se3_mod

        # Motion-prior anchor: the ORIGINAL initialization's relative
        # poses, shared by every level of the schedule.
        anchor = (se3_mod.se3_inverse(window.t_wc[:-1]) @ window.t_wc[1:]
                  if cfg.motionPriorWeight > 0 else None)

        t_cur, x_cur = window.t_wc, points.x_world
        # ---- coarse-to-fine warm start (cfg.coarseToFine; SURVEY.md 3.4:
        # the reference refines over an image pyramid). Coarse levels are
        # DERIVED inside the solve: window channels blur+decimated k times
        # (exactly build_pyramid's kernel), reference patches re-extracted
        # from the coarse ref-frame image at the point's current
        # projection. Poses/points are world-frame — warm starts carry over
        # with no rescaling. The final level below uses the STORED frozen
        # descriptors: bit-identical to the single-level path.
        for k in range(self._n_coarse, 0, -1):
            ch_k = window.channels
            for _ in range(k):
                ch_k = pyramid_mod.downsample2(pyramid_mod.gaussian_blur5(ch_k))
            gsrc_k = (pyramid_mod.gaussian_blur_sigma(ch_k, cfg.gradientSigma)
                      if cfg.gradientSigma > 0 else ch_k)
            gx, gy = interp_mod.image_gradients(gsrc_k)
            grads_k = jnp.stack([gx, gy], axis=-1)
            cam_k = self.camera.scaled(0.5 ** k)

            def per_frame(t_f, ch_f):
                t_cw = se3_mod.se3_inverse(t_f)
                y = x_cur @ t_cw[:3, :3].T + t_cw[:3, 3]
                uv, in_front = cam_mod.project(cam_k, y)
                p, ok = patches_mod.extract_patches(ch_f, uv, self.offsets)
                return p, ok & in_front

            t_frames = (jax.lax.dynamic_slice_in_dim(
                t_cur, shard_ctx.frame_offset, w_local, 0)
                if frames_sharded else t_cur)
            p_all, ok_all = jax.vmap(per_frame)(t_frames, ch_k)
            # p_all (W_local, N, C, P); ok_all (W_local, N). Pick each
            # point's REF-frame patch. Under frames sharding this is a
            # cross-shard gather: exactly one shard owns a point's ref
            # frame, so a local one-hot select + psum over 'frames'
            # replicates the patch everywhere (~N*C*P floats).
            safe = jnp.maximum(ref_slot, 0)
            loc = safe - (shard_ctx.frame_offset if frames_sharded else 0)
            sel = jnp.arange(w_local)[:, None] == loc[None, :]  # (W_local, N)
            p_ref = jnp.sum(
                jnp.where(sel[..., None, None], p_all, 0.0), axis=0)
            ok_ref = jnp.any(sel & ok_all, axis=0)
            if frames_sharded:
                p_ref = shard_ctx.reduce_frames(p_ref)
                ok_ref = shard_ctx.reduce_frames(ok_ref.astype(jnp.int32)) > 0
            patch_k = patches_mod.normalize_patches(
                p_ref, cfg.resolve_normalization())
            pv_k = point_valid & ok_ref & (ref_slot >= 0)
            t_cur, x_cur, _ = solve(
                cam_k, self._prior_scale * (0.5 ** k), cfg.coarseIterations,
                anchor, t_cur, x_cur, patch_k, ch_k, grads_k, points.obs,
                pv_k, frozen, ref_slot, points.inv_depth_seed,
                reduce_fn=reduce_fn)

        if self._n_coarse > 0:
            # Warm-start guard: a coarse level optimizes ITS OWN objective
            # (re-extracted descriptors on a decimated image); on windows
            # with few/fresh points (e.g. during fast rotation) it can
            # reduce coarse cost while walking the fine-level objective up.
            # Accept the warm start only if it does not increase the
            # FINE-level cost; otherwise fall back to the initialization.
            from .residuals import evaluate_compressed as _ev

            _backend = cfg.resolve_backend()
            _gmode = cfg.resolve_gradient_mode()

            _pp = ((window.t_vo, cfg.posePriorWeight, cfg.posePriorRotWeight)
                   if (cfg.posePriorWeight > 0 or cfg.posePriorRotWeight > 0)
                   else None)

            def fine_cost(t, x):
                # Mirrors lm_solve's frames-sharded evaluation: local frame
                # slice of the poses/obs columns, ref slots shifted into the
                # local frame, photometric cost psummed over BOTH axes.
                _off = shard_ctx.frame_offset if frames_sharded else 0
                dp = ((ref_slot - _off, points.inv_depth_seed,
                       self._prior_scale)
                      if cfg.depthPriorWeight > 0 else None)
                t_loc = (jax.lax.dynamic_slice_in_dim(t, _off, w_local, 0)
                         if frames_sharded else t)
                pw = None
                if warp_mode is not None:
                    from .residuals import patch_warp_ref_geometry as _pwg
                    z_ref, r_wc_ref = _pwg(t, x, ref_slot)
                    pw = (warp_mode, z_ref, r_wc_ref)
                res = _ev(self.camera, t_loc, x, points.patch,
                          window.channels, window.grads,
                          slice_obs(points.obs) & point_valid[:, None],
                          self.offsets, cfg.robustThreshold,
                          _gmode, depth_prior=dp,
                          backend=_backend,
                          normalize=cfg.resolve_normalization(),
                          robust_kind=cfg.robustLoss,
                          patch_warp=pw)
                c = res.cost
                if shard_ctx is not None:
                    c = shard_ctx.reduce_obs(c)
                elif reduce_fn is not None:
                    c = reduce_fn(c)
                # The guard must compare the FULL objective the final solve
                # optimizes: prior terms added AFTER the reduce (replicated
                # pose math), mirroring lm_solve.
                return c + lm.prior_cost(
                    t, motion_prior_weight=cfg.motionPriorWeight,
                    rel0=anchor, pose_prior=_pp)

            use_warm = fine_cost(t_cur, x_cur) < fine_cost(
                window.t_wc, points.x_world)
            t_cur = jnp.where(use_warm, t_cur, window.t_wc)
            x_cur = jnp.where(use_warm, x_cur, points.x_world)

        # ---- final solve at the refinement level (stored descriptors).
        t_wc, x_world, stats = solve(
            self.camera, self._prior_scale, cfg.maxIterations, anchor,
            t_cur, x_cur, points.patch, window.channels, window.grads,
            points.obs, point_valid, frozen, ref_slot,
            points.inv_depth_seed, reduce_fn=reduce_fn)
        # Window trust gate (cfg.maxPoseCorrection): a diverged solve can
        # DECREASE photometric cost while moving poses by meters (occlusion
        # violations, degenerate forward-motion geometry); accepting it
        # poisons every later window through the frozen-pose chain and the
        # reanchor step. Reject the whole window when any pose moved
        # implausibly far; the VO initialization is kept.
        # Under coarse-to-fine the gate scales with the schedule (x 2^k):
        # the coarse levels exist precisely to legitimize larger
        # corrections, and a fixed gate would silently revert them
        # (round-2 advisor finding — see the cross-reference in config.py).
        if cfg.maxPoseCorrection > 0:
            gate = cfg.maxPoseCorrection * float(2 ** self._n_coarse)
            corr = jnp.linalg.norm(
                t_wc[:, :3, 3] - window.t_wc[:, :3, 3], axis=-1)
            sane = jnp.max(corr) <= gate
            t_wc = jnp.where(sane, t_wc, window.t_wc)
            x_world = jnp.where(sane, x_world, points.x_world)

        # Points excluded from the solve (fresh single-observation points)
        # were positioned with their reference frame's PRE-solve pose; move
        # them rigidly with that frame (X <- T_new T_old^{-1} X) so they stay
        # consistent. Without this, every new frame injects stale-pose error
        # into the next window and the sliding chain amplifies drift.
        from ..geometry import se3 as se3_mod

        delta = t_wc @ se3_mod.se3_inverse(window.t_wc)      # (W, 4, 4)
        safe_slot = jnp.maximum(ref_slot, 0)
        moved = se3_mod.transform_points(delta[safe_slot], x_world)
        reanchor = points.active & (~point_valid) & (ref_slot >= 0)
        x_world = jnp.where(reanchor[:, None], moved, x_world)

        window = window._replace(t_wc=t_wc)
        points = points._replace(x_world=x_world)
        return window, points, stats, point_valid

    # ------------------------------------------------------------------ #
    # host API
    # ------------------------------------------------------------------ #
    def _put(self, a):
        """Host -> device transport; under multi-process operation the
        array becomes a global replicated array over the mesh."""
        if self._multiproc:
            from jax.sharding import NamedSharding, PartitionSpec as P

            return jax.make_array_from_process_local_data(
                NamedSharding(self._mesh, P()), np.asarray(a))
        return jnp.asarray(a)

    def add_frame(self, image: np.ndarray, depth: np.ndarray,
                  t_wc: np.ndarray, depth_valid: Optional[np.ndarray] = None,
                  frame_id: Optional[int] = None) -> Optional[WindowResult]:
        """Ingest one frame; returns a WindowResult when a solve ran.

        image: (H, W) grayscale, any scale (normalized to [0, 1] internally).
        depth: (H, W) metric depth; <= 0 marks invalid.
        t_wc:  (4, 4) initial world-from-camera pose (e.g. from VO).
        frame_id: global frame index (defaults to an internal counter; pass
            the dataset index explicitly when resuming mid-sequence so the
            emitted WindowResult.frame_ids address the right trajectory rows).
        """
        import time

        # Host->device transport: (a) images travel as uint8 and depth as
        # float16 when lossless-enough (cfg transportCompress), (b) validity
        # rides inside depth (invalid = 0), and (c) NOTHING below blocks on
        # the device until a window solve's single batched fetch.
        image = np.asarray(image)
        if image.dtype != np.uint8:
            image = np.asarray(image, np.float32)
            if image.max() > 2.0:  # 8-bit-scaled input
                image = image * np.float32(1.0 / 255.0)
            if self.cfg.transportCompress:
                s = image * 255.0
                r = np.rint(s)
                if np.abs(s - r).max() < 1e-3:  # exactly 8-bit data
                    image = r.astype(np.uint8)
        depth = np.asarray(depth, np.float32)
        if depth_valid is not None:
            depth = np.where(depth_valid, depth, 0.0)
        if self.cfg.transportDepth16:
            depth = depth.astype(np.float16)
        if frame_id is None:
            frame_id = self._frame_count
        self._frame_count = frame_id + 1
        age_id = self._ingest_seq
        self._ingest_seq += 1
        self._window_count = min(self._window_count + 1,
                                 self.cfg.slidingWindowSize)

        self.window, self.points, diag = self._ingest(
            self.window, self.points,
            self._put(image), self._put(depth),
            self._put(np.asarray(t_wc, np.float32)),
            self._put(np.asarray(frame_id, np.int32)),
            self._put(np.asarray(age_id, np.int32)),
        )

        if self._window_count < self.cfg.slidingWindowSize:
            return None

        t0 = time.perf_counter()
        # Pre-solve poses (fresh array — survives the donation of the
        # window buffers into _optimize): the per-pose correction the solve
        # applied is the key observability diagnostic.
        t_pre = self.window.t_wc + 0
        if self._sharded_solver is not None:
            self.window, self.points, stats, point_valid = self._sharded_solver(
                self.window, self.points)
        else:
            self.window, self.points, stats, point_valid = self._optimize(
                self.window, self.points)
        handles = (stats, self.window.frame_ids, self.window.t_wc,
                   point_valid, self.points.x_world, self.points.ref_frame,
                   t_pre)
        if self._multiproc:
            # Points-sharded leaves are not addressable from one process;
            # reshard the (small) fetched handles to replicated first.
            handles = self._replicate(handles)
        if self.cfg.pipelineResults:
            # Overlap the result round-trip with the NEXT frame's work: a
            # background thread fetches this window's results; the PREVIOUS
            # window's (already-arrived) result is returned now. Results lag
            # one frame; WindowResult.frame_ids keeps the contract exact.
            import concurrent.futures

            if self._fetch_pool is None:
                self._fetch_pool = concurrent.futures.ThreadPoolExecutor(1)
            # The window/points buffers will be DONATED into the next
            # frame's ingest before the background fetch completes — snap
            # device copies of those (tiny) so the fetch can't see
            # deleted arrays.
            stats, frame_ids, t_wc_a, point_valid, xw_a, rf_a, t_pre = handles
            handles = (stats, frame_ids + 0, t_wc_a + 0, point_valid,
                       xw_a + 0, rf_a + 0, t_pre)
            prev = self._pending_result
            self._pending_result = (
                self._fetch_pool.submit(jax.device_get, handles), t0)
            if prev is None:
                return None
            fut, t0 = prev
            fetched = fut.result()
        else:
            # ONE batched device fetch per window (each separate fetch is a
            # device synchronisation).
            fetched = jax.device_get(handles)
        return self._make_result(fetched, time.perf_counter() - t0)

    def _make_result(self, fetched, dt: float) -> WindowResult:
        stats, frame_ids, poses, pv, xw, rf, t_pre = fetched
        it = int(stats.iterations)
        dtc = poses[:, :3, 3] - t_pre[:, :3, 3]
        # Rotation correction angle from the relative rotation's trace.
        rrel = np.einsum("wij,wik->wjk", t_pre[:, :3, :3], poses[:, :3, :3])
        ctheta = np.clip((np.trace(rrel, axis1=1, axis2=2) - 1.0) / 2.0,
                         -1.0, 1.0)
        return WindowResult(
            frame_ids=frame_ids,
            poses=poses,
            initial_cost=float(stats.initial_cost),
            final_cost=float(stats.final_cost),
            iterations=it,
            accepted_steps=int(stats.accepted_steps),
            termination=lm.TERMINATION_NAMES.get(int(stats.termination), "?"),
            num_points=int(pv.sum()),
            num_residuals=int(stats.n_residuals),
            cost_log=np.asarray(stats.cost_log)[:it],
            lambda_log=np.asarray(stats.lambda_log)[:it],
            step_log=np.asarray(stats.step_log)[:it],
            accept_log=np.asarray(stats.accept_log)[:it],
            solve_time_s=dt,
            points_xyz=xw[pv],
            points_frame=rf[pv],
            trans_correction=np.linalg.norm(dtc, axis=-1),
            rot_correction=np.arccos(ctheta),
            obs_per_frame=np.asarray(stats.obs_per_frame),
        )

    def flush_result(self) -> Optional[WindowResult]:
        """Drain the in-flight window result (pipelineResults mode); call
        once after the frame loop so the final window is not lost."""
        if self._pending_result is None:
            return None
        import time

        fut, t0 = self._pending_result
        self._pending_result = None
        return self._make_result(fut.result(), time.perf_counter() - t0)

    @property
    def num_active_points(self) -> int:
        return int(self.points.num_active())

    # ------------------------------------------------------------------ #
    # state snapshots (SURVEY.md 5.4: optimizer-state snapshot for long
    # multi-host runs — bitwise-exact resume, unlike the re-ingest path)
    # ------------------------------------------------------------------ #
    def save_state(self, path: str) -> None:
        """Serialize the full device state (point table + window ring +
        frame counter) to one npz. ~tens of MB at KITTI scale — intended
        for periodic snapshots, not per-window writes."""
        points, window = self.points, self.window
        if self._multiproc:
            # Sharded leaves are not addressable from one process; pull a
            # replicated copy (identical on every rank — each rank writes
            # the same snapshot bytes).
            points, window = self._replicate((points, window))
        state = {}
        for name, arr in points._asdict().items():
            state[f"points.{name}"] = np.asarray(arr)
        for name, arr in window._asdict().items():
            state[f"window.{name}"] = np.asarray(arr)
        state["frame_count"] = np.asarray(self._frame_count)
        state["ingest_seq"] = np.asarray(self._ingest_seq)
        tmp = path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **state)
        os.replace(tmp, path)

    def load_state(self, path: str) -> None:
        """Restore a save_state snapshot (shapes must match the config)."""
        data = np.load(path)
        self.points = self.points._replace(**{
            name: jnp.asarray(data[f"points.{name}"])
            for name in self.points._fields})
        self.window = self.window._replace(**{
            name: jnp.asarray(data[f"window.{name}"])
            for name in self.window._fields
            if f"window.{name}" in data.files})
        if self._win_shardings is not None:
            # Restore the frames-mesh resting placement (multiproc: each
            # rank loads the identical snapshot and supplies its shards).
            if self._multiproc:
                place = lambda a, sh: jax.make_array_from_callback(
                    np.shape(a), sh, lambda idx, _a=a: np.asarray(_a)[idx])
                self.window = jax.tree.map(place, self.window,
                                           self._win_shardings)
                self.points = jax.tree.map(place, self.points,
                                           self._pt_shardings)
            else:
                self.window = jax.device_put(self.window, self._win_shardings)
                self.points = jax.device_put(self.points, self._pt_shardings)
        if "window.t_vo" not in data.files:   # pre-round-3 snapshot
            self.window = self.window._replace(t_vo=self.window.t_wc)
        self._frame_count = int(data["frame_count"])
        self._ingest_seq = (int(data["ingest_seq"])
                            if "ingest_seq" in data.files
                            else self._frame_count)
        self._window_count = int(data["window.count"])
