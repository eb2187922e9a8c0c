"""Batched multi-sequence engine: B sliding windows on one chip.

BASELINE config 3 ("concurrent sequence refinement"): the per-sequence
engine state (point table + window ring) is a pytree, and ingest/solve are
pure functions of it — so B sequences batch by stacking the state and
vmapping the SAME jitted programs the single engine runs. LM runs until
every window in the batch converges (per-window tolerances still apply —
converged windows just stop accepting steps).

Whether one card gains from batching KITTI-scale windows is not measured
yet (tools/bench_batched.py times it). The batch axis is meant for (a)
many SMALL windows (dispatch amortization) and (b) a 'windows' mesh axis
where each window gets its own card (parallel/sharded.py
make_batched_sharded_solver) — this class is the state-management layer
for both.

Constraints: all sequences share one camera calibration and frame clock
(frame i of every sequence is ingested together); sequences of different
lengths can be padded by repeating their last frame with tracking disabled
(mask via per-batch active flag).

The reference has no counterpart (strictly one window); the multi-process
driver (multi.py) is the ACROSS-chips DP axis, this is the WITHIN-chip one.
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PBAConfig
from ..geometry.camera import Camera
from . import lm, state
from .engine import PhotometricBundleAdjustment, WindowResult


class BatchedPhotometricBundleAdjustment:
    """B concurrent sliding-window engines, one device, one jit program.

    Usage:
        bpba = BatchedPhotometricBundleAdjustment(camera, (H, W), cfg, B)
        for i in range(n_frames):
            results = bpba.add_frames(images_B, depths_B, t_init_B)
            for b, r in enumerate(results or []):
                ...
    """

    def __init__(self, camera: Camera, image_shape, cfg: PBAConfig,
                 batch: int):
        import functools

        self.batch = batch
        self.cfg = cfg
        mw, mp = cfg.meshWindows, cfg.meshPoints
        sharded = mw > 1 or mp > 1
        # A single (non-batched) engine provides the jitted implementations;
        # its own state is unused. It must NOT build its own mesh — the
        # ('windows', 'points') wrapping happens HERE, at the batch level.
        proto_cfg = cfg.replace(meshPoints=1, meshWindows=1) if sharded else cfg
        self._proto = PhotometricBundleAdjustment(camera, image_shape,
                                                  proto_cfg)
        stack = lambda tree: jax.tree.map(
            lambda a: jnp.broadcast_to(a, (batch,) + a.shape), tree)
        self.window = stack(state.init_window(cfg, self._proto.level_shape))
        self.points = stack(state.init_point_table(cfg))
        self._frame_count = 0
        self._ingest_seq = 0
        self._window_count = 0

        proto = self._proto
        self._ingest = jax.jit(
            jax.vmap(proto._ingest_impl, in_axes=(0, 0, 0, 0, 0, None, None)),
            donate_argnums=(0, 1))
        if sharded:
            # cfg.meshWindows x cfg.meshPoints, end-to-end from the config
            # (BASELINE configs 3/5): window-batch DP over 'windows',
            # points-sharded Schur within each window over 'points'.
            from ..parallel import make_mesh
            from ..parallel.sharded import (check_point_capacity,
                                            wrap_batched_optimize)

            if batch % mw != 0:
                raise ValueError(
                    f"batch {batch} not divisible by meshWindows {mw}")
            self._mesh = make_mesh(points=mp, windows=mw)
            check_point_capacity(cfg.maxNumPoints, self._mesh)
            self._optimize = jax.jit(
                wrap_batched_optimize(proto._optimize_impl, self._mesh),
                donate_argnums=(0, 1))
        else:
            self._mesh = None
            self._optimize = jax.jit(
                jax.vmap(functools.partial(proto._optimize_impl,
                                           reduce_fn=None)),
                donate_argnums=(0, 1))

    def add_frames(self, images, depths, t_wcs,
                   depth_valids=None,
                   frame_id: Optional[int] = None
                   ) -> Optional[List[WindowResult]]:
        """Ingest frame i of every sequence; returns B WindowResults when
        the windows are full (they fill in lockstep)."""
        import time

        b = self.batch
        images = np.stack([np.asarray(im, np.float32) for im in images])
        if images.max() > 2.0:
            # Multiply by the shared f32 reciprocal (never /255): the repo's
            # bitwise-determinism convention — engine.add_frame and
            # io/kitti._imread_gray normalize the same way, and a 1-ulp
            # difference would reshuffle point-selection tie-breaks.
            images = images * np.float32(1.0 / 255.0)
        depths = np.stack([np.asarray(d, np.float32) for d in depths])
        if depth_valids is not None:
            depths = np.where(np.stack(depth_valids), depths, 0.0)
        t_wcs = np.stack([np.asarray(t, np.float32) for t in t_wcs])
        if frame_id is None:
            frame_id = self._frame_count
        self._frame_count = frame_id + 1
        self._window_count = min(self._window_count + 1,
                                 self.cfg.slidingWindowSize)

        # Lockstep ingest: the age clock equals the shared ingest ordinal.
        age_id = self._ingest_seq
        self._ingest_seq += 1
        self.window, self.points, _ = self._ingest(
            self.window, self.points, jnp.asarray(images),
            jnp.asarray(depths), jnp.asarray(t_wcs),
            jnp.asarray(frame_id, jnp.int32),
            jnp.asarray(age_id, jnp.int32))

        if self._window_count < self.cfg.slidingWindowSize:
            return None
        t0 = time.perf_counter()
        self.window, self.points, stats, point_valid = self._optimize(
            self.window, self.points)
        stats, frame_ids, poses, pv, xw, rf = jax.device_get(
            (stats, self.window.frame_ids, self.window.t_wc, point_valid,
             self.points.x_world, self.points.ref_frame))
        dt = time.perf_counter() - t0

        results = []
        for k in range(b):
            it = int(stats.iterations[k])
            results.append(WindowResult(
                frame_ids=frame_ids[k],
                poses=poses[k],
                initial_cost=float(stats.initial_cost[k]),
                final_cost=float(stats.final_cost[k]),
                iterations=it,
                accepted_steps=int(stats.accepted_steps[k]),
                termination=lm.TERMINATION_NAMES.get(
                    int(stats.termination[k]), "?"),
                num_points=int(pv[k].sum()),
                num_residuals=int(stats.n_residuals[k]),
                cost_log=np.asarray(stats.cost_log[k])[:it],
                lambda_log=np.asarray(stats.lambda_log[k])[:it],
                step_log=np.asarray(stats.step_log[k])[:it],
                accept_log=np.asarray(stats.accept_log[k])[:it],
                obs_per_frame=np.asarray(stats.obs_per_frame[k]),
                solve_time_s=dt,
                points_xyz=xw[k][pv[k]],
                points_frame=rf[k][pv[k]],
            ))
        return results
