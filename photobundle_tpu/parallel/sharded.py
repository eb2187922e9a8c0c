"""Multi-device BA solve wiring: ALL shard_map specs live here.

JAX replacement for Ceres' pthread parallel Jacobian evaluation /
Schur eliminator (reference: Solver::Options::num_threads,
pb:src/photobundle.cc) — SURVEY.md sections 2a/2b/5.7/5.8.

Sharding layout (the "residual-block sharding" strategy):
  - All (N, ...) point tensors (positions, patches, obs masks) are sharded
    over the 'points' mesh axis. Each chip evaluates residuals/Jacobians and
    per-point Schur blocks for its shard only.
  - Window images and poses are replicated (a 5-50 frame window is a few MB
    — cheap next to the Jacobian-side tensors). For LARGE windows see the
    'frames'-axis sharding (wrap_frames_sharded_solve below).
  - The distributed Schur reduction is exactly TWO psums per LM iteration:
    the (W, 6, 6)+(W, 6) pose blocks and the (W, W, 6, 6)+(W, 6) reduced
    contributions (see core/schur.reduce_camera_system).
  - The reduced 6W x 6W solve is tiny and replicated on every chip, so the
    accepted/rejected LM branch and the pose update are bitwise identical
    across shards — the gauge-consistency requirement of SURVEY.md 'hard
    parts'.
  - Point back-substitution and point updates stay shard-local. Zero
    gather/scatter of point state between chips.
  - The 'windows' mesh axis vmaps independent window problems
    (multi-sequence DP, BASELINE configs 3/5): batched solves shard over it
    with no cross-communication at all.

This module is the ONE place that declares which engine-state leaves are
point-sharded vs replicated; the engine (core/engine.py) and the batched
engine (core/batched.py) both wrap their `_optimize_impl` through it, so
the specs cannot drift apart (round-1 VERDICT item 4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core import lm, state
from ..geometry.camera import Camera

POINTS_AXIS = "points"
WINDOWS_AXIS = "windows"
FRAMES_AXIS = "frames"


def make_frames_mesh(frames: int = 1, points: int = 1, devices=None):
    """('frames', 'points') mesh for large-window solves (SURVEY.md 5.7 /
    BASELINE config 4): window images sharded over 'frames' so per-chip
    image memory is W / n_frames frames."""
    import numpy as np

    devices = list(devices if devices is not None else jax.devices())
    need = frames * points
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(frames, points)
    return Mesh(arr, axis_names=(FRAMES_AXIS, POINTS_AXIS))


def _stats_specs(spec) -> lm.LMStats:
    return lm.LMStats(*([spec] * len(lm.LMStats._fields)))


def _window_specs(spec) -> state.Window:
    return state.Window(*([spec] * len(state.Window._fields)))


def _point_specs(spec) -> state.PointTable:
    return state.PointTable(*([spec] * len(state.PointTable._fields)))


def check_point_capacity(n_points: int, mesh: Mesh,
                         axis: str = POINTS_AXIS) -> None:
    """Capacity padding rule: the point table must divide the points axis.
    Inactive slots are dead weight but keep shapes static — the
    load-imbalance strategy of SURVEY.md 'hard parts' (capacity padding +
    occupancy masks)."""
    n_shards = mesh.shape[axis]
    if n_points % n_shards != 0:
        raise ValueError(
            f"point capacity {n_points} not divisible by {axis} axis "
            f"{n_shards}")


def wrap_engine_optimize(optimize_impl, mesh: Mesh, *,
                         axis: str = POINTS_AXIS):
    """Points-shard the engine's whole `_optimize_impl(window, points,
    reduce_fn)` : window leaves replicated, point-table leaves sharded on
    their leading (N) axis, cross-shard reduction = one psum hook threaded
    into the LM loop. Returns the shard_map-wrapped callable (un-jitted)."""
    pt, rep = P(axis), P()
    fn = functools.partial(
        optimize_impl, reduce_fn=lambda x: jax.lax.psum(x, axis))
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(_window_specs(rep), _point_specs(pt)),
        out_specs=(_window_specs(rep), _point_specs(pt), _stats_specs(rep),
                   pt),
        check_vma=False,
    )


def frames_shard_ctx(w_local: int) -> lm.ShardCtx:
    """The ('frames','points') reduction wiring — ONE definition shared by
    the standalone frames-sharded solver and the engine meshFrames path so
    the two cannot drift apart (gather axis, frame_offset formula)."""
    return lm.ShardCtx(
        reduce_points=lambda v: jax.lax.psum(v, POINTS_AXIS),
        reduce_frames=lambda v: jax.lax.psum(v, FRAMES_AXIS),
        reduce_obs=lambda v: jax.lax.psum(v, (FRAMES_AXIS, POINTS_AXIS)),
        gather_frames=lambda v, axis: jax.lax.all_gather(
            v, FRAMES_AXIS, axis=axis, tiled=True),
        frame_offset=jax.lax.axis_index(FRAMES_AXIS) * w_local,
    )


def window_frame_specs(spec_frames, spec_rep) -> state.Window:
    """Window specs for frames-axis sharding: the per-frame IMAGE leaves
    (channels/grads/saliency/depth/depth_ok) sharded over 'frames' on their
    leading (W) axis — the memory that used to be replicated — while poses,
    frame ids and the occupancy count stay replicated (they are the tiny
    globally-coupled state every shard needs)."""
    return state.Window(
        channels=spec_frames, grads=spec_frames, saliency=spec_frames,
        t_wc=spec_rep, t_vo=spec_rep, frame_ids=spec_rep,
        depth=spec_frames, depth_ok=spec_frames, count=spec_rep)


def wrap_engine_optimize_frames(optimize_impl, mesh: Mesh):
    """Engine solve over the ('frames', 'points') 2-D mesh (round-3: the
    engine-level wiring of make_frames_sharded_solver's layout — SURVEY.md
    5.7, BASELINE config 4). Window image leaves arrive sharded over
    'frames' (per-chip window memory = W / n_frames frames), point-table
    leaves over 'points'; `optimize_impl(window, points, shard_ctx=...)`
    receives the full ShardCtx instead of the plain points-psum hook.
    Returns the shard_map-wrapped callable (un-jitted)."""
    fr, pt, rep = P(FRAMES_AXIS), P(POINTS_AXIS), P()

    def fn(window, points):
        sc = frames_shard_ctx(window.channels.shape[0])
        return optimize_impl(window, points, shard_ctx=sc)

    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(window_frame_specs(fr, rep), _point_specs(pt)),
        out_specs=(window_frame_specs(fr, rep), _point_specs(pt),
                   _stats_specs(rep), pt),
        check_vma=False,
    )


def wrap_batched_optimize(optimize_impl, mesh: Mesh, *,
                          points_axis: str = POINTS_AXIS,
                          windows_axis: str = WINDOWS_AXIS):
    """Batched multi-window optimize over a ('windows', 'points') mesh:
    vmap over the leading window-batch axis (sharded over 'windows' — pure
    DP, no cross-talk), points sharded within each window (psum over
    'points' only). Drives BASELINE configs 3/5 from cfg.meshWindows x
    cfg.meshPoints (core/batched.py)."""
    w, rep_w = P(windows_axis, points_axis), P(windows_axis)
    fn = jax.vmap(functools.partial(
        optimize_impl, reduce_fn=lambda x: jax.lax.psum(x, points_axis)))
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(_window_specs(rep_w), _point_specs(w)),
        out_specs=(_window_specs(rep_w), _point_specs(w), _stats_specs(rep_w),
                   w),
        check_vma=False,
    )


def make_frames_sharded_solver(mesh: Mesh, cam: Camera, offsets: jax.Array, *,
                               n_points: int, window_size: int,
                               huber_delta: float,
                               robust_kind: str = "huber",
                               gradient_mode: str = "sampled",
                               backend: str = "xla",
                               normalize: bool = True,
                               depth_prior_weight: float = 0.0,
                               motion_prior_weight: float = 0.0,
                               max_iterations: int = 50,
                               function_tolerance: float = 1e-6,
                               parameter_tolerance: float = 1e-8):
    """Large-window LM solve over the ('frames', 'points') 2-D mesh — the
    keyframe-axis partitioning of SURVEY.md 5.7 ("ring-attention of BA",
    BASELINE config 4). Per chip:

      - channels/grads: W/n_frames frames (the memory that used to be
        replicated — the whole point of this layout)
      - point tensors: N/n_points points
      - per LM iteration: psum(hpp, bp) over 'frames', psum+all_gather of
        the tiny pose blocks, one all_gather (axis 0) of the point-minor
        (W_local, 3, 6, N_local) coupling over 'frames', psum(S, rhs) over
        'points'; poses and the reduced 6W x 6W solve replicated everywhere.

    Signature: solver(t_wc (W,4,4), x (N,3), patch, channels (W,...),
    grads, obs (N,W), point_valid (N,), frozen (W,)[, ref_slot (N,),
    inv_depth_seed (N,)]) — the trailing two only when depth_prior_weight>0.
    """
    check_point_capacity(n_points, mesh)
    n_frames = mesh.shape[FRAMES_AXIS]
    if window_size % n_frames != 0:
        raise ValueError(
            f"window size {window_size} not divisible by frames axis "
            f"{n_frames}")
    w_local = window_size // n_frames
    use_prior = depth_prior_weight > 0.0

    def solve_local(t_wc, x_world, patch, channels, grads, obs_mask,
                    point_valid, frozen, ref_slot=None, seed=None):
        sc = frames_shard_ctx(w_local)
        depth_prior = ((ref_slot, seed, depth_prior_weight)
                       if use_prior else None)
        return lm.lm_solve(
            cam, t_wc, x_world, patch, channels, grads, obs_mask,
            point_valid, frozen, offsets,
            huber_delta=huber_delta, robust_kind=robust_kind,
            gradient_mode=gradient_mode,
            backend=backend, normalize=normalize, depth_prior=depth_prior,
            motion_prior_weight=motion_prior_weight,
            max_iterations=max_iterations,
            function_tolerance=function_tolerance,
            parameter_tolerance=parameter_tolerance,
            shard_ctx=sc,
        )

    pt, fr, rep = P(POINTS_AXIS), P(FRAMES_AXIS), P()
    in_specs = [rep, pt, pt, fr, fr, P(POINTS_AXIS, FRAMES_AXIS), pt, rep]
    if use_prior:
        in_specs += [pt, pt]
    return jax.jit(
        jax.shard_map(
            solve_local,
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=(rep, pt, _stats_specs(rep)),
            check_vma=False,
        )
    )


class ShardedLMSolver:
    """Points-sharded raw LM solve with the same signature as
    core.lm.lm_solve — the library-level entry for callers that manage
    their own tensors (tools/demo_multiprocess.py, benchmarks). The full
    engine does NOT go through this class; it wraps its `_optimize_impl`
    with wrap_engine_optimize above (same axis name, same psum hook)."""

    def __init__(self, mesh: Mesh, cam: Camera, offsets: jax.Array, *,
                 n_points: int, huber_delta: float,
                 robust_kind: str = "huber",
                 gradient_mode: str = "sampled", backend: str = "xla",
                 normalize: bool = True,
                 max_iterations: int = 50,
                 initial_lambda: float = 1e-4, function_tolerance: float = 1e-6,
                 parameter_tolerance: float = 1e-8):
        if POINTS_AXIS not in mesh.axis_names:
            raise ValueError(f"mesh must have a '{POINTS_AXIS}' axis")
        check_point_capacity(n_points, mesh)
        self.mesh = mesh
        self.cam = cam
        self.offsets = offsets

        def solve_local(t_wc, x_world, patch, channels, grads, obs_mask,
                        point_valid, frozen, reduce_fn):
            return lm.lm_solve(
                cam, t_wc, x_world, patch, channels, grads, obs_mask,
                point_valid, frozen, offsets,
                huber_delta=huber_delta, robust_kind=robust_kind,
                gradient_mode=gradient_mode,
                backend=backend, normalize=normalize,
                max_iterations=max_iterations, initial_lambda=initial_lambda,
                function_tolerance=function_tolerance,
                parameter_tolerance=parameter_tolerance,
                reduce_fn=reduce_fn,
            )

        pt, rep = P(POINTS_AXIS), P()
        self._solve = jax.jit(
            jax.shard_map(
                functools.partial(
                    solve_local,
                    reduce_fn=lambda x: jax.lax.psum(x, POINTS_AXIS)),
                mesh=mesh,
                in_specs=(rep, pt, pt, rep, rep, pt, pt, rep),
                out_specs=(rep, pt, _stats_specs(rep)),
                check_vma=False,
            )
        )

    def __call__(self, t_wc, x_world, patch, channels, grads, obs_mask,
                 point_valid, frozen):
        return self._solve(t_wc, x_world, patch, channels, grads, obs_mask,
                           point_valid, frozen)


def make_batched_sharded_solver(mesh: Mesh, cam: Camera, offsets: jax.Array, *,
                                n_points: int, huber_delta: float,
                                robust_kind: str = "huber",
                                gradient_mode: str = "sampled",
                                backend: str = "xla",
                                depth_prior_weight: float = 0.0,
                                max_iterations: int = 20,
                                function_tolerance: float = 1e-6,
                                parameter_tolerance: float = 1e-8):
    """Batched raw multi-window lm_solve: vmap over a leading window-batch
    axis, sharded over ('windows', 'points'). Library-level counterpart of
    wrap_batched_optimize. Inputs gain a leading B axis; B must be
    divisible by the 'windows' axis size. With depth_prior_weight > 0 the
    solver takes two more (B, N) inputs, ref_slot and inv_depth_seed, as
    make_frames_sharded_solver does."""
    check_point_capacity(n_points, mesh)
    use_prior = depth_prior_weight > 0.0

    def solve_one(t_wc, x_world, patch, channels, grads, obs_mask,
                  point_valid, frozen, ref_slot=None, seed=None):
        return lm.lm_solve(
            cam, t_wc, x_world, patch, channels, grads, obs_mask,
            point_valid, frozen, offsets,
            huber_delta=huber_delta, robust_kind=robust_kind,
            gradient_mode=gradient_mode, backend=backend,
            depth_prior=((ref_slot, seed, depth_prior_weight)
                         if use_prior else None),
            max_iterations=max_iterations,
            function_tolerance=function_tolerance,
            parameter_tolerance=parameter_tolerance,
            reduce_fn=lambda x: jax.lax.psum(x, POINTS_AXIS),
        )

    batched = jax.vmap(solve_one)
    wpt = P(WINDOWS_AXIS, POINTS_AXIS)
    wrep = P(WINDOWS_AXIS)
    in_specs = [wrep, wpt, wpt, wrep, wrep, wpt, wpt, wrep]
    if use_prior:
        in_specs += [wpt, wpt]
    return jax.jit(
        jax.shard_map(
            batched,
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=(wrep, wpt, _stats_specs(wrep)),
            check_vma=False,
        )
    )
