"""Visibility tracking: project scene points into a new frame and gate by ZNCC.

JAX replacement for the reference's hot loop no. 1 (SURVEY.md 3.2):
an OpenMP loop over `_scene_points` that projects each into the new frame,
scores ZNCC against the stored descriptor patch, and records an observation
if the score passes `minScore`. Here the whole point table is processed in
one batched program — projection, patch gather, and ZNCC are each a single
fused op over (N, P) tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..image import patches as patches_mod
from .state import PointTable


class TrackResult(NamedTuple):
    points: PointTable
    uv: jax.Array        # (N, 2) projections into the new frame
    tracked: jax.Array   # (N,) newly recorded observations
    score: jax.Array     # (N,) ZNCC scores (garbage where invalid)


def track_into_frame(
    points: PointTable,
    cam,
    t_wc_new: jax.Array,      # (4, 4) new frame pose (world-from-camera)
    channels_new: jax.Array,  # (C, H, W) new frame descriptor channels
    frame_id: jax.Array,      # () global id of the new frame
    slot: jax.Array,          # () window slot index of the new frame
    offsets: jax.Array,       # (P, 2)
    *,
    min_score: float,
    max_frame_distance: int,
    age_id: jax.Array | None = None,  # () ingest-ordinal clock for the age
                              # gate; defaults to frame_id. With keyframe
                              # skipping (cfg.minKeyframeMotion) global ids
                              # jump, so ages must count INGESTED frames —
                              # the reference's maxFrameDistance semantics.
    border_margin: float = 1.0,
    depth_new: jax.Array | None = None,     # (H, W) new frame depth
    depth_ok_new: jax.Array | None = None,  # (H, W)
    occlusion_threshold: float = 0.0,
) -> TrackResult:
    """Score all table points against the new frame; set obs[:, slot].

    occlusion_threshold > 0 adds a geometric visibility gate the reference
    lacks (its ZNCC gate misses occlusions on smooth texture): a point
    whose predicted camera depth exceeds the frame's OBSERVED stereo depth
    at its projection by more than the relative threshold is behind a
    nearer surface — occluded — and must not record an observation."""
    t_cw = se3.se3_inverse(t_wc_new)
    x_cam = se3.transform_points(t_cw, points.x_world)          # (N, 3)
    uv, in_front = cam_mod.project(cam, x_cam)

    sampled, in_bounds = patches_mod.extract_patches(channels_new, uv, offsets)
    score = patches_mod.zncc(points.patch, sampled)

    age_clock = frame_id if age_id is None else age_id
    age = age_clock - points.last_seen
    h, w = channels_new.shape[-2:]
    in_img = (
        (uv[:, 0] >= border_margin) & (uv[:, 0] <= w - 1 - border_margin)
        & (uv[:, 1] >= border_margin) & (uv[:, 1] <= h - 1 - border_margin)
    )
    tracked = (
        points.active
        & in_front
        & in_bounds
        & in_img
        & (score >= min_score)
        & (age <= max_frame_distance)
    )
    if occlusion_threshold > 0 and depth_new is not None:
        from ..image import interp as interp_mod

        z_obs, z_valid = interp_mod.bilinear(depth_new, uv)
        ok_obs, _ = interp_mod.bilinear(
            depth_ok_new.astype(depth_new.dtype), uv)
        # Only gate where the frame has confident depth (fully-valid 2x2
        # support); the gate must never DROP visibility for lack of stereo.
        has_depth = z_valid & (ok_obs > 0.999)
        occluded = has_depth & (
            x_cam[:, 2] > z_obs * (1.0 + occlusion_threshold))
        tracked = tracked & ~occluded
    obs = points.obs.at[:, slot].set(tracked)
    last_seen = jnp.where(tracked, age_clock, points.last_seen)
    return TrackResult(
        points=points._replace(obs=obs, last_seen=last_seen),
        uv=uv,
        tracked=tracked,
        score=score,
    )
