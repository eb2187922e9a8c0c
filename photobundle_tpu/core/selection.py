"""New-point selection: saliency NMS + masked admission into the point table.

JAX replacement for the reference's hot loop no. 2 (SURVEY.md 3.2):
scan the saliency map, non-max suppress, skip blocks near tracked points,
require valid depth, backproject, store descriptor patch, cap point count.
The reference does this with sequential loops and a mutable mask image; here
it is one jitted program at static shape:

  1. NMS on the saliency map (`lax.reduce_window`).
  2. "Mask blocks around tracked points": scatter tracked projections into an
     occupancy image, dilate by maskBlockRadius with a max-pool.
  3. Candidate score = saliency where all gates pass; `top_k` picks the best
     K = maxPointsPerFrame candidates.
  4. Admission: candidates are scattered into INACTIVE table slots
     (argsort(active) lists free slots first); overflow candidates and
     invalid ones are dropped via out-of-bounds scatter with mode='drop'.

This is the "dynamic point lifecycle under static shapes" hard part of
SURVEY.md section 7 — no reshapes, no host round-trips.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..image import patches as patches_mod
from ..image import saliency as saliency_mod
from .state import PointTable


class SelectionResult(NamedTuple):
    points: PointTable
    num_added: jax.Array   # ()
    num_candidates: jax.Array  # () candidates that passed all gates


def _tracked_occupancy(shape, uv: jax.Array, tracked: jax.Array, radius: int) -> jax.Array:
    """(H, W) bool map, True within `radius` of any tracked projection."""
    h, w = shape
    ix = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, h - 1)
    # Out-of-bounds index for untracked points -> dropped by the scatter.
    lin = jnp.where(tracked, iy * w + ix, h * w)
    occ = jnp.zeros((h * w,), bool).at[lin].set(True, mode="drop").reshape(h, w)
    if radius > 0:
        k = 2 * radius + 1
        occ = jax.lax.reduce_window(
            occ, False, jax.lax.bitwise_or,
            window_dimensions=(k, k), window_strides=(1, 1), padding="SAME",
        )
    return occ


def select_new_points(
    points: PointTable,
    cam,
    t_wc: jax.Array,        # (4, 4) pose of the new frame
    channels: jax.Array,    # (C, H, W) descriptor channels of the new frame
    saliency_map: jax.Array,  # (H, W)
    depth: jax.Array,       # (H, W) metric depth
    depth_ok: jax.Array,    # (H, W)
    tracked_uv: jax.Array,  # (N, 2) projections of tracked points
    tracked: jax.Array,     # (N,)
    frame_id: jax.Array,    # ()
    slot: jax.Array,        # () window slot of the new frame
    offsets: jax.Array,     # (P, 2)
    *,
    max_new: int,
    nms_radius: int,
    min_saliency: float,
    mask_radius: int,
    min_depth: float,
    max_depth: float,
    border: int,
    edge_radius: int = 0,
    edge_threshold: float = 0.0,
    normalize=True,                   # cfg.resolve_normalization(): store
                                      # mean-removed (reference behavior)
    age_id: jax.Array | None = None,  # ingest-ordinal clock for last_seen
                                      # (see tracking.track_into_frame)
) -> SelectionResult:
    h, w = saliency_map.shape
    n = points.capacity

    # Quantize saliency before any ranking: selection must be stable under
    # 1-ulp perturbations (different XLA fusions of the image-normalization
    # multiply reassociate the gradient arithmetic), otherwise NMS/top-k
    # tie-breaks — and hence the whole refinement — depend on the transport
    # dtype. 2^-14 granularity is far below any meaningful saliency gap.
    saliency_map = jnp.floor(saliency_map * 16384.0) * (1.0 / 16384.0)

    nms = saliency_mod.non_max_suppression(saliency_map, nms_radius, min_saliency)
    occupied = _tracked_occupancy((h, w), tracked_uv, tracked, mask_radius)

    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    in_border = (
        (xs >= border) & (xs < w - border) & (ys >= border) & (ys < h - border)
    )
    gate = (
        nms & ~occupied & depth_ok & in_border
        & (depth >= min_depth) & (depth <= max_depth)
    )
    if edge_threshold > 0 and edge_radius > 0:
        # Depth-edge gate (cfg.depthEdgeThreshold): a patch straddling a
        # depth discontinuity (occlusion boundary) violates the
        # single-point fronto-parallel model — its residuals drag poses
        # toward a compromise between fore- and background. Reject
        # candidates whose valid-depth spread under the patch support
        # exceeds a relative threshold.
        k = 2 * edge_radius + 1
        lo = jnp.where(depth_ok, depth, jnp.inf)
        hi = jnp.where(depth_ok, depth, -jnp.inf)
        dmin = -jax.lax.reduce_window(
            -lo, -jnp.inf, jax.lax.max,
            window_dimensions=(k, k), window_strides=(1, 1), padding="SAME")
        dmax = jax.lax.reduce_window(
            hi, -jnp.inf, jax.lax.max,
            window_dimensions=(k, k), window_strides=(1, 1), padding="SAME")
        gate = gate & ((dmax - dmin)
                       <= edge_threshold * jnp.maximum(depth, 1e-3))
    score = jnp.where(gate, saliency_map, -jnp.inf).reshape(-1)

    top_scores, top_idx = jax.lax.top_k(score, max_new)        # (K,)
    cand_ok = jnp.isfinite(top_scores)
    cy = (top_idx // w).astype(jnp.float32)
    cx = (top_idx % w).astype(jnp.float32)
    uv = jnp.stack([cx, cy], axis=-1)                           # (K, 2)

    z = depth.reshape(-1)[top_idx]
    x_cam = cam_mod.backproject(cam, uv, z)
    x_world = se3.transform_points(t_wc, x_cam)                 # (K, 3)

    patch, patch_ok = patches_mod.extract_patches(channels, uv, offsets)  # (K, C, P)
    patch = patches_mod.normalize_patches(patch, normalize)
    cand_ok = cand_ok & patch_ok

    # Admission: free slots first. argsort(active) is stable, so False
    # (free) slots come first in index order.
    free_slots = jnp.argsort(points.active)                     # (N,)
    num_free = n - points.num_active()
    k_idx = jnp.arange(max_new)
    write_ok = cand_ok & (k_idx < num_free)
    dest = jnp.where(write_ok, free_slots[jnp.minimum(k_idx, n - 1)], n)  # n = drop

    new_points = PointTable(
        x_world=points.x_world.at[dest].set(x_world, mode="drop"),
        patch=points.patch.at[dest].set(patch, mode="drop"),
        ref_frame=points.ref_frame.at[dest].set(frame_id, mode="drop"),
        last_seen=points.last_seen.at[dest].set(
            frame_id if age_id is None else age_id, mode="drop"),
        active=points.active.at[dest].set(True, mode="drop"),
        obs=points.obs.at[dest].set(
            jax.nn.one_hot(slot, points.obs.shape[1], dtype=jnp.float32)[None, :]
            .repeat(max_new, 0).astype(bool),
            mode="drop",
        ),
        inv_depth_seed=points.inv_depth_seed.at[dest].set(
            1.0 / jnp.maximum(z, 1e-6), mode="drop"),
    )
    return SelectionResult(
        points=new_points,
        num_added=jnp.sum(write_ok.astype(jnp.int32)),
        num_candidates=jnp.sum(cand_ok.astype(jnp.int32)),
    )
