"""Multi-channel descriptor frames: Intensity / IntensityAndGradient / BitPlanes.

JAX replacement for `DescriptorFrame` (reference: pb:src/photobundle.cc
DescriptorFrame::Create; BitPlanes channels from Alismail's BitPlanes tracker).
A descriptor frame is a plain pytree:

    channels:  (C, H, W) float   — what residuals sample (C = 1 / 3 / 8)
    grads:     (C, H, W, 2)      — precomputed central-diff gradients of each
                                   channel, for gradientMode='sampled'
    saliency:  (H, W)            — selection map

Built per incoming frame in one jitted call (`build_descriptor_frame`), at
each pyramid level.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import (
    DESCRIPTOR_BITPLANES,
    DESCRIPTOR_INTENSITY,
    DESCRIPTOR_INTENSITY_AND_GRADIENT,
)
from . import interp, pyramid, saliency


class DescriptorLevel(NamedTuple):
    channels: jax.Array   # (C, H, W)
    grads: jax.Array      # (C, H, W, 2) — [..., 0] = d/dx, [..., 1] = d/dy
    saliency: jax.Array   # (H, W)


def _intensity_channels(img: jax.Array) -> jax.Array:
    return img[None]


def _intensity_gradient_channels(img: jax.Array) -> jax.Array:
    gx, gy = interp.image_gradients(img)
    return jnp.stack([img, gx, gy], axis=0)


# The 8 census neighbors in raster order (dy, dx), excluding the center —
# same 3x3 ring the BitPlanes descriptor uses.
_CENSUS_OFFSETS = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1),           (0, 1),
    (1, -1), (1, 0), (1, 1),
)


def _shift2d(img: jax.Array, dy: int, dx: int) -> jax.Array:
    """Shift with edge replication so comparisons stay in-range."""
    H, W = img.shape
    ys = jnp.clip(jnp.arange(H) + dy, 0, H - 1)
    xs = jnp.clip(jnp.arange(W) + dx, 0, W - 1)
    return img[ys][:, xs]


def _bitplanes_channels(img: jax.Array, sigma_pre: float, sigma_post: float) -> jax.Array:
    """8 smoothed LBP sign channels: sign(I(x) - I(x + d)) in {-1, +1},
    Gaussian-smoothed — a locally contrast-invariant descriptor."""
    base = pyramid.gaussian_blur_sigma(img, sigma_pre)
    planes = []
    for dy, dx in _CENSUS_OFFSETS:
        cmp = jnp.where(base > _shift2d(base, dy, dx), 1.0, -1.0).astype(img.dtype)
        planes.append(cmp)
    ch = jnp.stack(planes, axis=0)
    return pyramid.gaussian_blur_sigma(ch, sigma_post)


def make_channels(img: jax.Array, descriptor: str,
                  sigma_pre: float = 0.5, sigma_post: float = 0.75) -> jax.Array:
    """img: (H, W) -> (C, H, W) descriptor channels."""
    if descriptor == DESCRIPTOR_INTENSITY:
        return _intensity_channels(img)
    if descriptor == DESCRIPTOR_INTENSITY_AND_GRADIENT:
        return _intensity_gradient_channels(img)
    if descriptor == DESCRIPTOR_BITPLANES:
        return _bitplanes_channels(img, sigma_pre, sigma_post)
    raise ValueError(f"unknown descriptor '{descriptor}'")


def build_descriptor_level(img: jax.Array, descriptor: str,
                           sigma_pre: float = 0.5, sigma_post: float = 0.75,
                           gradient_sigma: float = 0.0) -> DescriptorLevel:
    """One pyramid level -> DescriptorLevel. img: (H, W).

    gradient_sigma > 0 computes the gradient PLANES from a Gaussian-blurred
    copy of the channels (gradient-of-Gaussian) while the value channels
    stay sharp. Round-3 golden probes isolated the Jacobian direction
    field's conditioning as the decisive sampling-mode variable (BASELINE
    "Interpolation-order probe"): central-difference planes already carry a
    mild implicit low-pass; this knob makes the low-pass explicit and
    tunable. 0 = reference-exact central differences."""
    ch = make_channels(img, descriptor, sigma_pre, sigma_post)
    gsrc = (pyramid.gaussian_blur_sigma(ch, gradient_sigma)
            if gradient_sigma > 0 else ch)
    gx, gy = interp.image_gradients(gsrc)
    grads = jnp.stack([gx, gy], axis=-1)
    # Selection saliency always comes from the raw intensity image (texture),
    # independent of the residual descriptor — matches the reference, whose
    # saliency map is gradient magnitude of the frame.
    sal = saliency.gradient_magnitude(img)
    return DescriptorLevel(channels=ch, grads=grads, saliency=sal)


def build_descriptor_pyramid(img: jax.Array, num_levels: int, descriptor: str,
                             sigma_pre: float = 0.5, sigma_post: float = 0.75,
                             gradient_sigma: float = 0.0
                             ) -> Tuple[DescriptorLevel, ...]:
    """Full-resolution image -> tuple of DescriptorLevel, coarse levels last."""
    levels = pyramid.build_pyramid(img, num_levels)
    return tuple(build_descriptor_level(l, descriptor, sigma_pre, sigma_post,
                                        gradient_sigma) for l in levels)
