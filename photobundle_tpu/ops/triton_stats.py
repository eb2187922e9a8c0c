"""Fused bilinear patch sampler + Gauss-Newton statistics (Pallas, Triton).

One program takes a block of observations of one window frame, gathers the
four bilinear taps of every patch pixel from the frame's flattened
(value, d/dx, d/dy) planes, subtracts the descriptor, centres for 'mean'
normalization and reduces in registers to the six per-observation sums

    g00 = sum gx*gx   g01 = sum gx*gy   g11 = sum gy*gy
    gxr = sum gx*r    gyr = sum gy*r    rr  = sum r*r

written point-minor as (6, W, N). The (W, D, N) residual and gradient
planes of the XLA path, and its per-point (D, 2) x (D, 2) batched
products, never reach device memory. Validity is not applied here: the
caller masks every statistic with its own validity, as the XLA path does
(clamped taps keep the values finite).

The patch axis P = (2R+1)^2 is padded to a power of two (25 -> 32) and
masked; the point axis is padded to the block size. `reference_stats` is
the same computation in plain XLA — the kernel's test oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_N = 32        # observations per program (measured best of 16/32/64/128
NUM_WARPS = 4       # on an H100 at 4096x5 and 65536x5, 5x5 patches)


def _stats_kernel(uv_ref, desc_ref, planes_ref, out_ref, *, n_ch: int,
                  radius: int, img_h: int, img_w: int, center: bool):
    w = pl.program_id(0)
    side = 2 * radius + 1
    p = side * side
    pp = pl.next_power_of_2(p)
    hw = img_h * img_w
    k = jnp.arange(pp, dtype=jnp.int32)
    m = (k < p).astype(jnp.float32)[None, :]
    ox = (k % side - radius).astype(jnp.float32)
    oy = (k // side - radius).astype(jnp.float32)

    # Same clamp / floor / weights as image/interp.bilinear.
    x = jnp.clip(uv_ref[0, :][:, None] + ox[None, :], 0.0, img_w - 1.000001)
    y = jnp.clip(uv_ref[1, :][:, None] + oy[None, :], 0.0, img_h - 1.000001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, img_w - 1)
    y1 = jnp.minimum(y0 + 1, img_h - 1)
    fx = x - x0.astype(jnp.float32)
    fy = y - y0.astype(jnp.float32)
    taps = ((y0 * img_w + x0, (1.0 - fx) * (1.0 - fy)),
            (y0 * img_w + x1, fx * (1.0 - fy)),
            (y1 * img_w + x0, (1.0 - fx) * fy),
            (y1 * img_w + x1, fx * fy))

    sums = [0.0] * 6
    for c in range(n_ch):
        def sample(q, c=c):
            base = ((w * n_ch + c) * 3 + q) * hw
            return sum(planes_ref[base + lin] * wt for lin, wt in taps) * m

        s, gx, gy = sample(0), sample(1), sample(2)
        if center:
            s = (s - jnp.sum(s, axis=1, keepdims=True) * (1.0 / p)) * m
            gx = (gx - jnp.sum(gx, axis=1, keepdims=True) * (1.0 / p)) * m
            gy = (gy - jnp.sum(gy, axis=1, keepdims=True) * (1.0 / p)) * m
        r = s - desc_ref[c]
        for j, prod in enumerate((gx * gx, gx * gy, gy * gy,
                                  gx * r, gy * r, r * r)):
            sums[j] = sums[j] + jnp.sum(prod, axis=1)
    for j in range(6):
        out_ref[j, :] = sums[j]


def _patch_stats(channels, grads, uv, patch, radius, center, interpret):
    w, c, h, wi = channels.shape
    n = uv.shape[-1]
    p = patch.shape[-1]
    pp = pl.next_power_of_2(p)
    n_pad = -(-n // BLOCK_N) * BLOCK_N
    planes = jnp.stack([channels, grads[..., 0], grads[..., 1]], axis=2)
    planes = planes.astype(jnp.float32).reshape(-1)       # [w][c][q][h*wi]
    uv = jnp.pad(uv.astype(jnp.float32), ((0, 0), (0, 0), (0, n_pad - n)))
    desc = jnp.transpose(patch.astype(jnp.float32), (1, 0, 2))   # (C, N, P)
    desc = jnp.pad(desc, ((0, 0), (0, n_pad - n), (0, pp - p)))
    kernel = functools.partial(_stats_kernel, n_ch=c, radius=radius,
                               img_h=h, img_w=wi, center=center)
    out = pl.pallas_call(
        kernel,
        grid=(w, n_pad // BLOCK_N),
        in_specs=[
            pl.BlockSpec((None, 2, BLOCK_N), lambda f, i: (f, 0, i)),
            pl.BlockSpec((c, BLOCK_N, pp), lambda f, i: (0, i, 0)),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        # 8 rows (a power of two) of which the kernel writes the first 6.
        out_specs=pl.BlockSpec((8, None, BLOCK_N), lambda f, i: (0, f, i)),
        out_shape=jax.ShapeDtypeStruct((8, w, n_pad), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="pb_patch_stats",
    )(uv, desc, planes)
    return out[:6, :, :n]


def patch_stats(channels, grads, uv, patch, *, radius: int, center: bool,
                interpret: bool = False):
    """Six per-observation Gauss-Newton sums for every (frame, point).

    channels (W, C, H, Wi), grads (W, C, H, Wi, 2), uv (W, 2, N) patch
    centres, patch (N, C, P) descriptors with P = (2*radius+1)^2. Returns
    (6, W, N) float32 in the order g00, g01, g11, gxr, gyr, rr
    (un-whitened, unmasked). Compiled for the GPU only; `interpret=True`
    runs the Pallas interpreter instead (tests on hosts without a GPU).
    Under vmap (batched windows) the batch runs as a loop of kernel calls.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError("the Triton patch sampler needs a GPU "
                         f"(default backend is '{jax.default_backend()}')")

    @jax.custom_batching.custom_vmap
    def call(channels, grads, uv, patch):
        return _patch_stats(channels, grads, uv, patch, radius, center,
                            interpret)

    @call.def_vmap
    def _batched(axis_size, in_batched, channels, grads, uv, patch):
        args = [a if b else jnp.broadcast_to(a, (axis_size,) + a.shape)
                for a, b in zip((channels, grads, uv, patch), in_batched)]
        out = jax.lax.map(lambda xs: call(*xs), tuple(args))
        return out, True

    return call(channels, grads, uv, patch)


def reference_stats(channels, grads, uv, patch, *, radius: int, center: bool):
    """Plain-XLA twin of `patch_stats` (same contract and arithmetic up to
    summation order)."""
    from ..image import interp, patches as patches_mod

    c = channels.shape[1]
    offsets = patches_mod.patch_offsets(radius)
    planes = jnp.concatenate([channels, grads[..., 0], grads[..., 1]],
                             axis=1)                          # (W, 3C, H, Wi)
    pts = jnp.swapaxes(uv, 1, 2)[:, :, None, :] + offsets     # (W, N, P, 2)
    vals, _ = jax.vmap(interp.bilinear)(planes, pts)          # (W, 3C, N, P)
    s, gx, gy = vals[:, :c], vals[:, c:2 * c], vals[:, 2 * c:]
    if center:
        s = s - jnp.mean(s, axis=-1, keepdims=True)
        gx = gx - jnp.mean(gx, axis=-1, keepdims=True)
        gy = gy - jnp.mean(gy, axis=-1, keepdims=True)
    r = s - jnp.transpose(patch, (1, 0, 2))[None]             # (W, C, N, P)
    return jnp.stack([
        jnp.sum(gx * gx, axis=(1, 3)), jnp.sum(gx * gy, axis=(1, 3)),
        jnp.sum(gy * gy, axis=(1, 3)), jnp.sum(gx * r, axis=(1, 3)),
        jnp.sum(gy * r, axis=(1, 3)), jnp.sum(r * r, axis=(1, 3))])
