"""The fused Triton sampler (ops/triton_stats) on the host: its kernel in
interpret mode against the plain-XLA reference, the wrapper's padding and
batching, and the choice of kernel (config 'auto' / 'triton' / 'xla')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photobundle_tpu.config import PBAConfig
from photobundle_tpu.core import residuals as res_mod
from photobundle_tpu.image import interp
from photobundle_tpu.ops import triton_stats

from test_sampling import _problem


def _kernel_inputs(rng, n, channels=1, radius=2, w=2, h=30, wi=44):
    ch = jnp.asarray(rng.uniform(size=(w, channels, h, wi)), jnp.float32)
    g = jnp.stack(interp.image_gradients(ch), axis=-1)
    uv = jnp.asarray(rng.uniform(-3, [wi + 3, h + 3], size=(w, n, 2)),
                     jnp.float32).transpose(0, 2, 1)
    patch = jnp.asarray(rng.normal(size=(n, channels,
                                         (2 * radius + 1) ** 2)), jnp.float32)
    return ch, g, uv, patch


@pytest.mark.parametrize("channels,radius,center", [
    (1, 2, True), (1, 2, False), (3, 1, True), (1, 3, False)])
def test_triton_kernel_interpret_matches_reference(rng, channels, radius,
                                                   center):
    ch, g, uv, patch = _kernel_inputs(rng, 70, channels, radius)
    out = triton_stats.patch_stats(ch, g, uv, patch, radius=radius,
                                   center=center, interpret=True)
    ref = triton_stats.reference_stats(ch, g, uv, patch, radius=radius,
                                       center=center)
    assert out.shape == (6, 2, 70)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * float(jnp.abs(ref).max()))


@pytest.mark.parametrize("n", [1, triton_stats.BLOCK_N - 1,
                               triton_stats.BLOCK_N + 1])
def test_triton_wrapper_pads_points(rng, n):
    """N is padded to the block size and the padding sliced off: every
    real observation's sums are those of a lone call on that observation."""
    ch, g, uv, patch = _kernel_inputs(rng, n)
    out = np.asarray(triton_stats.patch_stats(ch, g, uv, patch, radius=2,
                                              center=True, interpret=True))
    assert out.shape == (6, 2, n)
    last = np.asarray(triton_stats.patch_stats(
        ch, g, uv[..., -1:], patch[-1:], radius=2, center=True,
        interpret=True))
    np.testing.assert_array_equal(out[..., -1:], last)


def test_triton_kernel_batches_over_windows(rng):
    """Under vmap (the batched engine) the kernel runs once per window."""
    ins = [_kernel_inputs(rng, 20) for _ in range(2)]
    stacked = [jnp.stack(parts) for parts in zip(*ins)]
    out = jax.vmap(lambda c, g, u, p: triton_stats.patch_stats(
        c, g, u, p, radius=2, center=True, interpret=True))(*stacked)
    for b, (c, g, u, p) in enumerate(ins):
        np.testing.assert_allclose(
            np.asarray(out[b]),
            np.asarray(triton_stats.reference_stats(c, g, u, p, radius=2,
                                                    center=True)),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("overrides,supported", [
    ({}, True),
    ({"patchNormalization": "off"}, True),
    ({"patchNormalization": "affine"}, False),
    ({"interpolation": "bicubic"}, False),
    ({"gradientMode": "exact"}, False),
    ({"patchWarp": "scale"}, False),
    ({"patchWarp": "affine"}, False),
    ({"descriptor": "BitPlanes"}, True),
])
def test_backend_choice(overrides, supported):
    """'auto' picks the fused sampler only on a GPU and only for the modes
    it implements; on this host it is always XLA, and an explicit 'triton'
    is refused rather than interpreted."""
    cfg = PBAConfig(**overrides)
    assert cfg.triton_supported() == supported
    assert cfg.resolve_backend() == "xla"            # no GPU on this host
    assert PBAConfig(solverBackend="xla", **overrides).resolve_backend() \
        == "xla"
    if supported:
        with pytest.raises(ValueError, match="GPU"):
            PBAConfig(solverBackend="triton", **overrides).resolve_backend()
    else:
        with pytest.raises(ValueError):
            PBAConfig(solverBackend="triton", **overrides).validate()


def test_triton_refuses_unsupported_mode_and_cpu(rng):
    cam, t, x, patch, ch, g, obs, off = _problem(rng, 2, "mean")
    with pytest.raises(ValueError, match="triton"):
        res_mod.evaluate_compressed(cam, t, x, patch, ch, g, obs, off,
                                    huber_delta=0.05, gradient_mode="bicubic",
                                    backend="triton", interpret=True)
    with pytest.raises(ValueError, match="GPU"):
        res_mod.evaluate_compressed(cam, t, x, patch, ch, g, obs, off,
                                    huber_delta=0.05, backend="triton")
