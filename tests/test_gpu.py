"""Tests that need the card (marker `gpu`): the fused Triton sampler as
compiled for the GPU. They skip on hosts without a GPU; `python
chip_smoke.py` runs them on the card (JAX_PLATFORMS=cuda,cpu)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photobundle_tpu.config import PBAConfig
from photobundle_tpu.core import lm, residuals
from photobundle_tpu.image import interp
from photobundle_tpu.ops import triton_stats

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("channels,radius,center", [
    (1, 2, True), (1, 2, False), (3, 1, True), (1, 4, True)])
def test_triton_stats_match_reference_on_gpu(gpu_device, channels, radius,
                                             center):
    rng = np.random.default_rng(0)
    w, h, wi, n = 3, 64, 96, 333
    ch = jnp.asarray(rng.uniform(size=(w, channels, h, wi)), jnp.float32)
    gx, gy = interp.image_gradients(ch)
    g = jnp.stack([gx, gy], axis=-1)
    uv = jnp.asarray(rng.uniform(-4, [wi + 4, h + 4], size=(w, n, 2)),
                     jnp.float32).transpose(0, 2, 1)
    patch = jnp.asarray(rng.normal(size=(n, channels, (2 * radius + 1) ** 2)),
                        jnp.float32)
    out = triton_stats.patch_stats(ch, g, uv, patch, radius=radius,
                                   center=center)
    ref = triton_stats.reference_stats(ch, g, uv, patch, radius=radius,
                                       center=center)
    assert out.devices() == {gpu_device}
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5 * float(jnp.abs(ref).max()))


def test_triton_normal_equations_match_xla_on_gpu(gpu_device):
    """Both paths build the same cost and normal equations at one iterate
    (production model: depth prior), and one LM step lands on the same
    cost. Hcc and the cost differ only by summation order; the Schur
    complement S and its right-hand side subtract large per-point terms,
    which amplifies those last bits, hence their wider bound."""
    from __graft_entry__ import _make_problem
    from photobundle_tpu.core import schur

    cam, off, args = _make_problem(4096, 5, 184, 612, 2, seed=3)
    t_wc, x, patch, ch, g, obs, pv, frz = args
    prior = (jnp.zeros((x.shape[0],), jnp.int32), 1.0 / x[:, 2],
             0.1 * float(cam.fx))

    def system(backend):
        res = residuals.evaluate_compressed(
            cam, t_wc, x, patch, ch, g, obs, off, 0.05, depth_prior=prior,
            backend=backend)
        eq = schur.build_normal_equations_compressed(res)
        sysm = schur.reduce_camera_system(eq, jnp.float32(1e-4), pv, frz)
        return res.cost, eq.hcc, sysm.s, sysm.rhs

    ref = jax.jit(lambda: system("xla"))()
    out = jax.jit(lambda: system("triton"))()
    for name, a, b, tol in zip(("cost", "hcc", "s", "rhs"), out, ref,
                               (1e-5, 1e-5, 1e-4, 1e-4)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), name
    step = {b: jax.jit(lambda bb=b: lm.lm_solve(
        cam, t_wc, x, patch, ch, g, obs, pv, frz, off, huber_delta=0.05,
        depth_prior=prior, backend=bb, max_iterations=1,
        function_tolerance=0.0, parameter_tolerance=0.0))()
        for b in ("xla", "triton")}
    c_x = float(step["xla"][2].final_cost)
    c_t = float(step["triton"][2].final_cost)
    assert abs(c_t - c_x) <= 1e-3 * abs(c_x)


def test_triton_batched_windows_on_gpu(gpu_device):
    """vmap over windows (core/batched.py) runs the kernel once per window."""
    rng = np.random.default_rng(1)
    ch = jnp.asarray(rng.uniform(size=(2, 3, 1, 40, 64)), jnp.float32)
    g = jnp.stack(interp.image_gradients(ch), axis=-1)
    uv = jnp.asarray(rng.uniform(0, [64, 40], size=(2, 3, 50, 2)),
                     jnp.float32).swapaxes(2, 3)
    patch = jnp.asarray(rng.normal(size=(2, 50, 1, 25)), jnp.float32)
    f = jax.vmap(lambda c, gg, u, p: triton_stats.patch_stats(
        c, gg, u, p, radius=2, center=True))
    ref = jnp.stack([triton_stats.reference_stats(
        ch[i], g[i], uv[i], patch[i], radius=2, center=True)
        for i in range(2)])
    np.testing.assert_allclose(np.asarray(f(ch, g, uv, patch)),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_auto_backend_is_triton_on_gpu(gpu_device):
    assert PBAConfig().resolve_backend() == "triton"
    assert PBAConfig(interpolation="bicubic").resolve_backend() == "xla"
    assert PBAConfig(patchWarp="affine").resolve_backend() == "xla"
    assert residuals.triton_supports("sampled", "mean", None)
