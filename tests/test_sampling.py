"""The compressed sampling paths against the dense oracle: every sampling
mode x normalization x patch radius on the XLA path, multichannel
descriptors, the fused Triton path (kernel interpreted on the host), and
padding/validity isolation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photobundle_tpu.core import residuals as res_mod
from photobundle_tpu.core import schur
from photobundle_tpu.image import descriptor, interp
from photobundle_tpu.image import patches as pm

from test_residuals import setup_problem

# name -> (gradient_mode, patch_warp)
MODES = {"sampled": ("sampled", None), "exact": ("exact", None),
         "bicubic": ("bicubic", None), "scale": ("sampled", "scale"),
         "affine_warp": ("sampled", "affine")}


def _problem(rng, radius, norm, channels="Intensity", n_pts=6):
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(
        rng, n_pts=n_pts, w=2, radius=radius, shape=(72, 108))
    if channels != "Intensity":
        ch = jax.vmap(lambda im: descriptor.make_channels(im, channels))(
            ch[:, 0])
        g = jnp.stack(interp.image_gradients(ch), axis=-1)
    raw, _ = pm.extract_patches(ch[0], _ref_uv(cam, x), off)
    patch = pm.normalize_patches(raw, norm)
    return cam, t_wc, x + 0.01, patch, ch, g, obs, off


def _ref_uv(cam, x):
    from photobundle_tpu.geometry import camera as cam_mod
    uv, _ = cam_mod.project(cam, x)     # frame 0 is the identity pose
    return uv


def _oracle_check(cam, t, x, patch, ch, g, obs, off, gmode, warp, norm,
                  backend="xla", **extra):
    pw = None
    if warp is not None:
        z_ref, r_wc_ref = res_mod.patch_warp_ref_geometry(
            t, x, jnp.zeros((x.shape[0],), jnp.int32))
        pw = (warp, z_ref, r_wc_ref)
    kw = dict(huber_delta=0.05, gradient_mode=gmode, normalize=norm,
              patch_warp=pw)
    full = res_mod.evaluate(cam, t, x, patch, ch, g, obs, off, **kw)
    comp = res_mod.evaluate_compressed(cam, t, x, patch, ch, g, obs, off,
                                       backend=backend, **extra, **kw)
    assert int(comp.n_residuals) == int(full.n_residuals) > 0
    np.testing.assert_allclose(float(comp.cost), float(full.cost), rtol=1e-5)
    eq_a = schur.to_point_major(schur.build_normal_equations_compressed(comp))
    eq_b = schur.build_normal_equations(full)
    for name in ("hpp", "hpc", "hcc", "bp", "bc"):
        b = np.asarray(getattr(eq_b, name))
        np.testing.assert_allclose(np.asarray(getattr(eq_a, name)), b,
                                   atol=2e-4 * np.abs(b).max() + 1e-7,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("norm", ["mean", "off", "affine"])
@pytest.mark.parametrize("mode", list(MODES))
def test_xla_compressed_matches_dense_oracle(rng, mode, norm, radius):
    gmode, warp = MODES[mode]
    prob = _problem(rng, radius, norm)
    _oracle_check(*prob, gmode, warp, norm)


@pytest.mark.parametrize("channels", ["IntensityAndGradient", "BitPlanes"])
def test_xla_compressed_matches_dense_oracle_multichannel(rng, channels):
    prob = _problem(rng, 2, "mean", channels=channels)
    assert prob[4].shape[1] > 1
    _oracle_check(*prob, "sampled", None, "mean")


@pytest.mark.parametrize("norm", ["mean", "off"])
@pytest.mark.parametrize("channels", ["Intensity", "IntensityAndGradient"])
def test_triton_interpret_matches_dense_oracle(rng, norm, channels):
    """The fused-sampler path (kernel interpreted on the host) reproduces
    the dense oracle's cost and normal equations."""
    prob = _problem(rng, 2, norm, channels=channels)
    _oracle_check(*prob, "sampled", None, norm, backend="triton",
                  interpret=True)


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_masked_observations_add_exact_zeros(rng, backend):
    cam, t, x, patch, ch, g, obs, off = _problem(rng, 2, "mean")
    extra = {"interpret": True} if backend == "triton" else {}
    kw = dict(huber_delta=0.05, backend=backend, **extra)
    full = res_mod.evaluate_compressed(cam, t, x, patch, ch, g, obs, off,
                                       **kw)
    obs_m = obs.at[0, :].set(False).at[:, 1].set(False)
    part = res_mod.evaluate_compressed(cam, t, x, patch, ch, g, obs_m, off,
                                       **kw)
    for name in ("gtg", "gtr", "jp", "rp"):
        v = np.asarray(getattr(part, name))
        assert np.all(v[..., 0] == 0.0), name        # point 0, all frames
        assert np.all(v[1] == 0.0), name              # frame 1, all points
    assert not np.asarray(part.valid)[0].any()
    dropped = np.asarray(full.valid) & ~np.asarray(obs_m)
    assert int(part.n_residuals) == int(full.n_residuals) - dropped.sum()


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_out_of_bounds_observations_add_exact_zeros(rng, backend):
    """A point whose patch leaves the image (here: pushed far off to the
    side) is invalid in that frame and contributes nothing."""
    cam, t, x, patch, ch, g, obs, off = _problem(rng, 2, "mean")
    x = x.at[0, 0].set(x[0, 0] + 50.0)
    extra = {"interpret": True} if backend == "triton" else {}
    res = res_mod.evaluate_compressed(cam, t, x, patch, ch, g, obs, off,
                                      huber_delta=0.05, backend=backend,
                                      **extra)
    assert not np.asarray(res.valid)[0].any()
    for name in ("gtg", "gtr", "jp", "rp"):
        assert np.all(np.asarray(getattr(res, name))[..., 0] == 0.0), name
    assert np.isfinite(float(res.cost))


def test_patch_warp_scale_right_edge(rng):
    """The warped grid's validity is decided per tap: in its reference
    frame (scale 1) a radius-1 patch a quarter pixel inside the right image
    edge is valid, a quarter pixel beyond it is not, and the compressed
    path agrees with the oracle on every observation either way."""
    cam, t, x, patch, ch, g, obs, off = _problem(rng, 1, "mean", n_pts=2)
    wi = ch.shape[-1]
    from photobundle_tpu.geometry import camera as cam_mod
    z = x[0, 2]
    for u0, want in ((wi - 2.25, True), (wi - 1.75, False)):
        x0 = cam_mod.backproject(cam, jnp.asarray([[u0, 30.0]]),
                                 jnp.asarray([z]))
        xx = x.at[0].set(x0[0])
        z_ref, r_wc_ref = res_mod.patch_warp_ref_geometry(
            t, xx, jnp.zeros((2,), jnp.int32))
        kw = dict(huber_delta=0.05, patch_warp=("scale", z_ref, r_wc_ref))
        comp = res_mod.evaluate_compressed(cam, t, xx, patch, ch, g, obs,
                                           off, **kw)
        full = res_mod.evaluate(cam, t, xx, patch, ch, g, obs, off, **kw)
        assert bool(np.asarray(comp.valid)[0, 0]) == want
        np.testing.assert_array_equal(np.asarray(comp.valid),
                                      np.asarray(full.valid))
