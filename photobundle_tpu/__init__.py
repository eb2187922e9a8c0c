"""photobundle-tpu: a photometric bundle adjustment engine in JAX.

Built from scratch in JAX/XLA — not a port — reproducing the capability
surface of the C++/Ceres reference `halismai/photobundle` (ACCV 2016):
sliding-window photometric refinement of a VO trajectory on KITTI-style
sequences. See SURVEY.md for the structural analysis of the reference and
the design rationale of this package.

Layer map (mirrors SURVEY.md section 1):
    cli            — app driver (reference L6)
    config         — ConfigFile / PBAConfig (L5)
    io             — KITTI dataset + trajectory I/O (L4)
    image          — pyramids, interpolation, descriptors, saliency (L3)
    core           — the BA engine: state, residuals, Schur, LM (L2 + L1)
    parallel       — mesh / shard_map multi-device solver
    utils          — timing, logging, results
"""

import os as _os

import jax as _jax

# Every matrix product in full f32. On a GPU the default lets f32 products
# run in TF32 (~10 mantissa bits); at KITTI world coordinates (|t| ~
# 30-500 m) that rounds pose products (T @ exp(xi), se3_inverse, the
# world->camera transform) by centimetres and moves projected pixels —
# frozen poses then "move" between solves. The few true contractions here
# (Hcc, the reduced Schur system) are tiny, so the cost is small.
# Regression: test_lm.py::test_frozen_poses_bitwise_invariant_at_world_scale.
_jax.config.update("jax_default_matmul_precision", "highest")


def compile_cache_dir(environ=None):
    """The persistent compilation cache this package sets, or None.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and the
    package sets nothing. Otherwise the cache lives at `<checkout>/.jax_cache`
    — a fixed path, because the path is part of the cache key."""
    environ = _os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    checkout = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(checkout, ".jax_cache")


_cache = compile_cache_dir()
if _cache is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache)
del _cache

from .config import ConfigFile, PBAConfig
from .geometry.camera import Camera

__version__ = "0.1.0"

__all__ = ["ConfigFile", "PBAConfig", "Camera", "compile_cache_dir",
           "__version__"]
