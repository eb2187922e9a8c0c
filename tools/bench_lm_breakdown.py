"""Per-phase breakdown of one LM iteration: evaluation, normal-equation
assembly, Schur reduce + solve, and the full iteration.

Each phase runs K times with varied inputs inside one jit and is timed with
block_until_ready (K chained calls amortize dispatch). Micro-benchmarks
outside the solver's while_loop can be hoisted by XLA differently than
inside it; read the full-iteration line as the ground truth.

    python tools/bench_lm_breakdown.py [n_pts] [w] [K]
"""
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from photobundle_tpu.config import PBAConfig  # noqa: E402
from photobundle_tpu.core import lm, schur  # noqa: E402
from photobundle_tpu.core.residuals import evaluate_compressed  # noqa: E402
from __graft_entry__ import _make_problem  # noqa: E402

N = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
W = int(sys.argv[2]) if len(sys.argv) > 2 else 5
H, WI = 370, 1226
R = 2
K = int(sys.argv[3]) if len(sys.argv) > 3 else max(30, (1 << 22) // N)


def consume(tree):
    """Fold EVERY output leaf into the timing accumulator, so XLA cannot
    dead-code-eliminate part of the phase."""
    return sum(jnp.sum(a) for a in jax.tree.leaves(tree)
               if hasattr(a, "dtype") and
               jnp.issubdtype(a.dtype, jnp.floating))


def timeit(name, fn, *args):
    jfn = jax.jit(fn)
    jax.block_until_ready(jfn(*args))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(jfn(*args))
        times.append(time.perf_counter() - t0)
    t = min(times) / K
    print(f"{name:34s}: {t * 1e3:7.3f} ms/iter")
    return t


def main():
    dev = jax.devices()[0]
    backend = PBAConfig().resolve_backend()
    print(f"[{dev.platform} {dev.device_kind}; backend {backend}; "
          f"K={K} chained calls]")
    cam, offsets, args = _make_problem(N, W, H, WI, R, seed=1)
    t_wc, x_world, patch, channels, grads, obs, pv, frozen = args
    obs = obs & pv[:, None]

    def eval_k(x0):
        def body(i, acc):
            res = evaluate_compressed(cam, t_wc, x0 + 1e-4 * i, patch,
                                      channels, grads, obs, offsets, 0.05,
                                      backend=backend)
            return acc + consume(res)
        return jax.lax.fori_loop(0, K, body, 0.0)

    res0 = evaluate_compressed(cam, t_wc, x_world, patch, channels, grads,
                               obs, offsets, 0.05, backend=backend)
    timeit(f"evaluate_compressed ({backend})", eval_k, x_world)

    def normal_eq_k(gtr0):
        def body(i, acc):
            eq = schur.build_normal_equations_compressed(
                res0._replace(gtr=gtr0 + 1e-6 * i))
            return acc + consume(eq)
        return jax.lax.fori_loop(0, K, body, 0.0)

    eq0 = schur.build_normal_equations_compressed(res0)
    timeit("build_normal_equations", normal_eq_k, res0.gtr)

    def schur_k(bc0):
        def body(i, acc):
            sys_parts = schur.reduce_camera_system(
                eq0._replace(bc=bc0 + 1e-6 * i), jnp.asarray(1e-4), pv,
                frozen)
            return acc + consume(schur.solve_reduced(sys_parts))
        return jax.lax.fori_loop(0, K, body, 0.0)

    timeit("schur reduce+solve", schur_k, eq0.bc)

    def full_k(x0):
        def body(i, carry):
            _, _, s = lm.lm_solve(cam, t_wc, x0 + 1e-4 * i, patch, channels,
                                  grads, obs, pv, frozen, offsets,
                                  huber_delta=0.05, backend=backend,
                                  max_iterations=1, function_tolerance=0.0,
                                  parameter_tolerance=0.0)
            return carry + s.final_cost
        return jax.lax.fori_loop(0, K, body, 0.0)

    timeit("full LM iteration (1-iter solve)", full_k, x_world)
    print("(full includes init eval + 1 body = 2 evals + eq + schur + "
          "bookkeeping)")


if __name__ == "__main__":
    main()
