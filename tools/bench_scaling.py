"""Scaling study: LM iterations/s vs problem size (window x points).

The reference caps window=5 and a few thousand points because its reduced
camera system and per-point loops are CPU-serial (SURVEY.md 5.7); this
framework's design target is 50+ keyframes / 100k+ points. Prints one JSON
line per configuration.
"""
import json
import time

import jax
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from photobundle_tpu.config import PBAConfig
from photobundle_tpu.core import lm
from __graft_entry__ import _make_problem

H, WI = 370, 1226


def run(n_pts, w, m=8, k=None):
    # Methodology (ported from bench_lm_breakdown, round-5 verdict task 3):
    # K chained fixed-length solves inside ONE jit, each from a perturbed
    # start with a fresh lambda. A single long solve cannot work here —
    # with tolerances zeroed the synthetic problem converges in a handful
    # of steps, then every step is rejected and lambda doubles to overflow
    # at ~97 iters, so `max_iterations` stops governing the count and the
    # per-iteration slope is computed over the wrong denominator. m=8
    # fresh-start iterations per chain link never reaches either exit.
    cam, offsets, args = _make_problem(n_pts, w, H, WI, 2, seed=1)
    t_wc, x_world, *rest = args
    backend = PBAConfig().resolve_backend()

    def solve(x0):
        return lm.lm_solve(
            cam, t_wc, x0, *rest, offsets,
            huber_delta=0.05, gradient_mode="sampled", backend=backend,
            max_iterations=m, function_tolerance=0.0,
            parameter_tolerance=0.0)

    # Confirm the fixed-length assumption on a real solve before timing.
    n_probe = int(jax.jit(solve)(x_world)[2].iterations)
    if n_probe != m:
        raise RuntimeError(
            f"probe solve ran {n_probe} iterations, expected {m} — the "
            f"fixed-length chain assumption is broken at {n_pts}x{w}")

    if k is None:
        k = max(2, (1 << 25) // (n_pts * w * m))
    def chain(x0):
        def body(i, acc):
            _, _, s = solve(x0 + 1e-4 * i)
            return acc + s.final_cost
        return jax.lax.fori_loop(0, k, body, 0.0)

    fn = jax.jit(chain)
    jax.block_until_ready(fn(x_world))  # compile + warmup
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x_world))
        best = min(best, time.perf_counter() - t0)
    t_iter = best / (k * m)
    dev = jax.devices()[0]
    print(json.dumps({
        "device": dev.device_kind, "backend": backend,
        "points": n_pts, "window": w, "observations": n_pts * w,
        "ms_per_lm_iteration": round(t_iter * 1e3, 3),
        "lm_iterations_per_s": round(1.0 / t_iter, 1),
        "obs_per_s_millions": round(n_pts * w / t_iter / 1e6, 1),
    }))


if __name__ == "__main__":
    for n_pts, w in [(4096, 5), (16384, 5), (65536, 5),
                     (4096, 16), (16384, 16), (32768, 32)]:
        run(n_pts, w)
