"""Benchmark: BA iterations/s on a KITTI-scale sliding-window problem.

Prints the device (platform, kind, count) and the card's name and power
limit, then ONE JSON line:
    {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}

Problem (BASELINE.json config-2 scale): 4096 points x 5-frame window x
5x5 patches at full KITTI resolution (370 x 1226), LM forced to run a fixed
iteration count (tolerances zeroed), chained K times inside one jit. The
baseline divisor is the SAME solver on the host CPU — the reference
publishes no numbers ("published": {}). Exits non-zero without an
accelerator, and whenever either measurement fails.

    python bench.py
"""

import json
import statistics
import subprocess
import sys
import time

N_PTS = 4096
W = 5
H, WI = 370, 1226
PATCH_RADIUS = 2
M_ITERS = 8     # iterations per chain link (fixed-length, fresh lambda)
K_ACCEL = 32    # chain links per timed call on the accelerator
K_CPU = 2       # CPU pass is slow; shorter chain, same link length
METRIC = "BA_iterations_per_s_kitti_scale_window"
UNIT = "LM iterations/s (4096 pts x 5 frames x 5x5 patches, 370x1226)"


def build(device):
    import jax

    from photobundle_tpu.config import PBAConfig
    from photobundle_tpu.core import lm
    from __graft_entry__ import _make_problem

    cam, offsets, args = _make_problem(N_PTS, W, H, WI, PATCH_RADIUS, seed=1)
    # The backend the engine picks on this device (config 'auto').
    backend = PBAConfig().resolve_backend() if device.platform != "cpu" else "xla"

    def solve(x0, rest):
        return lm.lm_solve(
            cam, rest[0], x0, *rest[1:5], rest[5], rest[6], offsets,
            huber_delta=0.05, gradient_mode="sampled", backend=backend,
            max_iterations=M_ITERS,
            function_tolerance=0.0, parameter_tolerance=0.0,
        )

    return solve, jax.device_put(args, device), backend


def time_solve(device, k, repeats=5):
    """Median of `repeats` timed calls, each K chained fixed-length
    8-iteration solves inside ONE jit (fresh lambda and a perturbed start
    per link), ended by block_until_ready. Returns (it/s, backend)."""
    import jax

    solve, args, backend = build(device)
    t_wc, x_world, *rest_tail = args
    rest = (t_wc, *rest_tail)

    # With tolerances zeroed only the lambda-overflow exit could end a
    # link early; the iteration count of the chain assumes it never does.
    n_probe = int(jax.jit(solve)(x_world, rest)[2].iterations)
    if n_probe != M_ITERS:
        raise RuntimeError(f"probe ran {n_probe} != {M_ITERS} iterations")

    def chain(x0):
        def body(i, acc):
            _, _, s = solve(x0 + 1e-4 * i, rest)
            return acc + s.final_cost
        return jax.lax.fori_loop(0, k, body, 0.0)

    fn = jax.jit(chain)
    jax.block_until_ready(fn(x_world))   # compile + warm-up
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x_world))
        times.append(time.perf_counter() - t0)
    return k * M_ITERS / statistics.median(times), backend


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    import photobundle_tpu  # noqa: F401  (precision + compile cache)
    import jax

    accel = jax.devices()[0]
    if accel.platform == "cpu":
        print("bench.py needs an accelerator; JAX found only the CPU",
              file=sys.stderr)
        return 1
    print(f"device: platform={accel.platform} kind={accel.device_kind} "
          f"count={len(jax.devices())}", flush=True)
    print(f"card: {card_line()}", flush=True)
    accel_ips, backend = time_solve(accel, K_ACCEL, repeats=5)
    cpu_ips, _ = time_solve(jax.devices("cpu")[0], K_CPU, repeats=3)
    print(json.dumps({
        "metric": METRIC,
        "value": round(accel_ips, 3),
        "unit": UNIT,
        "vs_baseline": round(accel_ips / cpu_ips, 3),
        "backend": backend,
        "device": {"platform": accel.platform, "kind": accel.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
