"""Multi-host scaling harness (round-3 VERDICT item 7): times the
points-sharded and the ('frames','points')-sharded LM solves per process
count via jax.distributed.

Local wiring validation (CPU processes standing in for hosts; the NUMBERS
are meaningless on a 1-core box — this validates the harness itself):

    python tools/bench_multihost.py --procs 2 --devices-per-proc 2

Multi-host invocation (the real measurement): run ONE copy per process,
no --local flag —

    # on every host i of N:
    python tools/bench_multihost.py --role worker --pid $i --procs $N \
        --coordinator $HOST0:9876 --layout points --points 65536

Rank 0 prints one JSON line per layout:
    {"layout": ..., "procs": N, "devices": D, "points": ...,
     "window": ..., "ms_per_lm_iter": ..., "m_obs_per_s": ...}

Methodology: the solve is invoked R times on varied inputs (pose jitter
re-seeded per rep) after one warmup, each ended by block_until_ready;
per-iteration cost is the marginal slope between a max_iterations=I_LO
and an I_HI run, which cancels dispatch and transfer overhead.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

I_LO, I_HI, REPS = 4, 16, 3


def worker(args) -> None:
    if args.local:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices_per_proc}")
    import jax

    if args.local:
        jax.config.update("jax_platforms", "cpu")
    if args.procs > 1:
        from photobundle_tpu.parallel.mesh import initialize_distributed

        initialize_distributed(args.coordinator, args.procs, args.pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from __graft_entry__ import _make_problem
    from photobundle_tpu.parallel import make_mesh
    from photobundle_tpu.parallel.sharded import (
        ShardedLMSolver, make_frames_mesh, make_frames_sharded_solver)
    from photobundle_tpu.geometry import se3

    n_dev = len(jax.devices())
    from photobundle_tpu.config import PBAConfig

    backend = PBAConfig().resolve_backend()
    w = args.window
    cam, offsets, prob = _make_problem(args.points, w, args.height,
                                       args.width, patch_radius=2)
    (t_wc, x_world, patch, channels, grads, obs, pv, frozen) = prob
    n_obs = args.points * w

    for layout in args.layout.split(","):
        if layout == "points":
            mesh = make_mesh(points=n_dev)
            solver_of = lambda iters: ShardedLMSolver(
                mesh, cam, offsets, n_points=args.points, huber_delta=0.05,
                backend=backend, max_iterations=iters,
                function_tolerance=0.0, parameter_tolerance=0.0)
            specs = (P(), P("points"), P("points"), P(), P(),
                     P("points"), P("points"), P())
        elif layout == "frames":
            n_fr = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
            mesh = make_frames_mesh(frames=n_fr, points=n_dev // n_fr)
            solver_of = lambda iters: make_frames_sharded_solver(
                mesh, cam, offsets, n_points=args.points, window_size=w,
                huber_delta=0.05, backend=backend, max_iterations=iters,
                function_tolerance=0.0, parameter_tolerance=0.0)
            specs = (P(), P("points"), P("points"), P("frames"),
                     P("frames"), P("points", "frames"), P("points"), P())
        else:
            raise ValueError(layout)

        def put(a, spec):
            # Every process holds the FULL array (same seed everywhere), so
            # build the global array per-device via callback — NOT
            # make_array_from_process_local_data, which would interpret the
            # full array as this process's shard and double the global axis.
            a = np.asarray(a)
            if args.procs > 1:
                return jax.make_array_from_callback(
                    a.shape, NamedSharding(mesh, spec), lambda idx: a[idx])
            return jax.device_put(a, NamedSharding(mesh, spec))

        def timed(iters):
            solver = solver_of(iters)
            rng = np.random.default_rng(7)
            # Per-rep varied initializations (bitwise-identical across
            # ranks: same seed), so repeated calls cannot be served from
            # any result cache.
            inits = []
            for _ in range(REPS + 1):
                xi = rng.standard_normal((w, 6)).astype(np.float32) * 0.002
                xi[0] = 0
                t0 = np.asarray(t_wc) @ np.asarray(se3.se3_exp(jnp.asarray(xi)))
                inits.append(tuple(
                    put(a, s) for a, s in zip(
                        (t0, x_world, patch, channels, grads, obs, pv,
                         frozen), specs)))
            jax.block_until_ready(solver(*inits[0]))     # warmup/compile
            t_start = time.perf_counter()
            for rep in range(REPS):
                jax.block_until_ready(solver(*inits[rep + 1]))
            return (time.perf_counter() - t_start) / REPS

        dt_lo = timed(I_LO)
        dt_hi = timed(I_HI)
        ms_iter = (dt_hi - dt_lo) / (I_HI - I_LO) * 1e3
        if args.pid == 0:
            print(json.dumps({
                "layout": layout, "procs": args.procs, "devices": n_dev,
                "points": args.points, "window": w,
                "ms_per_lm_iter": round(ms_iter, 4),
                "m_obs_per_s": round(n_obs / ms_iter / 1e3, 2),
            }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=("main", "worker"), default="main")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--coordinator", default="127.0.0.1:9876")
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--local", action="store_true",
                    help="CPU stand-in devices (wiring validation)")
    ap.add_argument("--layout", default="points,frames")
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=160)
    args = ap.parse_args()

    if args.role == "worker":
        worker(args)
        return 0

    # Main: spawn local CPU workers (wiring validation mode).
    procs = []
    for pid in range(args.procs):
        cmd = [sys.executable, os.path.abspath(__file__), "--role", "worker",
               "--local", "--pid", str(pid), "--procs", str(args.procs),
               "--coordinator", args.coordinator,
               "--devices-per-proc", str(args.devices_per_proc),
               "--layout", args.layout, "--points", str(args.points),
               "--window", str(args.window),
               "--height", str(args.height), "--width", str(args.width)]
        procs.append(subprocess.Popen(
            cmd, stdout=None if pid == 0 else subprocess.DEVNULL,
            stderr=subprocess.DEVNULL, cwd=REPO))
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
