"""Smoke test of the whole system on the card.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --four-gpus  # four GPUs: the sharded paths only

One card, in order:
  0. the `gpu`-marked tests, in a child process, before this process opens
     the card (a JAX process reserves most of the card's memory);
  1. device: platform, kind, count, and the card's name and power limit;
  2. card against host at the initial iterate: cost and normal equations
     (Hcc, the reduced camera matrix S and its right-hand side) in every
     sampling mode at 4096 points x 5 frames x 5x5 patches, 370x1226
     (bounds in system_errors), then one window solve per mode on the
     card, which must lower the cost;
  3. the fused Triton sampler against its plain-XLA twin at 4096x5 and
     65536x5, with the time of each and of one production evaluation on
     each backend;
  4. the CLI (`photobundle_tpu.cli.main`, in-process) with
     configs/kitti_production.cfg over a rendered 20-frame KITTI-layout
     sequence at 370x1226;
  5. repeatability: the same window solve twice, compared bitwise.

Four cards: the ('frames','points') = (2, 2) solver at 65536 x 16, the
('windows','points') = (2, 2) batched solver on two 16384 x 5 windows, and
the CLI run with meshFrames=2 meshPoints=2 slidingWindowSize=6 — each
against the same work on one card, with shards on all four cards.

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Any failed check raises, so the script exits non-zero and prints no such
line; it also refuses to run where JAX finds no GPU.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H, WI = 370, 1226
REL_TOL = 1e-5          # card vs host, kernel vs XLA: f32, summation order
B_TOL = 3e-5            # the reduced right-hand side (see system_errors)
MESH_TOL = 1e-4         # four cards vs one: psum order (cost rel, pose abs)
MESH_ITERS = 8          # fixed LM steps of the four-card solver checks
CLI_FRAMES = 20
CHAIN = 20              # calls per timed jit in phase 3


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def median_time(fn, *args, repeats=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #
def phase_gpu_tests():
    """The `gpu`-marked tests, in a child, before this process opens the
    card."""
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", os.path.join(REPO, "tests", "test_gpu.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    tail = "\n".join(r.stdout.strip().splitlines()[-3:])
    log(f"[gpu tests] exit {r.returncode}: {tail}")
    if r.returncode != 0:
        log(r.stdout[-4000:] + r.stderr[-4000:])
        raise RuntimeError("gpu-marked tests failed")
    if " passed" not in tail or "skipped" in tail:
        raise RuntimeError("gpu-marked tests did not all run on the card")


MODES = {
    # name: (gradient_mode, patch_warp)
    "sampled": ("sampled", None),
    "bicubic": ("bicubic", None),
    "scale": ("sampled", "scale"),
    "affine": ("sampled", "affine"),
}


def make_window(n_pts, w, seed=1, h=H, wi=WI):
    from __graft_entry__ import _make_problem

    return _make_problem(n_pts, w, h, wi, 2, seed=seed)


def depth_prior_inputs(x):
    """(ref_slot, inverse-depth seed) of a make_window problem: every point
    is seeded in frame 0, whose pose is the identity."""
    import jax.numpy as jnp

    return jnp.zeros(x.shape[:-1], jnp.int32), 1.0 / x[..., 2]


def depth_prior_weight(cam):
    return 0.1 * float(cam.fx)


def evaluation(cam, offsets, args, gradient_mode, warp, backend):
    """One evaluate_compressed at the given iterate (production model:
    mean normalization, Huber, inverse-depth prior)."""
    from photobundle_tpu.core import residuals

    t_wc, x, patch, ch, g, obs, pv, frz = args
    ref_slot, seed = depth_prior_inputs(x)
    pw = None
    if warp is not None:
        z_ref, r_wc_ref = residuals.patch_warp_ref_geometry(t_wc, x, ref_slot)
        pw = (warp, z_ref, r_wc_ref)
    return residuals.evaluate_compressed(
        cam, t_wc, x, patch, ch, g, obs & pv[:, None], offsets, 0.05,
        gradient_mode, depth_prior=(ref_slot, seed, depth_prior_weight(cam)),
        backend=backend, normalize="mean", robust_kind="huber",
        patch_warp=pw)


def normal_system(cam, offsets, args, gradient_mode, warp, backend):
    """Cost, Hcc, S and rhs at the initial iterate."""
    import jax.numpy as jnp

    from photobundle_tpu.core import schur

    res = evaluation(cam, offsets, args, gradient_mode, warp, backend)
    eq = schur.build_normal_equations_compressed(res)
    sysm = schur.reduce_camera_system(eq, jnp.float32(1e-4), args[6],
                                      args[7])
    return {"cost": res.cost, "Hcc": eq.hcc, "S": sysm.s, "b": sysm.rhs}


def system_errors(card, ref):
    """max|d| over the scale each quantity was summed at, and its bound.

    cost and Hcc: relative to themselves, REL_TOL. S = Hcc - sum_p (...)
    subtracts large per-point terms, so its summation-order error is
    measured against its operand Hcc, REL_TOL. b sums gradient x residual,
    and the residual r = s - d cancels two f32 values of ~0.5 down to
    ~1e-2: the card (FMA-contracted interpolation) and the host round r
    differently, which on the XLA sampling paths of an H100 moves b by up
    to 1.4e-5 of max|b| — more than summation order — so b gets B_TOL."""
    scale = {"cost": ref["cost"], "Hcc": ref["Hcc"], "S": ref["Hcc"],
             "b": ref["b"]}
    errs = {k: float(np.max(np.abs(np.asarray(card[k], np.float64)
                                   - np.asarray(ref[k], np.float64)))
                     / max(np.max(np.abs(np.asarray(scale[k]))), 1e-30))
            for k in scale}
    bounds = {"cost": REL_TOL, "Hcc": REL_TOL, "S": REL_TOL, "b": B_TOL}
    return errs, bounds


def phase_card_vs_host(n_pts=4096, w=5, h=H, wi=WI):
    import jax

    from photobundle_tpu.config import PBAConfig

    cam, offsets, args = make_window(n_pts, w, h=h, wi=wi)
    cpu = jax.devices("cpu")[0]
    args_cpu = jax.device_put(args, cpu)
    worst = {}
    for name, (gmode, warp) in MODES.items():
        cfg = PBAConfig(interpolation="bicubic" if gmode == "bicubic"
                        else "bilinear", patchWarp=warp or "none")
        backend = cfg.resolve_backend()
        fn = jax.jit(lambda a, b=backend, gm=gmode, pw=warp: normal_system(
            cam, offsets, a, gm, pw, b))
        host = jax.jit(lambda a, gm=gmode, pw=warp: normal_system(
            cam, offsets, a, gm, pw, "xla"))
        card = jax.device_get(fn(args))
        ref = jax.device_get(host(args_cpu))
        errs, bounds = system_errors(card, ref)
        worst[name] = errs
        log(f"[card vs host] {name:8s} backend={backend:6s} "
            + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
            + f" (plain relative S={rel_err(card['S'], ref['S']):.2e})")
        over = [k for k in errs if errs[k] > bounds[k]]
        if over:
            raise AssertionError(f"{name}: card vs host beyond bounds in "
                                 f"{over}: {errs}")
        _, _, st = jax.device_get(jax.jit(production_solver(
            cam, offsets, backend, gmode, warp))(args))
        c0, c1 = float(st.initial_cost), float(st.final_cost)
        log(f"[window solve] {name:8s} backend={backend:6s} cost {c0:.6g} "
            f"-> {c1:.6g} in {int(st.iterations)} iterations")
        if not (np.isfinite(c1) and c1 < c0):
            raise AssertionError(f"{name}: the window solve did not lower "
                                 f"its cost ({c0} -> {c1})")
    return worst


def per_call(fn, moving, *rest):
    """Seconds per call of scalar `fn(moving, *rest)`, CHAIN calls with a
    moving first argument inside one jit — as in the LM loop, where XLA
    hoists loop-invariant work (plane stacking) out of the iterations."""
    import jax

    def run(m, *r):
        body = lambda i, acc: acc + fn(m + 1e-4 * i.astype(m.dtype), *r)
        return jax.lax.fori_loop(0, CHAIN, body, 0.0)
    return median_time(jax.jit(run), moving, *rest) / CHAIN


def phase_kernel_vs_xla(shapes=((4096, 5), (65536, 5)), h=H, wi=WI,
                        interpret=False):
    """The six statistics of the fused Triton sampler against its plain-XLA
    twin, and the time of one production evaluation on each backend."""
    import jax
    import jax.numpy as jnp

    from photobundle_tpu.core import residuals
    from photobundle_tpu.ops import triton_stats

    total = lambda tree: sum(jnp.sum(v.astype(jnp.float32))
                             for v in jax.tree.leaves(tree))
    out = {}
    for n_pts, w in shapes:
        cam, offsets, args = make_window(n_pts, w, h=h, wi=wi)
        t_wc, x, patch, ch, g = args[:5]
        uv = jax.jit(lambda t, xx: residuals._observation_geometry_pm(
            cam, t, xx)[1])(t_wc, x)
        kern = lambda u, c, gg, p: triton_stats.patch_stats(
            c, gg, u, p, radius=2, center=True, interpret=interpret)
        twin = lambda u, c, gg, p: triton_stats.reference_stats(
            c, gg, u, p, radius=2, center=True)
        err = rel_err(jax.jit(kern)(uv, ch, g, patch),
                      jax.jit(twin)(uv, ch, g, patch))
        t_k, t_t = (per_call(lambda *a, f=f: jnp.sum(f(*a)), uv, ch, g, patch)
                    for f in (kern, twin))
        evals = {}
        for backend in ("xla",) if interpret else ("triton", "xla"):
            ev = lambda xx, rest, b=backend: total(evaluation(
                cam, offsets, (t_wc, xx) + rest, "sampled", None, b))
            evals[backend] = per_call(ev, x, tuple(args[2:]))
        out[(n_pts, w)] = (err, t_k, t_t, evals)
        log(f"[kernel vs xla] {n_pts}x{w}: max|d|/max|ref| = {err:.2e}; "
            f"per call (chain of {CHAIN} in one jit, host clock, "
            f"block_until_ready): kernel {t_k * 1e3:.4f} ms, its XLA twin "
            f"{t_t * 1e3:.4f} ms; one evaluate_compressed "
            + ", ".join(f"{b} {t * 1e3:.4f} ms" for b, t in evals.items()))
        if err > REL_TOL:
            raise AssertionError(f"kernel vs XLA {err:.2e} > {REL_TOL}")
    return out


def render_sequence(root, n_frames=CLI_FRAMES, shape=(H, WI), renderer="jax"):
    """KITTI-layout box-room sequence (true KITTI calibration scale) and an
    iid-perturbed VO initialization. Returns (gt poses, vo path)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from synthetic import perturb_poses, write_box_kitti_dataset

    from photobundle_tpu.io import trajectory as traj_mod

    gt, _ = write_box_kitti_dataset(root, 0, np.random.default_rng(12),
                                    n_frames=n_frames, shape=shape,
                                    renderer=renderer)
    vo = perturb_poses(np.random.default_rng(99), gt.astype(np.float32),
                       trans_sigma=0.02, rot_sigma=0.001, keep_first=2)
    vo_path = os.path.join(root, "vo_init.txt")
    traj_mod.write_poses_kitti(vo_path, traj_mod.Trajectory(
        vo.astype(np.float64)))
    return gt, vo_path


def run_cli(root, vo_path, out_dir, overrides=()):
    """One in-process CLI run with configs/kitti_production.cfg. Returns
    (refined Trajectory, per-window JSONL records, wall seconds)."""
    from photobundle_tpu import cli
    from photobundle_tpu.io import trajectory as traj_mod

    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "refined.txt")
    jsonl = os.path.join(out_dir, "solve.jsonl")
    t0 = time.perf_counter()
    rc = cli.main(["--config", os.path.join(REPO, "configs",
                                            "kitti_production.cfg"),
                   "--poses", vo_path, "--output", out, "--log", jsonl,
                   f"dataDir={root}", "sequence=0",
                   f"numFrames={CLI_FRAMES}", *overrides])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    if not os.path.exists(out):
        raise AssertionError("refined trajectory was not written")
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    return traj_mod.load_poses_kitti(out), recs, wall


def check_cli(gt, vo_path, refined, recs, wall, window):
    from photobundle_tpu.io import trajectory as traj_mod

    expect = CLI_FRAMES - window + 1
    if len(recs) != expect:
        raise AssertionError(f"{len(recs)} windows solved, expected {expect}")
    worse = [r for r in recs if r["final_cost"] > r["initial_cost"]]
    if worse:
        raise AssertionError(f"{len(worse)} windows increased their cost")
    gt_t = traj_mod.Trajectory(gt.astype(np.float64))
    ate0 = traj_mod.ate_rmse(traj_mod.load_poses_kitti(vo_path), gt_t,
                             align=False)
    ate1 = traj_mod.ate_rmse(refined, gt_t, align=False)
    log(f"[cli] {len(recs)} windows, costs nonincreasing; ATE init "
        f"{ate0:.6f} m -> refined {ate1:.6f} m; wall {wall:.3f} s, "
        f"{CLI_FRAMES / wall:.3f} keyframes/s (information; includes "
        "compilation and stereo)")
    if not ate1 < ate0:
        raise AssertionError(f"refined ATE {ate1} !< init ATE {ate0}")
    return ate0, ate1


def phase_cli(shape=(H, WI), renderer="jax"):
    with tempfile.TemporaryDirectory(prefix="pb_smoke_") as root:
        gt, vo = render_sequence(root, shape=shape, renderer=renderer)
        refined, recs, wall = run_cli(root, vo, os.path.join(root, "out"))
        return check_cli(gt, vo, refined, recs, wall, window=5)


def production_solver(cam, offsets, backend, gradient_mode="sampled",
                      warp=None):
    """One window solve of the production model (mean normalization,
    Huber, inverse-depth, motion and pose priors) in a sampling mode."""
    from photobundle_tpu.core import lm

    def solve(args):
        t_wc, x, patch, ch, g, obs, pv, frz = args
        ref_slot, seed = depth_prior_inputs(x)
        return lm.lm_solve(cam, t_wc, x, patch, ch, g, obs, pv, frz, offsets,
                           huber_delta=0.05, gradient_mode=gradient_mode,
                           backend=backend, normalize="mean",
                           depth_prior=(ref_slot, seed,
                                        depth_prior_weight(cam)),
                           patch_warp=None if warp is None else (warp,
                                                                 ref_slot),
                           motion_prior_weight=2.0,
                           pose_prior=(t_wc, 4.0, -1.0), max_iterations=50)
    return solve


def phase_repeatability(n_pts=4096, w=5, h=H, wi=WI):
    """The same production window solve twice per backend, compared
    bitwise. A difference is reported, not failed: it names which outputs
    moved (XLA's GPU reductions may use atomics unless
    --xla_gpu_deterministic_ops=true is in XLA_FLAGS)."""
    import jax

    from photobundle_tpu.config import PBAConfig

    cam, offsets, args = make_window(n_pts, w, h=h, wi=wi)
    names = ("t_wc", "x_world") + tuple(f"stats.{f}" for f in
                                         ("initial_cost", "final_cost",
                                          "iterations", "cost_log"))
    same = {}
    for backend in dict.fromkeys((PBAConfig().resolve_backend(), "xla")):
        fn = jax.jit(production_solver(cam, offsets, backend))
        a = jax.device_get(fn(args))
        b = jax.device_get(fn(args))
        pick = lambda r: (r[0], r[1], r[2].initial_cost, r[2].final_cost,
                          r[2].iterations, r[2].cost_log)
        moved = {n: float(np.nanmax(np.abs(np.asarray(x, np.float64)
                                           - np.asarray(y, np.float64))))
                 for n, x, y in zip(names, pick(a), pick(b))
                 if not np.array_equal(x, y, equal_nan=True)}
        same[backend] = not moved
        log(f"[repeatability] backend={backend}: two solves of one window "
            + ("are bitwise identical" if not moved else
               "differ: " + ", ".join(f"{k} max|d| {v:.3e}"
                                      for k, v in moved.items()))
            + f" (XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r})")
    return same


# --------------------------------------------------------------------- #
# four cards
# --------------------------------------------------------------------- #
def shard_devices(arr):
    return {s.device.id for s in arr.addressable_shards}


def solve_diff(one, four):
    """(final-cost relative difference, max pose difference) of two
    (t_wc, x, LMStats) results."""
    c1 = np.asarray(one[2].final_cost, np.float64)
    c4 = np.asarray(four[2].final_cost, np.float64)
    return (float(np.max(np.abs(c4 - c1) / np.abs(c1))),
            float(np.max(np.abs(np.asarray(four[0]) - np.asarray(one[0])))))


def compare_on_mesh(name, make_solver, args, place, held):
    """MESH_ITERS fixed LM steps (production model: inverse-depth prior),
    one card against four: final cost and poses within MESH_TOL — they
    differ only by the psum order."""
    import jax

    r1 = jax.device_get(make_solver(1)(*args))
    out4 = make_solver(4)(*place(args))
    held |= shard_devices(out4[1])
    r4 = jax.device_get(out4)
    cost_err, pose_err = solve_diff(r1, r4)
    acc = lambda r: "".join(str(int(v)) for v in
                            np.asarray(r[2].accept_log).reshape(-1))
    log(f"[four cards] {name}, {MESH_ITERS} LM steps: final cost rel "
        f"{cost_err:.2e}, pose max|d| {pose_err:.2e}; accepts one card "
        f"{acc(r1)} four cards {acc(r4)}; shards on cards {sorted(held)}")
    if cost_err > MESH_TOL or pose_err > MESH_TOL:
        raise AssertionError(f"{name}: four cards differ from one card")
    if len(held) != 4:
        raise AssertionError(f"shards only on cards {sorted(held)}")


def phase_frames_mesh(n_pts=65536, w=16, h=H, wi=WI):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from photobundle_tpu.config import PBAConfig
    from photobundle_tpu.parallel.sharded import (
        make_frames_mesh, make_frames_sharded_solver)

    cam, offsets, args = make_window(n_pts, w, h=h, wi=wi)
    args = args + depth_prior_inputs(args[1])
    devs = jax.devices()
    mesh = make_frames_mesh(frames=2, points=2, devices=devs[:4])

    def make_solver(cards):
        m = mesh if cards == 4 else make_frames_mesh(1, 1, devices=devs[:1])
        return make_frames_sharded_solver(
            m, cam, offsets, n_points=n_pts, window_size=w, huber_delta=0.05,
            backend=PBAConfig().resolve_backend(),
            depth_prior_weight=depth_prior_weight(cam),
            max_iterations=MESH_ITERS, function_tolerance=0.0,
            parameter_tolerance=0.0)

    pt = P("points")
    specs = (P(), pt, pt, P("frames"), P("frames"), P("points", "frames"),
             pt, P(), pt, pt)
    place = lambda a: tuple(jax.device_put(x, NamedSharding(mesh, s))
                            for x, s in zip(a, specs))
    held = set().union(*(shard_devices(x) for x in place(args)))
    compare_on_mesh(f"frames x points = 2 x 2, {n_pts} x {w}", make_solver,
                    args, place, held)


def phase_windows_mesh(n_pts=16384, w=5, h=H, wi=WI):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from photobundle_tpu.config import PBAConfig
    from photobundle_tpu.parallel import make_mesh
    from photobundle_tpu.parallel.sharded import make_batched_sharded_solver

    wins = [make_window(n_pts, w, seed=s, h=h, wi=wi) for s in (1, 2)]
    cam, offsets = wins[0][:2]
    batch = tuple(jnp.stack(v) for v in zip(
        *(a + depth_prior_inputs(a[1]) for _, _, a in wins)))
    devs = jax.devices()
    mesh = make_mesh(points=2, windows=2, devices=devs[:4])

    def make_solver(cards):
        m = mesh if cards == 4 else make_mesh(devices=devs[:1])
        return make_batched_sharded_solver(
            m, cam, offsets, n_points=n_pts, huber_delta=0.05,
            backend=PBAConfig().resolve_backend(),
            depth_prior_weight=depth_prior_weight(cam),
            max_iterations=MESH_ITERS, function_tolerance=0.0,
            parameter_tolerance=0.0)

    wpt, wrep = P("windows", "points"), P("windows")
    specs = (wrep, wpt, wpt, wrep, wrep, wpt, wpt, wrep, wpt, wpt)
    place = lambda a: tuple(jax.device_put(x, NamedSharding(mesh, s))
                            for x, s in zip(a, specs))
    held = set().union(*(shard_devices(x) for x in place(batch)))
    compare_on_mesh(f"windows x points = 2 x 2, 2 windows of {n_pts} x {w}",
                    make_solver, batch, place, held)


def compare_cli_windows(one, four):
    """Window results of two CLI runs, in order while both runs solve the
    same problem (same points and residuals). Compared: the initial cost
    and the cost after every LM step up to the first step the runs decide
    differently (LM's acceptance and termination tests are discontinuous,
    so a last-bit difference can flip one), and where the whole LM path
    agrees, the final cost and the poses.

    The first window has the same inputs in both runs, so it is held to
    MESH_TOL. Every later window starts from the previous window's refined
    poses, which already differ, so its differences are reported; a window
    whose LM path parts refines differently, and the comparison ends there.
    Returns the number of windows compared."""
    for n, (a, b) in enumerate(zip(one, four)):
        where = f"window {a.frame_ids.tolist()}"
        if (a.num_points, a.num_residuals) != (b.num_points,
                                                b.num_residuals):
            log(f"[four cards] cli {where}: {a.num_points} vs "
                f"{b.num_points} points, {a.num_residuals} vs "
                f"{b.num_residuals} residuals; comparison ends")
            return n
        m = min(a.iterations, b.iterations)
        flips = np.flatnonzero(np.asarray(a.accept_log[:m])
                               != np.asarray(b.accept_log[:m]))
        k = int(flips[0]) if flips.size else m
        costs = lambda r: np.concatenate([[r.initial_cost],
                                          np.asarray(r.cost_log[:k])])
        cost_err = float(np.max(np.abs(costs(b) - costs(a))
                                / np.abs(costs(a))))
        same_path = (not flips.size and a.iterations == b.iterations
                     and a.termination == b.termination)
        pose_err = float(np.max(np.abs(b.poses - a.poses))) if same_path \
            else float("nan")
        log(f"[four cards] cli {where}: cost rel {cost_err:.2e} over the "
            f"initial cost and {k} shared LM steps; "
            + (f"same LM path, pose max|d| {pose_err:.2e}" if same_path else
               f"LM paths part at step {k} ({a.iterations} vs "
               f"{b.iterations} steps, {a.termination} vs "
               f"{b.termination}); comparison ends"))
        if n == 0 and (cost_err > MESH_TOL or pose_err > MESH_TOL):
            raise AssertionError(f"first window: four cards differ from "
                                 f"one card beyond {MESH_TOL:g}")
        if not same_path:
            return n + 1
    return len(one)


def phase_cli_mesh(shape=(H, WI), renderer="jax"):
    """The CLI with meshFrames=2 meshPoints=2 against one card. Each run
    must refine on its own (every window solves, costs nonincreasing, ATE
    lowered), and their first window, whose inputs are the same, must
    agree within MESH_TOL (see compare_cli_windows)."""
    from photobundle_tpu.core import engine

    base = ["slidingWindowSize=6"]
    held = set()
    results = {}
    add_frame = engine.PhotometricBundleAdjustment.add_frame

    def spy(run):
        def add(self, *a, **k):
            if run == "four":
                held.update(shard_devices(self.window.channels))
            out = add_frame(self, *a, **k)
            if out is not None:
                results.setdefault(run, []).append(out)
            return out
        return add

    with tempfile.TemporaryDirectory(prefix="pb_smoke_mesh_") as root:
        gt, vo = render_sequence(root, shape=shape, renderer=renderer)
        try:
            engine.PhotometricBundleAdjustment.add_frame = spy("one")
            ref, recs1, wall1 = run_cli(root, vo, os.path.join(root, "one"),
                                        base)
            engine.PhotometricBundleAdjustment.add_frame = spy("four")
            out, recs4, wall4 = run_cli(
                root, vo, os.path.join(root, "four"),
                base + ["meshFrames=2", "meshPoints=2"])
        finally:
            engine.PhotometricBundleAdjustment.add_frame = add_frame
        check_cli(gt, vo, ref, recs1, wall1, window=6)
        check_cli(gt, vo, out, recs4, wall4, window=6)
    n_cmp = compare_cli_windows(results["one"], results["four"])
    log(f"[four cards] cli meshFrames=2 meshPoints=2 vs one card: {n_cmp} "
        f"of {len(results['one'])} windows compared; whole-run pose "
        f"max|d| {float(np.max(np.abs(out.poses - ref.poses))):.2e}; window "
        f"images on cards {sorted(held)}")
    if n_cmp == 0:
        raise AssertionError("the first window's problems differ")
    if len(held) != 4:
        raise AssertionError(f"window images only on cards {sorted(held)}")


# --------------------------------------------------------------------- #
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)
    need = 4 if args.four_gpus else 1

    if not args.four_gpus:
        phase_gpu_tests()

    sys.path.insert(0, REPO)
    import photobundle_tpu  # noqa: F401  (precision + compile cache)
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX found platform '{dev.platform}'")
        return 1
    if len(devs) < need:
        log(f"need {need} GPUs, JAX found {len(devs)}")
        return 1
    log(f"[device] platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)}")
    log(f"[device] card: {card_line()}")

    phases = ((phase_frames_mesh, phase_windows_mesh, phase_cli_mesh)
              if args.four_gpus else
              (phase_card_vs_host, phase_kernel_vs_xla, phase_cli,
               phase_repeatability))
    failed = []
    for phase in phases:
        try:
            phase()
        except Exception:       # report every phase, then fail the run
            traceback.print_exc()
            failed.append(phase.__name__)
    if failed:
        log(f"FAILED: {', '.join(failed)}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
