"""KITTI-scale synthetic golden (BASELINE configs 1/2 stand-in; round-1
VERDICT item 5): 200-frame 370x1226 stereo sequence through a textured box
room on a seq-00-style block loop (straights + 90-degree turns), BM-seeded
depth, full CLI per config, init/refined/GT ATE + RPE table for BASELINE.md.

    python tools/golden_kitti.py                    # walk error model
    python tools/golden_kitti.py --error-model iid  # per-frame jitter model
    python tools/golden_kitti.py --frames 80        # smaller/faster

Error models (round-3 VERDICT item 1):
  'walk' — random-walk VO drift. ATE is dominated by the accumulated
      component, which is gauge-UNOBSERVABLE to a windowed method (the
      window's first poses are frozen at drifted values); only the
      per-pair relative error is correctable.
  'iid'  — independent per-frame jitter around ground truth: fully
      within-window-observable — exactly the error photometric alignment
      corrects, and the regime where a W=5 refinement must win.

The dataset is rendered once and cached under --root; stereo depth is
cached across configs (cfg.depthCacheDir).
"""
import argparse
import glob
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from photobundle_tpu.config import ConfigFile, PBAConfig
from photobundle_tpu.io import kitti as kitti_mod
from photobundle_tpu.io import trajectory as traj_mod
from photobundle_tpu import cli as cli_mod


def dataset_content_hash(root: str) -> str:
    """sha256-of-sha256s over every PNG of sequence 00, truncated to 16 hex
    chars — the provenance key that makes golden tables reproducible
    claims (round-4 verdict weak 2: the same nominal config read -301%
    in round 3 and -147% in round 4 because the dataset silently changed
    renderer; a content hash in every published table makes that drift
    visible instead of mysterious)."""
    import hashlib

    pngs = sorted(glob.glob(os.path.join(root, "sequences", "00",
                                         "image_*", "*.png")))
    h = hashlib.sha256()
    for p in pngs:
        with open(p, "rb") as f:
            h.update(hashlib.sha256(f.read()).digest())
    return f"{h.hexdigest()[:16]}/{len(pngs)}png"


def record_provenance(root: str, params: dict) -> dict:
    """Write render_provenance.json (render parameters + content hash)."""
    import json

    rec = dict(params, content_hash=dataset_content_hash(root))
    with open(os.path.join(root, "render_provenance.json"), "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    return rec


def load_or_check_provenance(root: str) -> dict:
    """Load the recorded provenance; recompute the content hash and flag a
    mismatch (a silently mutated dataset must not publish under the old
    key). Datasets rendered before provenance existed get a record with
    renderer='pre-provenance'."""
    import json

    path = os.path.join(root, "render_provenance.json")
    actual = dataset_content_hash(root)
    if not os.path.exists(path):
        return record_provenance(root, dict(renderer="pre-provenance"))
    rec = json.load(open(path))
    if rec.get("content_hash") != actual:
        print(f"WARNING: dataset {root} content hash {actual} != recorded "
              f"{rec.get('content_hash')} — dataset changed since render; "
              "re-keying", flush=True)
        rec = dict(rec, content_hash=actual, mutated=True)
    return rec


REFERENCE_EXACT = dict(
    slidingWindowSize=5, numFixedPoses=1, depthPriorWeight=0.0,
    motionPriorWeight=0.0, maxPoseCorrection=0.0, interpolation="bicubic",
    # cv::StereoBM's default X-Sobel prefilter (8-bit cap 31 ~ 0.12); the
    # framework default is 0 (raw SAD), so parity rows set it explicitly.
    preFilterCap=0.12)

CONFIGS = {
    # The Ceres-parity stack (configs/reference_exact.cfg): every
    # deviating default pinned off, bicubic sampling.
    "reference_exact": dict(REFERENCE_EXACT),
    # Reference-shape window with the shipped (production) defaults.
    "reference_W5": dict(slidingWindowSize=5),
    # Motion prior at the reference shape: the decisive robustness lever on
    # forward-motion geometry (see BASELINE.md accuracy diagnosis).
    "W5_prior": dict(slidingWindowSize=5, motionPriorWeight=2.0),
    # + observability gate on weakly-supported frames (round 3).
    "W5_prior_obsgate": dict(slidingWindowSize=5, motionPriorWeight=2.0,
                             minObsPerFrame=16),
    # Larger window + motion prior: the accuracy lever the batched design
    # unlocks (BASELINE.md round-1 accuracy table).
    "W10_prior": dict(slidingWindowSize=10, motionPriorWeight=5.0),
    # Coarse-to-fine (round-2): 3-level schedule at the reference window.
    "W5_coarse2fine": dict(slidingWindowSize=5, pyramidLevels=3,
                           coarseToFine=True),
    # Production W=5 (round 3): motion prior + ABSOLUTE pose prior. The
    # sliding chain re-anchors each window on its own previous refinement
    # and discards the VO input's absolute anchoring; posePriorWeight
    # fuses it back in (unbiased under iid error; bounds walk injection
    # under drift). See config.py posePriorWeight.
    "W5_production": dict(slidingWindowSize=5, motionPriorWeight=2.0,
                          posePriorWeight=4.0),
    # Production + coarse-to-fine: with the chain anchored, c2f composes
    # cleanly (round-2's "c2f makes the chain worse" was the unanchored
    # walk, amplified — not a c2f defect) and is the best walk-model row.
    "W5_production_c2f": dict(slidingWindowSize=5, motionPriorWeight=2.0,
                              posePriorWeight=4.0, pyramidLevels=3,
                              coarseToFine=True),
    # Production + redescending loss: tukey hard-zeroes gross photometric
    # outliers (occlusion boundaries at the box obstacles). delta = 0.3
    # sits between inlier residual norms (~0.1-0.2 at D=25) and
    # occlusion-level outliers; see BASELINE.md for the sweep.
    "W5_production_tukey": dict(slidingWindowSize=5, motionPriorWeight=2.0,
                                posePriorWeight=4.0, robustLoss="tukey",
                                robustThreshold=0.3),
    # Production + self-consistent patch-grid scaling (round 5): the
    # model-fidelity lever for SHARP texture (the fixed fronto-parallel
    # grid decorrelates under ~8%/frame footprint change). The round-4
    # frozen-seed variant DEGRADED ATE; the self-consistent reformulation
    # (rho identically 1 in the ref frame) beats the fixed grid on the
    # sharp golden — see BASELINE.md.
    "W5_production_pwscale": dict(slidingWindowSize=5, motionPriorWeight=2.0,
                                  posePriorWeight=4.0, patchWarp="scale"),
    # c2f + hard rotational anchoring to the VO input: the walk-regime
    # winner (round-5 multi-seed table: best walk mean, rotational RPE(1)
    # 10-20x better than every other config). VO rotation drifts far
    # less than translation, so anchoring rotation hard while letting
    # translation float matches the drift error structure.
    "W5_production_rot": dict(slidingWindowSize=5, motionPriorWeight=2.0,
                              posePriorWeight=4.0, pyramidLevels=3,
                              coarseToFine=True, posePriorRotWeight=256.0),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="/tmp/golden_kitti_box")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--error-model", choices=("walk", "iid"), default="walk")
    ap.add_argument("--drift-trans", type=float, default=None,
                    help="per-frame translation error sigma (m); default "
                         "0.03 (walk) / 0.02 (iid)")
    ap.add_argument("--drift-rot", type=float, default=None)
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated subset of configs to run")
    ap.add_argument("--set", action="append", default=[],
                    help="extra key=value config override applied on top "
                         "of every selected config (sweeps)")
    ap.add_argument("--seed", type=int, default=99,
                    help="VO error realization seed (99 reproduces the "
                         "published BASELINE.md tables; other seeds check "
                         "the result is not realization-lucky)")
    ap.add_argument("--supersample", type=int, default=1,
                    help="render the dataset at SxS subpixel samples per "
                         "pixel and box-average (real pixel integration; "
                         "enables sharp textures without view-dependent "
                         "aliasing). Use a distinct --root per setting.")
    ap.add_argument("--min-wavelength", type=float, default=0.25,
                    help="shortest texture wavelength (m); the default is "
                         "the point-sampled render's alias limit at 80 m — "
                         "go lower only with --supersample >= 2")
    ap.add_argument("--trajectory", choices=("block", "lateral"),
                    default="block",
                    help="'lateral' = strafe facing a wall (strong parallax "
                         "for every point, no forward-motion degeneracy) — "
                         "the parity positive-control regime. Use a "
                         "distinct --root per setting.")
    ap.add_argument("--obstacles", choices=("default", "none"),
                    default="default",
                    help="'none' removes the occluding boxes (pure "
                         "photometric consistency; pair with "
                         "--trajectory lateral for the positive control)")
    ap.add_argument("--step", type=float, default=None,
                    help="per-frame translation (m); defaults: 0.8 block, "
                         "0.3 lateral")
    ap.add_argument("--renderer",
                    choices=("auto", "numpy", "jax", "jax2"),
                    default="auto",
                    help="'jax' renders jitted float32 frames on the "
                         "default JAX backend (seconds per supersampled "
                         "frame vs >2 min for the float64 numpy path on a "
                         "1-core host); 'auto' = jax when an accelerator "
                         "is attached. Intensity difference vs numpy is "
                         "below the PNG quantization floor (see "
                         "synthetic.make_render_box_jax).")
    args = ap.parse_args()
    if args.drift_trans is None:
        # walk defaults reproduce the round-2 published table (1%-of-motion
        # drift, init ATE 0.2919 at 200 frames, seed 99).
        args.drift_trans = 0.008 if args.error_model == "walk" else 0.02
    if args.drift_rot is None:
        args.drift_rot = 0.0005 if args.error_model == "walk" else 0.001
    if args.out_dir is None:
        args.out_dir = f"/tmp/golden_kitti_out_{args.error_model}"

    from synthetic import drift_poses, perturb_poses, write_box_kitti_dataset

    # Render-once-and-slice: a dataset rendered at M frames serves every
    # run with --frames <= M (the engine reads only numFrames frames and
    # gt is sliced below), so reuse ANY marker with a large-enough count
    # instead of re-rendering per --frames value (round-3 verdict task 6:
    # a 60-frame re-render cost 611 s).
    existing = [int(m.rsplit("_", 1)[1])
                for m in glob.glob(os.path.join(args.root, ".rendered_*"))
                if m.rsplit("_", 1)[1].isdigit()]
    if not existing or max(existing) < args.frames:
        print(f"rendering {args.frames}-frame golden dataset -> {args.root} "
              "(one-time, cached; reused for any smaller --frames)...",
              flush=True)
        t0 = time.time()
        renderer = args.renderer
        if renderer == "auto":
            import jax
            renderer = "jax" if jax.default_backend() != "cpu" else "numpy"
        rng = np.random.default_rng(12)
        step = (args.step if args.step is not None
                else (0.3 if args.trajectory == "lateral" else 0.8))
        write_box_kitti_dataset(args.root, 0, rng, n_frames=args.frames,
                                supersample=args.supersample,
                                min_wavelength=args.min_wavelength,
                                trajectory=args.trajectory,
                                obstacles=args.obstacles,
                                renderer=renderer,
                                step=step)
        open(os.path.join(args.root, f".rendered_{args.frames}"),
             "w").write("ok")
        record_provenance(args.root, dict(
            renderer=renderer, supersample=args.supersample,
            min_wavelength=args.min_wavelength, trajectory=args.trajectory,
            obstacles=args.obstacles, step=step, frames=args.frames,
            texture_seed=12))
        print(f"rendered in {time.time() - t0:.0f}s", flush=True)

    gt = traj_mod.load_poses_kitti(
        os.path.join(args.root, "poses", "00.txt"))
    gt = traj_mod.Trajectory(gt.poses[:args.frames])
    rng = np.random.default_rng(args.seed)
    make_err = drift_poses if args.error_model == "walk" else perturb_poses
    init = make_err(rng, gt.poses.astype(np.float32),
                    trans_sigma=args.drift_trans,
                    rot_sigma=args.drift_rot, keep_first=2)
    os.makedirs(args.out_dir, exist_ok=True)
    init_path = os.path.join(args.out_dir, "vo_init.txt")
    traj_mod.write_poses_kitti(init_path, traj_mod.Trajectory(
        init.astype(np.float64)))
    init_traj = traj_mod.load_poses_kitti(init_path)
    ate_init = traj_mod.ate_rmse(init_traj, gt, align=False)
    rpe_init, rper_init = traj_mod.rpe(init_traj, gt, delta=1)
    print(f"[{args.error_model}] init ATE {ate_init:.4f} m, "
          f"RPE(1) {rpe_init:.4f} m / {np.degrees(rper_init):.3f} deg "
          f"({args.frames} frames)")

    import dataclasses

    from photobundle_tpu.config import _field_pytype

    fields = {f.name: f for f in dataclasses.fields(PBAConfig)}
    extra = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        ty = _field_pytype(fields[k])
        extra[k] = (v.lower() in ("1", "true", "yes") if ty is bool
                    else ty(v))

    rows = []
    for name in args.configs.split(","):
        overrides = dict(CONFIGS[name], **extra)
        if extra:
            # Disambiguate the printed config label: --set overrides
            # change the config, and tools/golden_aggregate.py groups
            # rows by label — an unmarked override would silently merge
            # with (or shadow) the base config's cells.
            name = name + "".join(f"+{k}={v}" for k, v in sorted(
                extra.items()))
        cfg = PBAConfig(dataDir=args.root, sequence=0,
                        numFrames=args.frames,
                        stereoAlgorithm="BM", numDisparities=128,
                        minDisparity=1, speckleWindowSize=120,
                        depthCacheDir=os.path.join(args.root, "depth_cache"),
                        **overrides)
        # Note: this machine has 1 CPU core, so host-side stereo BM
        # (~0.8 s/frame at 370x1226x128) dominates the FIRST config's
        # wall-clock; later configs hit the depth cache.
        dataset = kitti_mod.create_dataset(cfg)
        out = os.path.join(args.out_dir, f"refined_{name}.txt")
        t0 = time.time()
        refined = cli_mod.run(cfg, dataset, init_traj, output=out,
                              jsonl_path=out + ".jsonl", progress=False)
        dt = time.time() - t0
        ate_ref = traj_mod.ate_rmse(refined, gt, align=False)
        rpe_ref, rper_ref = traj_mod.rpe(refined, gt, delta=1)
        red = 100.0 * (1.0 - ate_ref / ate_init)
        rows.append((name, ate_ref, red, rpe_ref, rper_ref, dt))
        print(f"{name:18s}: ATE {ate_ref:.4f} m ({red:+.1f}%), "
              f"RPE(1) {rpe_ref:.4f} m / {np.degrees(rper_ref):.3f} deg, "
              f"{dt:.0f}s ({args.frames / dt:.1f} keyframes/s)", flush=True)

    prov = load_or_check_provenance(args.root)
    prov_key = "/".join(
        str(prov.get(k)) for k in ("renderer", "supersample",
                                   "min_wavelength", "content_hash"))
    print(f"\nBASELINE.md table ({args.error_model} error model, "
          f"seed {args.seed}, {args.frames} frames, "
          f"init ATE {ate_init:.4f}, "
          f"init RPE(1) {rpe_init:.4f} m,\n"
          f"provenance {prov_key}):")
    print("| Config | refined ATE | reduction | RPE(1) trans | RPE(1) rot |")
    print("|---|---|---|---|---|")
    for name, ate_ref, red, rpe_ref, rper_ref, dt in rows:
        print(f"| {name} | {ate_ref:.4f} | {red:+.1f}% | {rpe_ref:.4f} | "
              f"{np.degrees(rper_ref):.3f} deg |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
