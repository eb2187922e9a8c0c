"""End-to-end CLI verification on a synthetic KITTI-format stereo dataset.

Renders a textured-sphere scene along a ground-truth track, writes a
KITTI-odometry-layout dataset (stereo PNGs, calib.txt, times.txt, poses),
drifts the VO initialization, runs `python -m photobundle_tpu.cli`, and
asserts (a) every window's cost is nonincreasing and (b) the refined
trajectory beats the drifted init on ATE. Run on CPU:

    JAX_PLATFORMS=cpu python tools/verify_e2e.py
"""
import os, sys, json, shutil, subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import conftest  # noqa: F401  (forces the cpu platform)
import numpy as np
import jax.numpy as jnp
from synthetic import make_texture, render_view, drift_poses
from photobundle_tpu.geometry.camera import Camera
from photobundle_tpu.geometry import se3
from photobundle_tpu.io.png import write_png


def main():
    root = "/tmp/verify_kitti"
    shutil.rmtree(root, ignore_errors=True)
    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "image_0"))
    os.makedirs(os.path.join(seq, "image_1"))
    os.makedirs(os.path.join(root, "poses"))

    rng = np.random.default_rng(3)
    H, W = 120, 200
    FX = 120.0
    BASE = 0.2
    cam = Camera.create(fx=FX, fy=FX, cx=W / 2 - 0.5, cy=H / 2 - 0.5,
                        baseline=BASE)
    tex = make_texture(rng)
    NF = 12
    poses = []
    t_wc = np.eye(4, dtype=np.float32)
    for i in range(NF):
        poses.append(t_wc.copy())
        xi = np.concatenate([
            rng.standard_normal(3) * 0.05 + np.array([0.05, 0, 0]),
            rng.standard_normal(3) * 0.002]).astype(np.float32)
        t_wc = (t_wc @ np.asarray(se3.se3_exp(jnp.asarray(xi)))).astype(np.float32)
    poses = np.stack(poses)

    for i, p in enumerate(poses):
        img_l, _ = render_view(tex, cam, p, (H, W))
        pr = p.copy()
        pr[:3, 3] = p[:3, 3] + p[:3, :3] @ np.array([BASE, 0, 0])
        img_r, _ = render_view(tex, cam, pr, (H, W))
        for sub, im in (("image_0", img_l), ("image_1", img_r)):
            arr = np.clip(im * 255, 0, 255).astype(np.uint8)
            write_png(os.path.join(seq, sub, f"{i:06d}.png"), arr)

    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write(f"P0: {FX} 0 {W/2-0.5} 0 0 {FX} {H/2-0.5} 0 0 0 1 0\n")
        f.write(f"P1: {FX} 0 {W/2-0.5} {-FX*BASE} 0 {FX} {H/2-0.5} 0 0 0 1 0\n")
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.writelines(f"{i*0.1:.6f}\n" for i in range(NF))
    with open(os.path.join(root, "poses", "00.txt"), "w") as f:
        for p in poses:
            f.write(" ".join(f"{v:.9f}" for v in p[:3].reshape(-1)) + "\n")

    vo = drift_poses(rng, poses, trans_sigma=0.004, rot_sigma=0.0008)
    with open(os.path.join(root, "vo_init.txt"), "w") as f:
        for p in vo:
            f.write(" ".join(f"{v:.9f}" for v in p[:3].reshape(-1)) + "\n")

    cfgp = os.path.join(root, "run.cfg")
    with open(cfgp, "w") as f:
        f.write(f"""dataDir = {root}
sequence = 0
numFrames = {NF}
descriptor = Intensity
patchRadius = 2
slidingWindowSize = 5
maxNumPoints = 512
maxPointsPerFrame = 128
maxIterations = 25
pyramidLevels = 1
refinementLevel = 0
numDisparities = 48
sadWindowSize = 9
minDepth = 0.5
maxDepth = 50.0
depthPriorWeight = 0.1
""")

    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "photobundle_tpu.cli",
         "--config", cfgp, "--poses", os.path.join(root, "vo_init.txt"),
         "--output", os.path.join(root, "refined.txt"),
         "--log", os.path.join(root, "solve.jsonl")],
        env=env, capture_output=True, text=True, timeout=1500)
    print("\n".join(r.stdout.splitlines()[-4:]))
    if r.returncode != 0:
        print(r.stderr[-3000:])
        sys.exit(1)

    from photobundle_tpu.io.trajectory import (Trajectory, ate_rmse,
                                               load_poses_kitti)
    gt = Trajectory(poses)
    ref = load_poses_kitti(os.path.join(root, "refined.txt"))
    init = Trajectory(vo)
    a_init = ate_rmse(init, gt)
    a_ref = ate_rmse(ref, gt)
    print(f"ATE init={a_init:.5f} refined={a_ref:.5f} "
          f"improvement={a_init/a_ref:.2f}x")
    recs = [json.loads(l) for l in open(os.path.join(root, "solve.jsonl"))]
    dec = all(rec["final_cost"] <= rec["initial_cost"] + 1e-9 for rec in recs)
    print(f"windows solved: {len(recs)}, all costs nonincreasing: {dec}")
    assert dec and a_ref < a_init, "verification failed"
    print("VERIFY OK")


if __name__ == "__main__":
    main()
