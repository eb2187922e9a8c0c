"""Smoke tests for the user-facing evaluation tools (tools/eval_traj.py,
tools/plot_traj.py): they must run end-to-end on KITTI-format pose files
and produce their artifacts. The metric math itself is pinned in
test_io.py; these protect the CLI surfaces."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_kitti_poses(path, poses):
    with open(path, "w") as f:
        for t in poses:
            f.write(" ".join(f"{v:.9f}" for v in t[:3].reshape(-1)) + "\n")


def _make_traj_files(tmp_path, n=12):
    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 2, 3] = np.arange(n) * 0.8          # forward motion
    gt[:, 0, 3] = 0.1 * np.sin(np.arange(n))  # gentle lateral curve
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.02, (n, 3))
    init = gt.copy()
    init[:, :3, 3] += rng.normal(0, 0.05, (n, 3))
    paths = {}
    for name, arr in (("gt", gt), ("est", est), ("init", init)):
        p = os.path.join(tmp_path, f"{name}.txt")
        _write_kitti_poses(p, arr)
        paths[name] = p
    return paths


def _run(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return subprocess.run([sys.executable] + args, env=env,
                          capture_output=True, text=True, timeout=300)


def test_eval_traj_smoke(tmp_path):
    p = _make_traj_files(str(tmp_path))
    r = _run([os.path.join(REPO, "tools/eval_traj.py"),
              p["est"], p["gt"], p["init"]])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(l) for l in r.stdout.strip().splitlines()]
    assert [rec["trajectory"] for rec in lines] == ["initialization",
                                                    "refined"]
    for rec in lines:
        for key in ("ate_rmse_m", "rpe_trans_m", "rpe_rot_rad",
                    "kitti_t_err_pct", "kitti_r_err_deg_per_100m"):
            assert np.isfinite(rec[key]), rec
    # The smaller perturbation must score the smaller ATE.
    assert lines[1]["ate_rmse_m"] < lines[0]["ate_rmse_m"]


def test_plot_traj_smoke(tmp_path):
    p = _make_traj_files(str(tmp_path))
    jsonl = os.path.join(str(tmp_path), "solve.jsonl")
    with open(jsonl, "w") as f:
        for i in (5, 6, 7):
            f.write(json.dumps({
                "frame": i, "initial_cost": 10.0 / i, "final_cost": 5.0 / i,
                "trans_correction": [0.01 * i, 0.02 * i],
            }) + "\n")
    out = os.path.join(str(tmp_path), "traj.png")
    r = _run([os.path.join(REPO, "tools/plot_traj.py"),
              p["est"], p["gt"], p["init"], "--jsonl", jsonl, "--out", out])
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out) and os.path.getsize(out) > 10_000
    # Without init / jsonl (single-panel column) it must also run.
    out2 = os.path.join(str(tmp_path), "traj2.png")
    r2 = _run([os.path.join(REPO, "tools/plot_traj.py"),
               p["est"], p["gt"], "--out", out2])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert os.path.exists(out2) and os.path.getsize(out2) > 10_000


def test_jax_renderer_matches_numpy(tmp_path):
    """The jitted float32 golden renderer (synthetic.make_render_box_jax)
    must reproduce the float64 numpy render_box below the PNG quantization
    floor — same ray geometry, same sinusoid texture — so golden datasets
    rendered on an accelerator are interchangeable with the numpy ones."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import synthetic as syn

    rng = np.random.default_rng(3)
    tex = syn.make_texture(rng, n_waves=32, min_wavelength=0.2,
                           max_wavelength=3.0)
    from photobundle_tpu.geometry.camera import Camera
    cam = Camera.create(fx=90.0, fy=90.0, cx=29.5, cy=19.5, baseline=0.5)
    obstacles = syn.default_obstacles()[:5]
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3], pose[2, 3] = -28.0, -28.0
    img_np, depth_np = syn.render_box(tex, cam, pose, (40, 60),
                                      obstacles=obstacles)
    render = syn.make_render_box_jax((40, 60), obstacles=obstacles)
    img_jx, depth_jx = render(tex, cam, pose)
    assert np.max(np.abs(img_jx - img_np)) < 1.0 / 255.0
    valid = (depth_np > 0) & (depth_jx > 0)
    assert valid.mean() > 0.9
    assert np.max(np.abs(depth_jx - depth_np)[valid]
                  / depth_np[valid]) < 1e-4
    # Depth validity masks agree (max_depth cut + obstacle hits).
    assert np.mean((depth_np > 0) != (depth_jx > 0)) < 0.01


def test_golden_aggregate_parses_and_flags_collisions(tmp_path):
    """tools/golden_aggregate.py: parses the provenance-keyed tables
    golden_kitti prints, groups by (provenance, model), computes the
    sign record vs the baseline config, and WARNS on colliding labels
    (two logs publishing different values under one config name)."""
    log1 = tmp_path / "a.log"
    log1.write_text(
        "BASELINE.md table (iid error model, seed 7, init ATE 0.0325, "
        "init RPE(1) 0.0442 m,\nprovenance jax/2/0.1/deadbeef/200png):\n"
        "| Config | refined ATE | reduction | RPE(1) trans | RPE(1) rot |\n"
        "|---|---|---|---|---|\n"
        "| W5_production | 0.0234 | +28.0% | 0.0215 | 0.192 deg |\n"
        "| W5_production_tukey | 0.0212 | +34.8% | 0.0205 | 0.106 deg |\n")
    log2 = tmp_path / "b.log"
    log2.write_text(
        "BASELINE.md table (iid error model, seed 9, init ATE 0.0346, "
        "init RPE(1) 0.0465 m,\nprovenance jax/2/0.1/deadbeef/200png):\n"
        "| Config | refined ATE | reduction | RPE(1) trans | RPE(1) rot |\n"
        "|---|---|---|---|---|\n"
        "| W5_production | 0.0244 | +29.5% | 0.0208 | 0.331 deg |\n"
        "| W5_production_tukey | 0.0226 | +34.6% | 0.0200 | 0.132 deg |\n")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "golden_aggregate.py"),
         "--logs", str(tmp_path / "*.log")],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "2W/0L" in out.stdout           # tukey beats baseline twice
    assert "(baseline)" in out.stdout
    assert "+34.7%" in out.stdout          # tukey mean over the 2 seeds
    assert "WARNING" not in out.stderr

    # Same label, same seed, different value -> collision warning.
    log3 = tmp_path / "c.log"
    log3.write_text(
        "BASELINE.md table (iid error model, seed 7, init ATE 0.0325, "
        "init RPE(1) 0.0442 m,\nprovenance jax/2/0.1/deadbeef/200png):\n"
        "| Config | refined ATE | reduction | RPE(1) trans | RPE(1) rot |\n"
        "|---|---|---|---|---|\n"
        "| W5_production | 0.0300 | +8.0% | 0.0215 | 0.192 deg |\n")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "golden_aggregate.py"),
         "--logs", str(tmp_path / "*.log")],
        capture_output=True, text=True)
    assert out.returncode == 0
    assert "colliding rows" in out.stderr
