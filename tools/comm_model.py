"""Per-iteration collective-volume model for the sharded LM solver, with an
HLO cross-check — the analytic half of the multi-card scaling story.

The distributed Schur assembly (core/lm.py global-assembly block, ShardCtx)
moves, per LM iteration on a ('frames' = F, 'points' = P) mesh:

    psum over frames   : hpp (3,3,N/P) + bp (3,N/P)        = 12·N/P floats
    all-gather (frames): hpc (W/F,3,6,N/P) -> (W,3,6,N/P)  = 18·W·N/P floats
    psum over points   : S ((6W)^2) + rhs (6W) + hcc/bc pose blocks
    psum (both axes)   : O(1) scalars (cost, counts)

Ring-collective wire cost per chip: all-reduce = 2(n-1)/n × bytes,
all-gather = (n-1)/n × result bytes (How to Scale Your Model, ch. 'sharding').

Modes:
    python tools/comm_model.py            # predicted scaling table
    python tools/comm_model.py --verify   # compile the real solver on the
        8-virtual-CPU mesh and check the dominant collectives' shapes/bytes
        in the compiled HLO against the analytic model (exact match).

The throughput/bandwidth parameters are explicit: single-card compute
(--mobs, M observations/s of one LM iteration; defaults from one H100 SXM
at a 400 W power limit: 46.2 M obs/s at 4096x5 and 50.8 M obs/s at
65536x5), and the card-to-card link bandwidth (--link-gbps, default
450 GB/s each way: NVLink on an H100 SXM host, a data-sheet figure, not
measured). No overlap of comm with compute is assumed (XLA typically
overlaps some).
"""
import argparse
import json
import re
import sys

F32 = 4


def analytic_volumes(n_points: int, window: int, mesh_frames: int,
                     mesh_points: int) -> dict:
    """Per-chip result bytes of each per-iteration collective."""
    n_loc = n_points // mesh_points
    w = window
    return {
        # psum over 'frames' (ring of size F): per-point 3x3 blocks + rhs
        "psum_frames_hpp_bp": (9 + 3) * n_loc * F32,
        # all-gather over 'frames': the point-pose coupling, point-minor
        "gather_frames_hpc": 18 * w * n_loc * F32,
        # psum over 'points' (ring of size P): reduced camera system
        # S (6W x 6W) + rhs (6W) + gathered pose blocks hcc/bc
        "psum_points_S_rhs": ((6 * w) ** 2 + 6 * w + w * 36 + w * 6) * F32,
    }


def wire_bytes(volumes: dict, mesh_frames: int, mesh_points: int) -> dict:
    """Ring-collective bytes each chip actually sends per iteration."""
    def ar(b, n):  # all-reduce
        return 2 * (n - 1) / n * b if n > 1 else 0.0

    def ag(b, n):  # all-gather (b = gathered result bytes)
        return (n - 1) / n * b if n > 1 else 0.0

    return {
        "psum_frames_hpp_bp": ar(volumes["psum_frames_hpp_bp"], mesh_frames),
        "gather_frames_hpc": ag(volumes["gather_frames_hpc"], mesh_frames),
        "psum_points_S_rhs": ar(volumes["psum_points_S_rhs"], mesh_points),
    }


def predict(n_points, window, mesh_frames, mesh_points, link_gbps,
            single_chip_mobs):
    chips = mesh_frames * mesh_points
    obs = n_points * window
    compute_ms = obs / (single_chip_mobs * 1e6) / chips * 1e3
    vols = analytic_volumes(n_points, window, mesh_frames, mesh_points)
    wires = wire_bytes(vols, mesh_frames, mesh_points)
    comm_ms = sum(wires.values()) / (link_gbps * 1e9) * 1e3
    eff = compute_ms / (compute_ms + comm_ms)
    return {
        "points": n_points, "window": window,
        "mesh": f"{mesh_frames}x{mesh_points}", "chips": chips,
        "compute_ms_per_iter": round(compute_ms, 3),
        "comm_ms_per_iter": round(comm_ms, 4),
        "predicted_efficiency": round(eff, 3),
        "predicted_m_obs_per_s": round(obs / (compute_ms + comm_ms) / 1e3, 1),
    }


def verify() -> int:
    """Compile the REAL frames-sharded solver on the 8-virtual-CPU mesh and
    check the dominant collectives in the compiled HLO byte-for-byte
    against analytic_volumes."""
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import numpy as np
    import jax
    import jax.numpy as jnp
    import photobundle_tpu  # noqa: F401  (matmul precision)
    from photobundle_tpu.parallel import sharded
    from photobundle_tpu.geometry.camera import Camera
    from photobundle_tpu.image import patches

    MF, MP, N, W = 2, 4, 1024, 8
    mesh = sharded.make_frames_mesh(frames=MF, points=MP)
    cam = Camera.create(fx=718.0, fy=718.0, cx=607.0, cy=185.0,
                        baseline=0.537)
    off = patches.patch_offsets(2)
    solver = sharded.make_frames_sharded_solver(
        mesh, cam, off, n_points=N, window_size=W, huber_delta=0.05,
        max_iterations=4)
    rng = np.random.default_rng(0)
    h, wi = 64, 128
    args = (jnp.tile(jnp.eye(4, dtype=jnp.float32), (W, 1, 1)),
            jnp.asarray(rng.random((N, 3)), jnp.float32),
            jnp.asarray(rng.random((N, 1, 25)), jnp.float32),
            jnp.asarray(rng.random((W, 1, h, wi)), jnp.float32),
            jnp.asarray(rng.random((W, 1, h, wi, 2)), jnp.float32),
            jnp.ones((N, W), bool), jnp.ones((N,), bool),
            jnp.asarray([True, True] + [False] * (W - 2)))
    txt = solver.lower(*args).compile().as_text()

    def shapes(op):
        """All f32 result shapes of collective `op` in the module."""
        out = []
        for m in re.finditer(
                rf"= (\(?)((?:f32|s32)\[[\d,\]\[{{}}0-9a-z_ ,]*?)\)? {op}\(",
                txt):
            out.append(m.group(2))
        return out

    n_loc = N // MP
    checks = {
        # hpc gather: (W/F,3,6,N_loc) -> (W,3,6,N_loc), gathered on dim 0
        f"f32[{W},3,6,{n_loc}]": "all-gather",
        # hpp+bp frames-psum (tupled by XLA)
        f"f32[{W},{W},6,6]": "all-reduce",  # S inside the points-psum tuple
        f"f32[3,3,{n_loc}]": "all-reduce",  # hpp inside the frames-psum tuple
    }
    ok = True
    for shape, op in checks.items():
        found = any(shape in s for s in shapes(op))
        print(f"{'OK ' if found else 'MISSING '} {op:11s} {shape}")
        ok &= found
    vols = analytic_volumes(N, W, MF, MP)
    print("analytic volumes (bytes/chip/iter):",
          json.dumps(vols))
    print("HLO VERIFY", "OK" if ok else "FAILED")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--link-gbps", type=float, default=450.0,
                    help="card-to-card bandwidth each way (NVLink data "
                         "sheet, H100 SXM)")
    ap.add_argument("--mobs", type=float, default=50.8,
                    help="single-card M obs/s at large N (one H100, "
                         "65536x5)")
    args = ap.parse_args()
    if args.verify:
        return verify()
    rows = [
        # BASELINE config-1 shape across a points mesh
        predict(4096, 5, 1, 4, args.link_gbps, 46.2),
        predict(65536, 5, 1, 4, args.link_gbps, args.mobs),
        # BASELINE config-4 (large window) on 2-D meshes
        predict(102400, 64, 2, 2, args.link_gbps, args.mobs),
        predict(102400, 64, 4, 1, args.link_gbps, args.mobs),
    ]
    for r in rows:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
