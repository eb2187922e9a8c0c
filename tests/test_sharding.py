"""Multi-device tests on the 8-virtual-CPU mesh (SURVEY.md section 4:
'distributed without a cluster'): the sharded LM solve must match the
single-device solve numerically, and the batched multi-window solver must
run under a ('windows', 'points') mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photobundle_tpu.core import lm
from photobundle_tpu.parallel import make_mesh
from photobundle_tpu.parallel.sharded import (
    ShardedLMSolver,
    make_batched_sharded_solver,
    make_frames_mesh,
    make_frames_sharded_solver,
)

from synthetic import perturb_poses, pose_errors
from test_residuals import setup_problem


def make_inputs(rng, n_pts=64, w=4):
    cam, t_wc, x, patch, ch, g, obs, off = setup_problem(rng, n_pts=n_pts, w=w)
    t_init = jnp.asarray(perturb_poses(rng, np.asarray(t_wc), 0.02, 0.004,
                                       keep_first=2))
    frozen = jnp.asarray([True, True] + [False] * (w - 2))
    point_valid = jnp.ones((n_pts,), bool)
    return cam, off, (t_init, x, patch, ch, g, obs, point_valid, frozen)


def test_sharded_matches_single_device(rng):
    cam, off, args = make_inputs(rng, n_pts=64)
    kw = dict(huber_delta=1e9, gradient_mode="sampled", max_iterations=8)

    t_single, x_single, s_single = lm.lm_solve(cam, *args[:2], *args[2:6],
                                               args[6], args[7], off, **kw)

    mesh = make_mesh(points=4, windows=1)
    solver = ShardedLMSolver(mesh, cam, off, n_points=64, **kw)
    t_shard, x_shard, s_shard = solver(*args)

    np.testing.assert_allclose(np.asarray(t_shard), np.asarray(t_single),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(x_shard), np.asarray(x_single),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(float(s_shard.final_cost),
                               float(s_single.final_cost), rtol=1e-3)
    assert int(s_shard.iterations) == int(s_single.iterations)


def test_sharded_improves_poses(rng):
    cam, off, args = make_inputs(rng, n_pts=128)
    mesh = make_mesh(points=8, windows=1)
    solver = ShardedLMSolver(mesh, cam, off, n_points=128, huber_delta=1e9,
                             max_iterations=25)
    t_ref, _, stats = solver(*args)
    assert float(stats.final_cost) < 0.3 * float(stats.initial_cost)


def test_sharded_rejects_bad_capacity(rng):
    cam, off, _ = make_inputs(rng, n_pts=64)
    mesh = make_mesh(points=8, windows=1)
    with pytest.raises(ValueError):
        ShardedLMSolver(mesh, cam, off, n_points=63, huber_delta=1.0)


def test_frames_sharded_matches_single_device(rng):
    """('frames'=2, 'points'=4) 2-D mesh (SURVEY.md 5.7, BASELINE config 4):
    window images sharded over frames, Schur assembled via
    psum(frames)+psum(points)+all_gather(frames) — must match the
    single-device solve."""
    cam, off, args = make_inputs(rng, n_pts=64, w=4)
    kw = dict(huber_delta=1e9, gradient_mode="sampled", max_iterations=8)

    t_single, x_single, s_single = lm.lm_solve(cam, *args[:2], *args[2:6],
                                               args[6], args[7], off, **kw)

    mesh = make_frames_mesh(frames=2, points=4)
    solver = make_frames_sharded_solver(mesh, cam, off, n_points=64,
                                        window_size=4, **kw)
    t_shard, x_shard, s_shard = solver(*args)

    np.testing.assert_allclose(np.asarray(t_shard), np.asarray(t_single),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(x_shard), np.asarray(x_single),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(float(s_shard.final_cost),
                               float(s_single.final_cost), rtol=1e-3)
    assert int(s_shard.iterations) == int(s_single.iterations)


@pytest.mark.slow
def test_frames_sharded_with_priors_matches(rng):
    """Frames sharding with the inverse-depth prior (global ref_slot ->
    local comparison) and the motion prior (replicated pose math): both
    must survive the 2-D layout."""
    import jax.numpy as jnp

    cam, off, args = make_inputs(rng, n_pts=32, w=4)
    t_init, x, patch, ch, g, obs, pv, frozen = args
    ref_slot = jnp.asarray(rng.integers(0, 4, size=32), jnp.int32)
    y = np.asarray(x)  # world == camera frame 0 here; crude seed
    seed = jnp.asarray(1.0 / np.maximum(y[:, 2], 0.1))
    kw = dict(huber_delta=1e9, gradient_mode="sampled", max_iterations=6)

    t_single, x_single, s_single = lm.lm_solve(
        cam, t_init, x, patch, ch, g, obs, pv, frozen, off,
        depth_prior=(ref_slot, seed, 2.0), motion_prior_weight=1.0, **kw)

    mesh = make_frames_mesh(frames=4, points=2)
    solver = make_frames_sharded_solver(
        mesh, cam, off, n_points=32, window_size=4,
        depth_prior_weight=2.0, motion_prior_weight=1.0, **kw)
    t_shard, x_shard, s_shard = solver(t_init, x, patch, ch, g, obs, pv,
                                       frozen, ref_slot, seed)
    np.testing.assert_allclose(np.asarray(t_shard), np.asarray(t_single),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(s_shard.final_cost),
                               float(s_single.final_cost), rtol=1e-3)


def test_batched_multi_window_solver(rng):
    """2 windows x 4 point-shards on the 8-device mesh (DP x TP-analog)."""
    cam, off, args_a = make_inputs(rng, n_pts=32, w=4)
    _, _, args_b = make_inputs(np.random.default_rng(5), n_pts=32, w=4)

    def stack(a, b):
        return jnp.stack([a, b])

    batched_args = tuple(stack(a, b) for a, b in zip(args_a, args_b))
    mesh = make_mesh(points=4, windows=2)
    solver = make_batched_sharded_solver(mesh, cam, off, n_points=32,
                                         huber_delta=1e9, max_iterations=6)
    t_ref, x_ref, stats = solver(*batched_args)
    assert t_ref.shape == (2, 4, 4, 4)
    assert x_ref.shape == (2, 32, 3)
    final = np.asarray(stats.final_cost)
    initial = np.asarray(stats.initial_cost)
    assert (final <= initial + 1e-9).all()
    # Each window's solve matches its unbatched counterpart.
    t_a, x_a, s_a = lm.lm_solve(cam, *args_a[:2], *args_a[2:6], args_a[6],
                                args_a[7], off, huber_delta=1e9,
                                max_iterations=6)
    np.testing.assert_allclose(np.asarray(t_ref[0]), np.asarray(t_a),
                               atol=1e-4, rtol=1e-4)


def test_batched_multi_window_solver_depth_prior(rng):
    """The batched solver with the inverse-depth prior: each window of the
    (windows, points) = (2, 4) mesh matches its own one-device solve."""
    wins = [make_inputs(np.random.default_rng(s), n_pts=32, w=4)
            for s in (0, 5)]
    cam, off = wins[0][:2]
    priors = [(jnp.asarray(rng.integers(0, 4, size=32), jnp.int32),
               1.0 / jnp.maximum(a[1][:, 2], 0.1)) for _, _, a in wins]
    batched = tuple(jnp.stack(v) for v in zip(*(a + p for (_, _, a), p
                                                 in zip(wins, priors))))
    kw = dict(huber_delta=1e9, max_iterations=6, function_tolerance=0.0,
              parameter_tolerance=0.0)
    solver = make_batched_sharded_solver(
        make_mesh(points=4, windows=2), cam, off, n_points=32,
        depth_prior_weight=2.0, **kw)
    t_b, _, s_b = solver(*batched)
    for i, ((_, _, a), (ref_slot, seed)) in enumerate(zip(wins, priors)):
        t_1, _, s_1 = lm.lm_solve(cam, *a, off,
                                  depth_prior=(ref_slot, seed, 2.0), **kw)
        np.testing.assert_allclose(np.asarray(t_b[i]), np.asarray(t_1),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(s_b.final_cost[i]),
                                   float(s_1.final_cost), rtol=1e-4)


@pytest.fixture(scope="module")
def scene_mod():
    from synthetic import make_sequence

    rng = np.random.default_rng(3)
    cam, images, depths, poses = make_sequence(rng, n_frames=8, shape=(96, 144))
    return cam, images, depths, poses


@pytest.mark.slow
def test_engine_mesh_points_matches_single_device(scene_mod):
    """Full engine with cfg.meshPoints=4 (points-sharded solve under
    shard_map) must match the single-device engine's refined trajectory —
    the gauge-consistency requirement of SURVEY.md 'hard parts'."""
    import numpy as np
    from photobundle_tpu.core.engine import PhotometricBundleAdjustment
    from test_engine import small_cfg

    cam, images, depths, poses_gt = scene_mod
    rng = np.random.default_rng(5)
    init = perturb_poses(rng, poses_gt, trans_sigma=0.02, rot_sigma=0.002,
                         keep_first=2)

    results = {}
    for mesh_pts in (1, 4):
        # Production priors ON so the replicated prior math (incl. the
        # absolute pose prior's t_vo anchor) is pinned across mesh layouts.
        cfg = small_cfg(maxNumPoints=256, maxPointsPerFrame=64,
                        maxIterations=10, meshPoints=mesh_pts,
                        motionPriorWeight=2.0, posePriorWeight=4.0)
        pba = PhotometricBundleAdjustment(cam, images[0].shape, cfg)
        poses = []
        for i, (img, depth) in enumerate(zip(images, depths)):
            r = pba.add_frame(img, depth, init[i])
            if r is not None:
                poses.append(r.poses.copy())
        results[mesh_pts] = poses
    assert len(results[1]) == len(results[4]) > 0
    for pa, pb in zip(results[1], results[4]):
        np.testing.assert_allclose(pa, pb, atol=5e-5)


@pytest.mark.slow
def test_engine_mesh_windows_from_cfg(scene_mod):
    """meshWindows driven END-TO-END from a .cfg (round-1 VERDICT item 7):
    the batched engine over the ('windows'=2, 'points'=4) 8-device mesh
    must match per-sequence single-device engines."""
    from photobundle_tpu.config import ConfigFile, PBAConfig
    from photobundle_tpu.core.batched import BatchedPhotometricBundleAdjustment
    from photobundle_tpu.core.engine import PhotometricBundleAdjustment

    cfg = PBAConfig.from_config_file(ConfigFile(text="""
        slidingWindowSize = 4
        maxNumPoints = 128
        maxPointsPerFrame = 32
        maxIterations = 8
        patchRadius = 2
        meshWindows = 2
        meshPoints = 4
        minSaliency = 0.0005
        depthPriorWeight = 0.1
    """))
    assert cfg.meshWindows == 2 and cfg.meshPoints == 4

    cam, images, depths, poses_gt = scene_mod
    rng = np.random.default_rng(7)
    init_a = perturb_poses(rng, poses_gt, 0.01, 0.002, keep_first=2)
    init_b = perturb_poses(rng, poses_gt, 0.02, 0.003, keep_first=2)
    # Two "sequences": the same frames with different initializations.
    bpba = BatchedPhotometricBundleAdjustment(cam, images[0].shape, cfg,
                                              batch=2)
    batched_poses = []
    for i, (img, depth) in enumerate(zip(images, depths)):
        rs = bpba.add_frames([img, img], [depth, depth],
                             [init_a[i], init_b[i]])
        if rs is not None:
            batched_poses.append([r.poses.copy() for r in rs])
    assert batched_poses, "batched engine never solved a window"

    # Oracle: independent single-device engines per sequence.
    single_cfg = cfg.replace(meshWindows=1, meshPoints=1)
    for b, init in enumerate((init_a, init_b)):
        pba = PhotometricBundleAdjustment(cam, images[0].shape, single_cfg)
        k = 0
        for i, (img, depth) in enumerate(zip(images, depths)):
            r = pba.add_frame(img, depth, init[i])
            if r is not None:
                # Same tolerance as test_engine's batched-vs-individual
                # check: vmapped and single programs have different fp
                # schedules, and the difference walks gauge-weak directions
                # across chained windows.
                np.testing.assert_allclose(batched_poses[k][b], r.poses,
                                           atol=1e-3)
                k += 1
        assert k == len(batched_poses)


@pytest.mark.slow
def test_engine_mesh_frames_matches_single_device(scene_mod):
    """Full engine with cfg.meshFrames=2 x meshPoints=4 (round-3 VERDICT
    item 3: the window ring's image leaves REST sharded over the 'frames'
    axis, solve under the full ('frames','points') ShardCtx) must match the
    single-device engine's refined trajectory."""
    import numpy as np
    from photobundle_tpu.core.engine import PhotometricBundleAdjustment
    from test_engine import small_cfg

    cam, images, depths, poses_gt = scene_mod
    rng = np.random.default_rng(5)
    init = perturb_poses(rng, poses_gt, trans_sigma=0.02, rot_sigma=0.002,
                         keep_first=2)

    results = {}
    for mesh_fr, mesh_pt in ((1, 1), (2, 4)):
        cfg = small_cfg(slidingWindowSize=4, maxNumPoints=256,
                        maxPointsPerFrame=64, maxIterations=10,
                        meshFrames=mesh_fr, meshPoints=mesh_pt)
        pba = PhotometricBundleAdjustment(cam, images[0].shape, cfg)
        if mesh_fr > 1:
            # The window image leaves must actually REST sharded over
            # 'frames' (the memory claim of SURVEY.md 5.7).
            sh = pba.window.channels.sharding
            assert sh.spec[0] == "frames", sh
        poses = []
        for i, (img, depth) in enumerate(zip(images, depths)):
            r = pba.add_frame(img, depth, init[i])
            if r is not None:
                poses.append(r.poses.copy())
        if mesh_fr > 1:
            sh = pba.window.channels.sharding
            assert sh.spec[0] == "frames", ("ingest de-sharded the ring", sh)
        results[(mesh_fr, mesh_pt)] = poses
    assert len(results[(1, 1)]) == len(results[(2, 4)]) > 0
    for pa, pb in zip(results[(1, 1)], results[(2, 4)]):
        np.testing.assert_allclose(pa, pb, atol=5e-5)


def test_mesh_frames_cfg_validation():
    from photobundle_tpu.config import PBAConfig
    import pytest as _pytest

    with _pytest.raises(ValueError, match="divisible by meshFrames"):
        PBAConfig(slidingWindowSize=5, meshFrames=2).validate()


def test_engine_mesh_frames_coarse_to_fine_matches_single_device(scene_mod):
    """coarseToFine under cfg.meshFrames (round-3: the cross-shard
    ref-image gather — each frame shard extracts coarse patches for its
    local frames; a one-hot select + psum over 'frames' replicates each
    point's ref-frame patch) must match the single-device c2f engine."""
    import numpy as np
    from photobundle_tpu.core.engine import PhotometricBundleAdjustment
    from test_engine import small_cfg

    cam, images, depths, poses_gt = scene_mod
    rng = np.random.default_rng(6)
    init = perturb_poses(rng, poses_gt, trans_sigma=0.02, rot_sigma=0.002,
                         keep_first=2)

    results = {}
    for mesh_fr, mesh_pt in ((1, 1), (2, 4)):
        cfg = small_cfg(slidingWindowSize=4, maxNumPoints=256,
                        maxPointsPerFrame=64, maxIterations=8,
                        coarseToFine=True, pyramidLevels=3,
                        coarseIterations=4,
                        meshFrames=mesh_fr, meshPoints=mesh_pt)
        pba = PhotometricBundleAdjustment(cam, images[0].shape, cfg)
        assert pba._n_coarse > 0, "c2f schedule must engage for this test"
        poses = []
        for img, depth, t in zip(images, depths, init):
            r = pba.add_frame(img, depth, t)
            if r is not None:
                poses.append(r.poses.copy())
        results[(mesh_fr, mesh_pt)] = poses
    assert len(results[(1, 1)]) == len(results[(2, 4)]) > 0
    for pa, pb in zip(results[(1, 1)], results[(2, 4)]):
        np.testing.assert_allclose(pa, pb, atol=5e-5)


@pytest.mark.slow
def test_engine_mesh_points_patchwarp_matches_single_device(scene_mod):
    """cfg.patchWarp='scale' under the points mesh: the warp's reference
    geometry is computed from the FULL replicated poses inside lm_solve
    (the ref frame may live on any shard), so the sharded trajectory must
    match the single-device engine like the fixed-grid case does."""
    import numpy as np
    from photobundle_tpu.core.engine import PhotometricBundleAdjustment
    from test_engine import small_cfg

    cam, images, depths, poses_gt = scene_mod
    rng = np.random.default_rng(5)
    init = perturb_poses(rng, poses_gt, trans_sigma=0.02, rot_sigma=0.002,
                         keep_first=2)

    results = {}
    for mesh_pts in (1, 4):
        cfg = small_cfg(maxNumPoints=256, maxPointsPerFrame=64,
                        maxIterations=10, meshPoints=mesh_pts,
                        motionPriorWeight=2.0, posePriorWeight=4.0,
                        patchWarp="scale")
        pba = PhotometricBundleAdjustment(cam, images[0].shape, cfg)
        poses = []
        for i, (img, depth) in enumerate(zip(images, depths)):
            r = pba.add_frame(img, depth, init[i])
            if r is not None:
                poses.append(r.poses.copy())
        results[mesh_pts] = poses
    assert len(results[1]) == len(results[4]) > 0
    for pa, pb in zip(results[1], results[4]):
        np.testing.assert_allclose(pa, pb, atol=5e-5)
