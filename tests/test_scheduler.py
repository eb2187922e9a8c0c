"""Elastic lease scheduler: claiming, stealing, idempotent completion.

SURVEY.md section 5.3: the failure-recovery story is lease-based work
stealing — a worker that stops heartbeating loses its unit to a survivor.
These tests simulate membership changes without real processes."""

import os
import time

from photobundle_tpu.parallel.scheduler import (LeaseScheduler, WorkUnit,
                                                make_units)


def test_make_units_whole_sequences():
    units = make_units([0, 3, 7])
    assert [u.sequence for u in units] == [0, 3, 7]
    assert all(u.num_frames == -1 for u in units)
    assert [u.uid for u in units] == [0, 1, 2]


def test_make_units_chunked():
    units = make_units([0], frames_per_unit=100, sequence_lengths={0: 250})
    assert [(u.first_frame, u.num_frames) for u in units] == [
        (0, 100), (100, 100), (200, 50)]


def test_make_units_folds_short_tail():
    # A 3-frame tail can never fill a 5-frame window: it must be folded
    # into the preceding chunk, not dropped or emitted as its own unit.
    units = make_units([0], frames_per_unit=100, sequence_lengths={0: 203},
                       min_frames=5)
    assert [(u.first_frame, u.num_frames) for u in units] == [
        (0, 100), (100, 103)]
    # A tail >= min_frames stays its own unit.
    units = make_units([0], frames_per_unit=100, sequence_lengths={0: 205},
                       min_frames=5)
    assert [(u.first_frame, u.num_frames) for u in units] == [
        (0, 100), (100, 100), (200, 5)]
    # A whole sequence shorter than min_frames is still emitted (the caller
    # owns that case).
    units = make_units([0], frames_per_unit=100, sequence_lengths={0: 3},
                       min_frames=5)
    assert [(u.first_frame, u.num_frames) for u in units] == [(0, 3)]


def test_disjoint_claims_two_workers(tmp_path):
    root = str(tmp_path)
    a = LeaseScheduler(root, "a")
    b = LeaseScheduler(root, "b")
    units = make_units([0, 1, 2, 3])
    a.publish(units)
    b.publish(units)  # idempotent

    claimed = {"a": [], "b": []}
    ita, itb = a.claims(), b.claims()
    ua = next(ita)
    ub = next(itb)
    assert ua.uid != ub.uid
    claimed["a"].append(ua)
    claimed["b"].append(ub)
    a.complete(ua)
    b.complete(ub)
    for w, sched, it in (("a", a, ita), ("b", b, itb)):
        for u in it:
            claimed[w].append(u)
            sched.complete(u)
    uids = sorted(u.uid for w in claimed.values() for u in w)
    assert uids == [0, 1, 2, 3]  # each unit exactly once


def test_steal_from_dead_worker(tmp_path):
    root = str(tmp_path)
    # auto_heartbeat=False models a crashed process: its heartbeat thread
    # dies with it, so the lease goes stale.
    dead = LeaseScheduler(root, "dead", lease_timeout_s=0.2,
                          auto_heartbeat=False)
    live = LeaseScheduler(root, "live", lease_timeout_s=0.2)
    dead.publish(make_units([0]))
    it = dead.claims()
    u = next(it)           # dead claims unit 0 and then never heartbeats
    assert u.uid == 0
    time.sleep(0.25)       # lease expires
    got = []
    for v in live.claims():
        got.append(v)
        live.complete(v)
    assert [v.uid for v in got] == [0]
    assert os.path.exists(os.path.join(root, "unit_00000.done"))


def test_heartbeat_prevents_steal(tmp_path):
    root = str(tmp_path)
    w1 = LeaseScheduler(root, "w1", lease_timeout_s=0.4)
    w2 = LeaseScheduler(root, "w2", lease_timeout_s=0.4)
    w1.publish(make_units([0]))
    it = w1.claims()
    u = next(it)
    # w1 heartbeats; w2 must not steal.
    for _ in range(3):
        time.sleep(0.15)
        w1.heartbeat()
        assert not w2._try_claim(u)
    w1.complete(u)
    assert w2.pending() == []


def test_auto_heartbeat_protects_slow_worker(tmp_path):
    """A live worker stuck in a long operation (e.g. first-window JIT
    compilation of a large window) must not lose its unit: the timer
    thread heartbeats independently of work progress (ADVICE round 1)."""
    root = str(tmp_path)
    slow = LeaseScheduler(root, "slow", lease_timeout_s=0.4)
    thief = LeaseScheduler(root, "thief", lease_timeout_s=0.4)
    slow.publish(make_units([0]))
    it = slow.claims()
    u = next(it)
    # Several lease periods of "compute" with NO manual heartbeat calls.
    deadline = time.time() + 1.5
    while time.time() < deadline:
        time.sleep(0.1)
        assert not thief._try_claim(u), "live worker's unit was stolen"
    slow.complete(u)
    assert thief.pending() == []


def test_release_requeues(tmp_path):
    root = str(tmp_path)
    w1 = LeaseScheduler(root, "w1")
    w2 = LeaseScheduler(root, "w2")
    w1.publish(make_units([0, 1]))
    it = w1.claims()
    u = next(it)
    w1.release(u)  # graceful handback
    got = []
    for v in w2.claims():
        got.append(v.uid)
        w2.complete(v)
    assert sorted(got) == [0, 1]
