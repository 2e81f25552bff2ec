"""Evaluator trajectory stop-mask logic: steps after the first terminal
state must not be replayed (reference net.py:820-821 break semantics)."""

import numpy as np
import pytest

from exposure_jax.core.evaluator import Evaluator
from exposure_jax.core.rollout import Trajectory
from exposure_jax.utils.ops import STATE_STOPPED_DIM


def make_traj(stopped_flags):
    # stopped_flags: [K][B] stop flag AFTER each step
    k = len(stopped_flags)
    b = len(stopped_flags[0])
    states = np.zeros((k, b, 11), np.float32)
    for i in range(k):
        states[i, :, STATE_STOPPED_DIM] = stopped_flags[i]
    return Trajectory(
        images=np.zeros((k, b, 4, 4, 3), np.float32),
        states=states,
        filter_ids=np.zeros((k, b), np.int32),
        params=np.zeros((k, b, 24), np.float32),
        mask_params=np.zeros((k, b, 6), np.float32),
        pdfs=np.zeros((k, b, 8), np.float32),
        surrogates=np.zeros((k, b, 1), np.float32),
        final_image=np.zeros((b, 4, 4, 3), np.float32),
        final_state=states[-1],
    )


def active_mask(traj):
    return np.asarray(Evaluator.active_mask(None, traj))


def test_no_stop_all_active():
    m = active_mask(make_traj([[0], [0], [0]]))
    np.testing.assert_array_equal(m[:, 0], [1, 1, 1])


def test_stop_after_second_step():
    # stopped flag set by step 2 -> step 2 applied, step 3 not
    m = active_mask(make_traj([[0], [1], [1]]))
    np.testing.assert_array_equal(m[:, 0], [1, 1, 0])


def test_stop_at_first_step():
    m = active_mask(make_traj([[1], [1], [1]]))
    np.testing.assert_array_equal(m[:, 0], [1, 0, 0])


def test_per_sample_independent():
    m = active_mask(make_traj([[0, 1], [1, 1], [1, 1]]))
    np.testing.assert_array_equal(m[:, 0], [1, 1, 0])
    np.testing.assert_array_equal(m[:, 1], [1, 0, 0])


def test_applied_counts():
    class FakeEval(Evaluator):
        def __init__(self):
            pass
    traj = make_traj([[0, 1], [1, 1], [1, 1]])
    stopped = traj.states[:, :, STATE_STOPPED_DIM]
    # mirror plan_trajectory's applied computation
    k, b = stopped.shape
    applied = np.full((b,), k, np.int32)
    for i in range(b):
        nz = np.nonzero(stopped[:, i] > 0)[0]
        if len(nz):
            applied[i] = nz[0] + 1
    np.testing.assert_array_equal(applied, [2, 1])
