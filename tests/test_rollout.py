"""Rollout tests: on-device K-step trajectory scan invariants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exposure_jax.core.rollout import rollout
from exposure_jax.core.trainer import build_models, init_train_state
from exposure_jax.utils import load_config
from exposure_jax.utils.ops import (
    STATE_STEP_DIM,
    STATE_STOPPED_DIM,
)


@pytest.fixture(scope='module')
def setup():
    cfg = load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    return cfg, filters, policy, state


def test_trajectory_shapes_and_state_progression(setup, rng):
    cfg, filters, policy, state = setup
    imgs = jnp.asarray(rng.rand(3, 64, 64, 3).astype(np.float32) * 0.5)
    traj = rollout(policy, state.gen_params, imgs, jax.random.PRNGKey(0),
                   cfg=cfg, filters=filters, is_train=0)
    k = cfg.test_steps
    assert traj.images.shape == (k, 3, 64, 64, 3)
    assert traj.filter_ids.shape == (k, 3)
    # step counter advances 1..k
    steps = np.asarray(traj.states[:, :, STATE_STEP_DIM])
    np.testing.assert_array_equal(steps[:, 0], np.arange(1, k + 1))
    # terminal flag only at the final step (this release stops exactly
    # at test_steps)
    stopped = np.asarray(traj.states[:, :, STATE_STOPPED_DIM])
    np.testing.assert_array_equal(stopped[:-1].ravel(),
                                  np.zeros((k - 1) * 3))
    np.testing.assert_array_equal(stopped[-1], np.ones(3))
    # final image equals the last per-step image
    np.testing.assert_allclose(np.asarray(traj.final_image),
                               np.asarray(traj.images[-1]))


def test_rollout_respects_num_steps(setup, rng):
    cfg, filters, policy, state = setup
    imgs = jnp.asarray(rng.rand(2, 64, 64, 3).astype(np.float32))
    traj = rollout(policy, state.gen_params, imgs, jax.random.PRNGKey(0),
                   cfg=cfg, filters=filters, num_steps=2)
    assert traj.images.shape[0] == 2


def test_rollout_is_reproducible(setup, rng):
    cfg, filters, policy, state = setup
    imgs = jnp.asarray(rng.rand(2, 64, 64, 3).astype(np.float32))
    t1 = rollout(policy, state.gen_params, imgs, jax.random.PRNGKey(5),
                 cfg=cfg, filters=filters, is_train=0)
    t2 = rollout(policy, state.gen_params, imgs, jax.random.PRNGKey(5),
                 cfg=cfg, filters=filters, is_train=0)
    np.testing.assert_array_equal(np.asarray(t1.filter_ids),
                                  np.asarray(t2.filter_ids))
    np.testing.assert_allclose(np.asarray(t1.final_image),
                               np.asarray(t2.final_image))
