"""Invariant tests for the device-resident replay pool (semantics parity
with reference replay_memory.py per SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np

from exposure_jax.core.replay import (
    PoolState,
    reinsert,
    sample_terminated,
    select_generator_batch,
)
from exposure_jax.utils.ops import STATE_STEP_DIM, STATE_STOPPED_DIM

P, B, S, D = 32, 8, 4, 11


def make_pool(finished_idx=()):
    images = jnp.arange(P, dtype=jnp.float32)[:, None, None, None] * \
        jnp.ones((P, S, S, 3))
    pool = PoolState.create(images, D)
    states = pool.states
    for i in finished_idx:
        states = states.at[i, STATE_STOPPED_DIM].set(1.0)
        states = states.at[i, STATE_STEP_DIM].set(5.0)
    return pool.replace(states=states)


def fresh(n, value=-1.0):
    return jnp.full((n, S, S, 3), value)


def test_select_all_unfinished():
    pool = make_pool()
    sel, imgs, states, dropped, _gt = select_generator_batch(
        pool, jax.random.PRNGKey(0), B, fresh(B))
    sel = np.asarray(sel)
    assert len(set(sel.tolist())) == B
    assert not np.asarray(dropped).any()
    # batch images come from the pool, not the fresh substitutes
    assert (np.asarray(imgs) >= 0).all()


def test_select_skips_finished():
    finished = list(range(0, 16))
    pool = make_pool(finished)
    for seed in range(5):
        sel, imgs, states, dropped, _gt = select_generator_batch(
            pool, jax.random.PRNGKey(seed), B, fresh(B))
        sel = np.asarray(sel)
        assert not set(sel.tolist()) & set(finished)
        d = np.asarray(dropped)
        # dropped slots are a subset of the finished ones
        assert set(np.nonzero(d)[0].tolist()) <= set(finished)
        assert (np.asarray(states)[:, STATE_STOPPED_DIM] == 0).all()


def test_select_underfilled_backfills_fresh():
    finished = list(range(P - 4))  # only 4 unfinished
    pool = make_pool(finished)
    sel, imgs, states, dropped, _gt = select_generator_batch(
        pool, jax.random.PRNGKey(0), B, fresh(B))
    imgs = np.asarray(imgs)
    # exactly B-4 batch rows must be fresh substitutes (value -1)
    n_fresh = int((imgs.reshape(B, -1).mean(1) < 0).sum())
    assert n_fresh == B - 4
    assert (np.asarray(states)[:, STATE_STOPPED_DIM] == 0).all()


def test_reinsert_writes_back_and_replaces_dropped():
    pool = make_pool([3])
    key = jax.random.PRNGKey(0)
    sel, imgs, states, dropped, _gt = select_generator_batch(pool, key, B,
                                                        fresh(B))
    new_states = np.asarray(states).copy()
    new_states[:, STATE_STEP_DIM] += 1
    new_images = jnp.asarray(np.asarray(imgs) + 100.0)
    pool2 = reinsert(pool, jax.random.PRNGKey(1), sel, new_images,
                     jnp.asarray(new_states), dropped,
                     fresh(B, -2.0), fresh(P, -3.0),
                     maximum_trajectory_length=7, over_length_keep_prob=0.5)
    p_imgs = np.asarray(pool2.images)
    p_states = np.asarray(pool2.states)
    for i, idx in enumerate(np.asarray(sel)):
        assert p_imgs[idx].mean() >= 100.0 - 1
        assert p_states[idx, STATE_STEP_DIM] == 1
    for idx in np.nonzero(np.asarray(dropped))[0]:
        assert p_imgs[idx].mean() == -3.0
        assert p_states[idx, STATE_STEP_DIM] == 0


def test_reinsert_overlength_thinning():
    pool = make_pool()
    sel = jnp.arange(B)
    over = jnp.zeros((B, D)).at[:, STATE_STEP_DIM].set(8.0)  # > max 7
    keeps = []
    for seed in range(40):
        pool2 = reinsert(pool, jax.random.PRNGKey(seed), sel,
                         fresh(B, 50.0), over,
                         jnp.zeros((P,), bool), fresh(B, -2.0),
                         fresh(P, -3.0), maximum_trajectory_length=7,
                         over_length_keep_prob=0.5)
        kept = (np.asarray(pool2.images[:B]).reshape(B, -1).mean(1)
                == 50.0)
        keeps.append(kept.mean())
    frac = float(np.mean(keeps))
    assert 0.3 < frac < 0.7  # ~ keep_prob 0.5


def test_sample_terminated_only_picks_terminated():
    finished = [2, 7, 19]
    pool = make_pool(finished)
    imgs, idx = sample_terminated(pool, jax.random.PRNGKey(0), 16)
    assert set(np.asarray(idx).tolist()) <= set(finished)
    # with replacement: 16 samples from 3 slots must repeat
    assert len(np.asarray(idx)) == 16
