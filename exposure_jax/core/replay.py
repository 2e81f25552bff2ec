"""Device-resident replay pool.

The reference keeps a host-side list of 128 numpy records and re-feeds
them through placeholders every step (replay_memory.py:8-282).  Here the
pool is a fixed-shape array pytree living in HBM, and every pool operation
is a pure jittable function, so the whole select -> agent-step -> reinsert
cycle runs on device with zero host traffic.

Semantics parity (slot-exact emulation of the reference's scan):

- ``select_generator_batch`` reproduces ``get_next_fake_batch``
  (replay_memory.py:230-246): shuffle the pool (= assign random ranks),
  walk in order collecting UNFINISHED records until batch_size; finished
  records encountered during the walk are dropped from the pool (they are
  replaced by fresh RAW on reinsert, which is what ``fill_pool`` does).
  If fewer than batch_size unfinished records exist, the remainder of the
  batch is filled with fresh RAW + initial state (= fill_pool then use).
- ``reinsert`` reproduces ``replace_memory`` (replay_memory.py:186-196):
  the stepped outputs go back into the selected slots; over-length
  trajectories survive only with probability ``over_length_keep_prob``,
  otherwise a fresh RAW record takes the slot.
- ``sample_terminated`` reproduces ``replay_fake_batch``
  (replay_memory.py:249-273): the critic trains on terminated records
  only, sampled with replacement (the reference cycles over the pool
  collecting duplicates).  If a shard has no terminated record yet the
  sampling falls back to uniform (the reference asserts instead; the
  warmup schedule makes this unreachable in practice).
"""

from typing import Any

import jax
import jax.numpy as jnp

from exposure_jax.core.train_state import pytree_dataclass
from exposure_jax.utils.ops import STATE_STEP_DIM, STATE_STOPPED_DIM


@pytree_dataclass
class PoolState:
    images: Any  # [P, S, S, C]
    states: Any  # [P, D]
    # paired ground truth for supervised mode (reference
    # replay_memory.py:23-27, 124-127); None when unsupervised
    ground_truth: Any = None

    @classmethod
    def create(cls, images, num_state_dim, ground_truth=None):
        p = images.shape[0]
        return cls(images=images,
                   states=jnp.zeros((p, num_state_dim), images.dtype),
                   ground_truth=ground_truth)

    @property
    def size(self):
        return self.images.shape[0]

    def terminated_mask(self):
        return self.states[:, STATE_STOPPED_DIM] > 0

    def average_trajectory(self):
        return jnp.mean(self.states[:, STATE_STEP_DIM])


def select_generator_batch(pool: PoolState, key, batch_size: int,
                           fresh_images, fresh_gt=None):
    """Pick ``batch_size`` unfinished records (dropping scanned-over
    finished ones), backfilling with fresh RAW when short.

    Args:
      pool: current pool.
      key: PRNG key.
      batch_size: static batch size (<= pool size).
      fresh_images: [batch_size, S, S, C] fresh RAW used when the pool has
        fewer than batch_size unfinished records.
      fresh_gt: optional paired ground truth for the fresh images
        (supervised mode).

    Returns:
      (sel_idx [B] int32, batch_images, batch_states, dropped_mask [P],
       batch_gt or None)
    """
    p = pool.size
    r = jax.random.uniform(key, (p,))
    unfinished = jnp.logical_not(pool.terminated_mask())
    # Finished slots rank strictly after every unfinished slot.
    rank = jnp.where(unfinished, r, r + 10.0)
    order = jnp.argsort(rank)
    sel_idx = order[:batch_size]
    threshold = rank[sel_idx[-1]]
    # Finished records "scanned over" before the walk collected its batch.
    dropped = jnp.logical_and(jnp.logical_not(unfinished), r < threshold)
    # Selected slots are rewritten by reinsert; never double-replace them.
    selected_mask = jnp.zeros((p,), bool).at[sel_idx].set(True)
    dropped = jnp.logical_and(dropped, jnp.logical_not(selected_mask))

    batch_images = jnp.take(pool.images, sel_idx, axis=0)
    batch_states = jnp.take(pool.states, sel_idx, axis=0)
    sel_finished = jnp.logical_not(jnp.take(unfinished, sel_idx, axis=0))
    batch_images = jnp.where(sel_finished[:, None, None, None], fresh_images,
                             batch_images)
    batch_states = jnp.where(sel_finished[:, None],
                             jnp.zeros_like(batch_states), batch_states)
    if pool.ground_truth is not None:
        batch_gt = jnp.take(pool.ground_truth, sel_idx, axis=0)
        if fresh_gt is not None:
            batch_gt = jnp.where(sel_finished[:, None, None, None],
                                 fresh_gt, batch_gt)
    else:
        batch_gt = None
    return sel_idx, batch_images, batch_states, dropped, batch_gt


def reinsert(pool: PoolState, key, sel_idx, new_images, new_states,
             dropped_mask, fresh_for_batch, fresh_for_pool,
             maximum_trajectory_length, over_length_keep_prob,
             batch_gt=None, fresh_gt_for_batch=None,
             fresh_gt_for_pool=None):
    """Write stepped records back, applying over-length thinning and
    replacing dropped slots with fresh RAW.  In supervised mode the
    paired ground truth follows its record (kept when the record is kept,
    replaced by the fresh pair otherwise)."""
    b = sel_idx.shape[0]
    keep = jnp.logical_or(
        new_states[:, STATE_STEP_DIM] < maximum_trajectory_length,
        jax.random.bernoulli(key, over_length_keep_prob, (b,)))
    rec_images = jnp.where(keep[:, None, None, None], new_images,
                           fresh_for_batch)
    rec_states = jnp.where(keep[:, None], new_states,
                           jnp.zeros_like(new_states))
    images = pool.images.at[sel_idx].set(rec_images)
    states = pool.states.at[sel_idx].set(rec_states)
    images = jnp.where(dropped_mask[:, None, None, None], fresh_for_pool,
                       images)
    states = jnp.where(dropped_mask[:, None], jnp.zeros_like(states), states)
    ground_truth = pool.ground_truth
    if ground_truth is not None:
        rec_gt = jnp.where(keep[:, None, None, None], batch_gt,
                           fresh_gt_for_batch)
        ground_truth = ground_truth.at[sel_idx].set(rec_gt)
        ground_truth = jnp.where(dropped_mask[:, None, None, None],
                                 fresh_gt_for_pool, ground_truth)
    return PoolState(images=images, states=states,
                     ground_truth=ground_truth)


def sample_terminated(pool: PoolState, key, batch_size: int):
    """Sample terminated records with replacement for critic training."""
    terminated = pool.terminated_mask()
    logits = jnp.where(terminated, 0.0, -1e9)
    idx = jax.random.categorical(key, logits, shape=(batch_size,))
    return jnp.take(pool.images, idx, axis=0), idx
