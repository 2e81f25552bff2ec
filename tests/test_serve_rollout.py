"""serve_rollout: the selected-branch-only serving plan.

The training rollout applies ALL K filters per step and blends by the
one-hot selection (the differentiable formulation, reference
agent.py:58-77,124-125); ``serve_rollout`` regresses every parameter
head but advances the proxy through the SELECTED filter only, via the
chain replay (here the Pallas kernel in interpret mode).  These tests
pin the parity contract:

- step-0 actions/params are bit-identical to ``rollout(is_train=0)``
  (same input proxy -> same CNN -> same pdf -> same argmax);
- later steps may diverge ONLY where the reference path's top-2 pdf
  margin is within the kernel-vs-jnp proxy tolerance;
- the packed params layout matches what the replay kernels consume.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exposure_jax.core.rollout import rollout, serve_rollout
from exposure_jax.core.serving import RetouchPipeline
from exposure_jax.core.trainer import build_models, init_train_state
from exposure_jax.ops.chain import replay_filter_chain
from exposure_jax.ops.pallas_chain import select_chain_replay
from exposure_jax.utils import load_config

def kernel_pipeline(cfg, state):
    """A pipeline replaying through the kernel in interpret mode."""
    pipe = RetouchPipeline(cfg, state)
    pipe.replay = select_chain_replay(interpret=True)
    return pipe



@pytest.fixture(scope='module')
def setup():
    cfg = load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    return cfg, filters, policy, state


def _plans(setup, batch=6, seed=0):
    cfg, filters, policy, state = setup
    rng = np.random.RandomState(seed)
    proxy = jnp.asarray(
        rng.rand(batch, cfg.source_img_size, cfg.source_img_size, 3)
        .astype(np.float32))
    key = jax.random.PRNGKey(seed)
    traj = rollout(policy, state.gen_params, proxy, key, cfg=cfg,
                   filters=filters, is_train=0)
    ids, params, mask = serve_rollout(
        policy, state.gen_params, proxy, key, cfg=cfg, filters=filters,
        replay=select_chain_replay(interpret=True))
    return traj, np.asarray(ids), np.asarray(params), np.asarray(mask)


def test_step0_bit_identical(setup):
    # same input proxy, same dropout key -> identical pdf -> identical
    # argmax and regressed params at step 0
    traj, ids, params, mask = _plans(setup)
    np.testing.assert_array_equal(
        ids[0], np.asarray(traj.filter_ids)[0])
    np.testing.assert_allclose(
        params[0], np.asarray(traj.params)[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        mask[0], np.asarray(traj.mask_params)[0], rtol=0, atol=1e-6)


def test_divergence_only_at_near_ties(setup):
    # id flips vs the bank-blend reference may happen only where the
    # reference pdf's top-2 margin is tiny (the proxies differ by the
    # kernel-vs-jnp tolerance); a flip at a CONFIDENT margin would mean
    # a real bug, and once a record flips, its later steps are excused
    # (the trajectories legitimately diverge from that point).
    traj, ids, params, _ = _plans(setup, batch=8, seed=1)
    ref_ids = np.asarray(traj.filter_ids)
    pdfs = np.asarray(traj.pdfs, np.float32)
    k_steps, batch = ref_ids.shape
    diverged = np.zeros(batch, bool)
    for k in range(k_steps):
        top2 = np.sort(pdfs[k], axis=1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        flip = ids[k] != ref_ids[k]
        fresh_confident_flip = flip & ~diverged & (margin > 1e-3)
        assert not fresh_confident_flip.any(), (
            'serve_rollout flipped a confident action at step %d '
            '(margins %r)' % (k, margin[flip & ~diverged]))
        diverged |= flip
    # params must match the reference wherever the trajectory prefix
    # never diverged (flipped rows legitimately carry different params)
    live = ~diverged
    assert live.any(), 'every record diverged: plan parity is broken'
    np.testing.assert_allclose(params[:, live],
                               np.asarray(traj.params)[:, live],
                               rtol=0, atol=1e-5)


def test_pipeline_selected_plan_end_to_end(setup):
    cfg, filters, policy, state = setup
    pipe = kernel_pipeline(cfg, state)
    rng = np.random.RandomState(2)
    imgs = (rng.rand(2, 64, 128, 3) * 255).astype(np.uint8)
    out = pipe(imgs, seed=3)
    assert out.shape == imgs.shape and out.dtype == np.uint8
    # deterministic under the same seed
    np.testing.assert_array_equal(out, pipe(imgs, seed=3))


def test_selected_plan_output_near_bank_plan(setup):
    # end-to-end outputs of the selected plan and the training rollout's
    # bank plan agree wherever no action flipped; rows that flipped are
    # equally valid trajectories (near-tie argmax), bounded in number by
    # the near-tie measure
    cfg, filters, policy, state = setup
    rng = np.random.RandomState(3)
    imgs = (rng.rand(4, 64, 128, 3) * 255).astype(np.uint8)
    pipe = kernel_pipeline(cfg, state)
    a = pipe(imgs, seed=4)
    key = jax.random.fold_in(jax.random.PRNGKey(4), 0)
    proxy = jax.image.resize(
        jnp.asarray(imgs).astype(jnp.float32) / 255.0,
        (4, cfg.source_img_size, cfg.source_img_size, 3), 'linear')
    traj = rollout(policy, state.gen_params, proxy, key, cfg=cfg,
                   filters=filters, is_train=0)
    b = np.asarray(replay_filter_chain(jnp.asarray(imgs), traj.filter_ids,
                                       traj.params, filters))
    row_close = np.array([
        np.abs(a[i].astype(np.int32) - b[i].astype(np.int32)).max() <= 2
        for i in range(a.shape[0])])
    assert row_close.any(), 'every row flipped: plan parity is broken'
