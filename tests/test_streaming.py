"""Streaming train-step tests: host-supplied fresh data (the path the
native hostloader feeds) on the 8-device CPU mesh, checked for
equivalence of behavior with the device-resident path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from exposure_jax.core.replay import PoolState
from exposure_jax.core.steps import build_streaming_outer_step
from exposure_jax.core.train_state import TrainState, make_optimizer
from exposure_jax.data.synthetic import make_synthetic_pack
from exposure_jax.models import CriticNet, PolicyNet
from exposure_jax.parallel.mesh import DATA_AXIS, data_parallel_mesh
from exposure_jax.utils import load_config
from exposure_jax.utils.ops import STATE_STEP_DIM


@pytest.fixture(scope='module')
def setup():
    cfg = load_config('test')
    mesh = data_parallel_mesh(8)
    filters = [f(cfg) for f in cfg.filters]
    policy = PolicyNet(
        filter_output_dims=tuple(
            f.get_num_filter_parameters() + f.get_num_mask_parameters()
            for f in filters),
        feature_extractor_dims=cfg.feature_extractor_dims,
        base_channels=cfg.base_channels,
        fc1_size=cfg.fc1_size,
        dropout_keep_prob=cfg.dropout_keep_prob)
    critic = CriticNet(cfg.base_channels, cfg.fc1_size)
    value = CriticNet(cfg.base_channels, cfg.fc1_size)
    key = jax.random.PRNGKey(0)
    img = jnp.zeros((2, 64, 64, 3 + cfg.num_state_dim))
    gen = policy.init({'params': key, 'dropout': key}, img)
    crit = critic.init(key, jnp.zeros((2, 64, 64, 3)))
    val = value.init(key, jnp.zeros((2, 64, 64, 3)),
                     jnp.zeros((2, cfg.num_state_dim)))
    tx = make_optimizer()
    state = TrainState.create(gen, val, crit, tx)

    shard = NamedSharding(mesh, P(DATA_AXIS))
    pool_imgs = jax.device_put(
        jnp.asarray(make_synthetic_pack(cfg.replay_memory_size, 64, 'raw',
                                        3)), shard)
    pool = PoolState.create(pool_imgs, cfg.num_state_dim)
    pool = pool.replace(states=jax.device_put(pool.states, shard))
    return cfg, mesh, filters, policy, critic, value, tx, state, pool


def test_streaming_step_runs_and_updates(setup, rng):
    cfg, mesh, filters, policy, critic, value, tx, state, pool = setup
    giters, citers = 2, 2
    step = build_streaming_outer_step(cfg, policy, critic, value, filters,
                                      tx, mesh, giters, citers)
    b, p = cfg.batch_size, cfg.replay_memory_size
    g_fresh = jnp.asarray(
        rng.rand(giters, 2 * b + p, 64, 64, 3).astype(np.float32))
    real = jnp.asarray(
        rng.rand(citers, b, 64, 64, 3).astype(np.float32))
    state2, pool2, metrics = step(state, pool, g_fresh, real,
                                  jax.random.PRNGKey(0),
                                  jnp.float32(1e-4), jnp.float32(1e-4),
                                  jnp.float32(0.0))
    for name, v in metrics._asdict().items():
        assert np.isfinite(np.asarray(v)).all(), name

    def delta(a, b2):
        return sum(float(jnp.abs(x - y).sum()) for x, y in zip(
            jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b2)))
    assert delta(state.gen_params, state2.gen_params) > 0
    assert delta(state.crit_params, state2.crit_params) > 0
    ps = np.asarray(pool2.states)
    assert ps[:, STATE_STEP_DIM].max() >= 1


def test_streaming_fused_match_sequential(setup, rng):
    # One fused N-iteration streaming dispatch must reproduce the
    # Trainer's per-iteration streaming dispatch pair (g-phase call with
    # key fold_in(it_key, 0) + c-phase call with fold_in(it_key, 1))
    # exactly, including RNG folding, on the same data slices.
    cfg, mesh, filters, policy, critic, value, tx, state, pool = setup
    from exposure_jax.core.steps import build_streaming_fused_step
    giters, citers, n = 1, 2, 3
    b, p = cfg.batch_size, cfg.replay_memory_size
    g_all = jnp.asarray(
        rng.rand(n, giters, 2 * b + p, 64, 64, 3).astype(np.float32))
    real_all = jnp.asarray(
        rng.rand(n, citers, b, 64, 64, 3).astype(np.float32))

    g_step = build_streaming_outer_step(cfg, policy, critic, value,
                                        filters, tx, mesh, giters, 0)
    c_step = build_streaming_outer_step(cfg, policy, critic, value,
                                        filters, tx, mesh, 0, citers)
    fused = build_streaming_fused_step(cfg, policy, critic, value,
                                       filters, tx, mesh, giters, citers,
                                       n)

    base = jax.random.PRNGKey(321)
    iters = [5, 6, 7]
    lr_g, lr_c = 1e-4, 2e-4
    empty_real = jnp.zeros((0, b, 64, 64, 3))
    empty_g = jnp.zeros((0, 2 * b + p, 64, 64, 3))

    st, pl = state, pool
    for i, it in enumerate(iters):
        it_key = jax.random.fold_in(base, it)
        prog = jnp.float32(it / cfg.max_iter_step)
        st, pl, _ = g_step(st, pl, g_all[i], empty_real,
                           jax.random.fold_in(it_key, 0),
                           jnp.float32(lr_g), jnp.float32(lr_c), prog)
        st, pl, _ = c_step(st, pl, empty_g, real_all[i],
                           jax.random.fold_in(it_key, 1),
                           jnp.float32(lr_g), jnp.float32(lr_c), prog)

    fst, fpl, fmetrics = fused(
        state, pool, g_all, real_all, base,
        jnp.asarray(iters, jnp.int32),
        jnp.full((n,), lr_g, jnp.float32),
        jnp.full((n,), lr_c, jnp.float32),
        jnp.asarray([i / cfg.max_iter_step for i in iters], jnp.float32))

    for a, b2 in zip(jax.tree_util.tree_leaves(
                         (st.gen_params, st.crit_params, st.val_params)),
                     jax.tree_util.tree_leaves(
                         (fst.gen_params, fst.crit_params,
                          fst.val_params))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b2),
                                   atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(pl.images),
                               np.asarray(fpl.images), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(pl.states),
                                  np.asarray(fpl.states))
    for v in fmetrics._asdict().values():
        assert np.asarray(v).shape == (n,)
        assert np.isfinite(np.asarray(v)).all()


def test_streamed_fresh_data_reaches_pool(setup, rng):
    # mark the streamed fresh crops with a sentinel; after enough
    # g-iterations dropped/thinned slots must contain it
    cfg, mesh, filters, policy, critic, value, tx, state, pool = setup
    giters = 6
    step = build_streaming_outer_step(cfg, policy, critic, value, filters,
                                      tx, mesh, giters, 0)
    b, p = cfg.batch_size, cfg.replay_memory_size
    g_fresh = jnp.full((giters, 2 * b + p, 64, 64, 3), 0.123456)
    real = jnp.zeros((0, b, 64, 64, 3))
    st, pl, _ = step(state, pool, g_fresh, real, jax.random.PRNGKey(1),
                     jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0))
    # run more iterations so trajectories terminate and get dropped
    for i in range(3):
        st, pl, _ = step(st, pl, g_fresh, real, jax.random.fold_in(
            jax.random.PRNGKey(2), i), jnp.float32(0.0), jnp.float32(0.0),
            jnp.float32(0.0))
    imgs = np.asarray(pl.images)
    is_sentinel = np.isclose(imgs, 0.123456).all(axis=(1, 2, 3))
    assert is_sentinel.any(), 'no fresh streamed record entered the pool'


def test_streaming_u8_bundle_matches_dequantized_f32(setup, rng):
    # uint8 bundles are dequantized INSIDE the jit (steps.py
    # _dequant_stream); the u8 call must match an f32 call fed
    # u8*(1/255) host-side to float32 rounding (XLA may fuse the
    # dequant multiply into downstream FMAs, so last-ulp differences
    # are expected but nothing more), and the builder serves both
    # dtypes (jit respecializes per input dtype)
    cfg, mesh, filters, policy, critic, value, tx, state, pool = setup
    giters, citers = 1, 1
    b, p = cfg.batch_size, cfg.replay_memory_size
    step = build_streaming_outer_step(cfg, policy, critic, value,
                                      filters, tx, mesh, giters, citers)
    g_u8 = (rng.rand(giters, 2 * b + p, 64, 64, 3) * 255).astype(np.uint8)
    r_u8 = (rng.rand(citers, b, 64, 64, 3) * 255).astype(np.uint8)
    key = jax.random.PRNGKey(11)
    args = (key, jnp.float32(1e-4), jnp.float32(1e-4), jnp.float32(0.1))

    st8, pl8, m8 = step(state, pool, jnp.asarray(g_u8), jnp.asarray(r_u8),
                        *args)
    stf, plf, mf = step(state, pool,
                        jnp.asarray(g_u8.astype(np.float32)
                                    * np.float32(1.0 / 255.0)),
                        jnp.asarray(r_u8.astype(np.float32)
                                    * np.float32(1.0 / 255.0)),
                        *args)
    for a, b2 in zip(jax.tree_util.tree_leaves(st8.gen_params),
                     jax.tree_util.tree_leaves(stf.gen_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b2),
                                   atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(pl8.images),
                               np.asarray(plf.images), atol=1e-6)
    for v8, vf in zip(m8._asdict().values(), mf._asdict().values()):
        np.testing.assert_allclose(np.asarray(v8), np.asarray(vf),
                                   atol=1e-5, rtol=1e-4)
