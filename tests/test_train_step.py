"""End-to-end outer-step tests on an 8-device CPU mesh: the full
generator+value+critic iteration compiles, runs, updates parameters, and
keeps the replay pool coherent."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from exposure_jax.core.replay import PoolState
from exposure_jax.core.steps import build_outer_step
from exposure_jax.core.train_state import TrainState, make_optimizer
from exposure_jax.data.synthetic import make_synthetic_pack
from exposure_jax.models import CriticNet, PolicyNet
from exposure_jax.parallel.mesh import DATA_AXIS, data_parallel_mesh
from exposure_jax.utils import load_config
from exposure_jax.utils.ops import STATE_STEP_DIM, STATE_STOPPED_DIM


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
    gen_params = policy.init({'params': key, 'dropout': key}, img)
    crit_params = critic.init(key, jnp.zeros((2, 64, 64, 3)))
    val_params = value.init(key, jnp.zeros((2, 64, 64, 3)),
                            jnp.zeros((2, cfg.num_state_dim)))
    tx = make_optimizer(cfg.adam_beta1, cfg.adam_beta2)
    state = TrainState.create(gen_params, val_params, crit_params, tx)

    fake_pack = jnp.asarray(make_synthetic_pack(64, 80, 'raw', 0))
    real_pack = jnp.asarray(make_synthetic_pack(64, 64, 'retouched', 2))
    shard = NamedSharding(mesh, P(DATA_AXIS))
    fake_pack = jax.device_put(fake_pack, shard)
    real_pack = jax.device_put(real_pack, shard)

    pool_images = jax.device_put(
        jnp.asarray(make_synthetic_pack(cfg.replay_memory_size, 80, 'raw',
                                        7))[:, 8:72, 8:72], shard)
    pool = PoolState.create(pool_images, cfg.num_state_dim)
    pool = pool.replace(states=jax.device_put(pool.states, shard))

    step = build_outer_step(cfg, policy, critic, value, filters, tx, mesh,
                            fake_meta=(64, True), real_meta=(64, True),
                            giters=2, citers=2)
    return cfg, state, pool, fake_pack, real_pack, step


def test_outer_step_runs_and_updates(setup):
    cfg, state, pool, fake_pack, real_pack, step = setup
    key = jax.random.PRNGKey(42)
    state2, pool2, metrics = step(state, pool, fake_pack, real_pack, key,
                                  jnp.float32(1e-4), jnp.float32(1e-4),
                                  jnp.float32(0.0))
    for name, v in metrics._asdict().items():
        assert np.isfinite(np.asarray(v)).all(), name
    # parameters must have moved
    def delta(a, b):
        return sum(float(jnp.abs(x - y).sum()) for x, y in zip(
            jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))
    assert delta(state.gen_params, state2.gen_params) > 0
    assert delta(state.crit_params, state2.crit_params) > 0
    assert delta(state.val_params, state2.val_params) > 0
    # pool states coherent
    ps = np.asarray(pool2.states)
    assert (ps[:, STATE_STEP_DIM] >= 0).all()
    assert (ps[:, STATE_STEP_DIM] <= cfg.maximum_trajectory_length + 1).all()
    # the outer-iteration counter is owned by the Trainer, not the step
    assert int(state2.step) == int(state.step)


def test_pool_advances_and_terminates(setup):
    cfg, state, pool, fake_pack, real_pack, step = setup
    key = jax.random.PRNGKey(7)
    for i in range(6):
        state, pool, metrics = step(state, pool, fake_pack, real_pack,
                                    jax.random.fold_in(key, i),
                                    jnp.float32(0.0), jnp.float32(0.0),
                                    jnp.float32(0.0))
    ps = np.asarray(pool.states)
    # after 12 generator updates on a 32-slot pool (batch 16), trajectories
    # must have advanced and some must have terminated
    assert ps[:, STATE_STEP_DIM].max() >= cfg.test_steps
    assert (ps[:, STATE_STOPPED_DIM] > 0).any()
    assert float(np.asarray(metrics.pool_avg_trajectory)) > 0.5


def test_weight_clipping_fallback(setup):
    # gan='w' with gradient_penalty_lambda<=0 clamps critic weights to
    # +-clamp_critic after each update (reference net.py:253-266)
    cfg, state, pool, fake_pack, real_pack, _ = setup
    from exposure_jax.core.steps import build_outer_step
    from exposure_jax.core.train_state import make_optimizer
    from exposure_jax.core.trainer import build_models
    from exposure_jax.parallel.mesh import data_parallel_mesh
    cfg2 = cfg.copy()
    cfg2.gradient_penalty_lambda = 0
    cfg2.clamp_critic = 0.01
    mesh = data_parallel_mesh(8)
    filters, policy, critic, value = build_models(cfg2)
    tx = make_optimizer()
    step = build_outer_step(cfg2, policy, critic, value, filters, tx,
                            mesh, (64, True), (64, True), giters=1,
                            citers=1)
    state2, _, _ = step(state, pool, fake_pack, real_pack,
                        jax.random.PRNGKey(0), jnp.float32(1e-4),
                        jnp.float32(1e-2), jnp.float32(0.0))
    for leaf in jax.tree_util.tree_leaves(state2.crit_params):
        assert float(jnp.abs(leaf).max()) <= 0.01 + 1e-6


def test_citers_zero_leaves_critic_and_ema(setup):
    # a generator-only phase (citers=0, as composed by the Trainer and as
    # supervised mode always runs) must not touch the critic or its EMA
    cfg, state, pool, fake_pack, real_pack, _ = setup
    from exposure_jax.core.trainer import build_models
    filters, policy, critic, value = build_models(cfg)
    tx = make_optimizer(cfg.adam_beta1, cfg.adam_beta2)
    mesh = data_parallel_mesh(8)
    step = build_outer_step(cfg, policy, critic, value, filters, tx, mesh,
                            (64, True), (64, True), giters=1, citers=0)
    state2, _, metrics = step(state, pool, fake_pack, real_pack,
                              jax.random.PRNGKey(0), jnp.float32(1e-4),
                              jnp.float32(1e-2), jnp.float32(0.0))
    for a, b in zip(jax.tree_util.tree_leaves(state.crit_params),
                    jax.tree_util.tree_leaves(state2.crit_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(state2.ema.count) == int(state.ema.count)
    assert float(metrics.emd) == 0.0
    assert float(metrics.critic_gradient_norm) == 0.0


def test_ema_zero_debias():
    # tf.train.ExponentialMovingAverage(0.99, zero_debias=True) parity
    # (reference net.py:119-120): value 0 before any update; after one
    # update the debiased value equals the raw observation.
    from exposure_jax.core.train_state import EmaState
    ema = EmaState.create()
    assert float(ema.value) == 0.0
    ema1 = ema.update(jnp.float32(5.0))
    np.testing.assert_allclose(float(ema1.value), 5.0, rtol=1e-5)
    ema2 = ema1.update(jnp.float32(3.0))
    expected = (0.05 * 0.99 + 0.01 * 3.0) / (1 - 0.99 ** 2)
    np.testing.assert_allclose(float(ema2.value), expected, rtol=1e-5)


def test_pool_health_warning():
    from exposure_jax.core.trainer import pool_health_warning
    assert pool_health_warning(5, False, 0.0) is not None
    assert pool_health_warning(0, False, 0.0) is None  # no critic phase
    assert pool_health_warning(5, True, 0.0) is None   # supervised
    assert pool_health_warning(5, False, 0.25) is None


def test_lr_zero_keeps_params(setup):
    cfg, state, pool, fake_pack, real_pack, step = setup
    state2, pool2, _ = step(state, pool, fake_pack, real_pack,
                            jax.random.PRNGKey(0), jnp.float32(0.0),
                            jnp.float32(0.0), jnp.float32(0.0))
    for a, b in zip(jax.tree_util.tree_leaves(state.gen_params),
                    jax.tree_util.tree_leaves(state2.gen_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fused_iterations_match_sequential(setup):
    # One fused N-iteration dispatch must reproduce the Trainer's
    # per-iteration dispatch pair (g-phase call + c-phase call) exactly,
    # including the RNG folding.
    cfg, state, pool, fake_pack, real_pack, _ = setup
    from exposure_jax.core.steps import build_fused_iterations_step
    from exposure_jax.core.trainer import build_models
    filters, policy, critic, value = build_models(cfg)
    tx = make_optimizer(cfg.adam_beta1, cfg.adam_beta2)
    mesh = data_parallel_mesh(8)

    g_step = build_outer_step(cfg, policy, critic, value, filters, tx,
                              mesh, (64, True), (64, True), giters=1,
                              citers=0)
    c_step = build_outer_step(cfg, policy, critic, value, filters, tx,
                              mesh, (64, True), (64, True), giters=0,
                              citers=2)
    fused = build_fused_iterations_step(cfg, policy, critic, value,
                                        filters, tx, mesh, (64, True),
                                        (64, True), giters=1, citers=2,
                                        n_iters=3)

    base = jax.random.PRNGKey(123)
    iters = [5, 6, 7]
    lr_g, lr_c = 1e-4, 2e-4

    st, pl = state, pool
    for it in iters:
        it_key = jax.random.fold_in(base, it)
        prog = jnp.float32(it / cfg.max_iter_step)
        st, pl, _ = g_step(st, pl, fake_pack, real_pack,
                           jax.random.fold_in(it_key, 0),
                           jnp.float32(lr_g), jnp.float32(lr_c), prog)
        st, pl, _ = c_step(st, pl, fake_pack, real_pack,
                           jax.random.fold_in(it_key, 1),
                           jnp.float32(lr_g), jnp.float32(lr_c), prog)

    fst, fpl, fmetrics = fused(
        state, pool, fake_pack, real_pack, base,
        jnp.asarray(iters, jnp.int32),
        jnp.full((3,), lr_g, jnp.float32),
        jnp.full((3,), lr_c, jnp.float32),
        jnp.asarray([i / cfg.max_iter_step for i in iters], jnp.float32))

    for a, b in zip(jax.tree_util.tree_leaves(
                        (st.gen_params, st.crit_params, st.val_params)),
                    jax.tree_util.tree_leaves(
                        (fst.gen_params, fst.crit_params,
                         fst.val_params))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(pl.images),
                               np.asarray(fpl.images), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(pl.states),
                                  np.asarray(fpl.states))
    # metrics are stacked per iteration: one fetch covers the whole
    # chunk's logging cadence
    for v in fmetrics._asdict().values():
        assert np.asarray(v).shape == (3,)
        assert np.isfinite(np.asarray(v)).all()


def test_plan_fused_chunk():
    from exposure_jax.core.trainer import plan_fused_chunk
    cfg = load_config('test').copy()
    cfg.max_iter_step = 20000
    cfg.critic_initialization = 10
    cfg.checkpoint_interval = 500
    cfg.write_image_interval = 400
    # warmup and bursts are never fused
    assert plan_fused_chunk(0, cfg, 10, False) == 1
    assert plan_fused_chunk(5, cfg, 10, False) == 1    # < critic_init
    assert plan_fused_chunk(500, cfg, 10, False) == 1  # burst
    # plain stretches take the full budget (metrics are stacked per
    # iteration, so chunks may cross 10-iter logging boundaries)
    assert plan_fused_chunk(11, cfg, 10, False) == 10  # [11..20]
    assert plan_fused_chunk(21, cfg, 10, False) == 10
    assert plan_fused_chunk(15, cfg, 10, False) == 10  # [15..24]
    assert plan_fused_chunk(11, cfg, 100, False) == 100  # [11..110]
    # stop exactly ON checkpoint iterations ((it+1) % 500 == 0)
    assert plan_fused_chunk(491, cfg, 10, False) == 9  # [491..499]
    assert plan_fused_chunk(401, cfg, 100, False) == 99  # [401..499]
    # stop exactly ON visualization iterations (j % wii == 0)
    assert plan_fused_chunk(395, cfg, 10, False) == 6  # [395..400]
    assert plan_fused_chunk(301, cfg, 100, False) == 100  # [301..400]
    # never cross a burst
    assert plan_fused_chunk(995, cfg, 10, False) == 5  # [995..999]
    # n_fuse=1 degenerates to the single path
    assert plan_fused_chunk(11, cfg, 1, False) == 1
