"""Loss-function tests: hand-computed miniatures for reward/TD/WGAN-GP
values and — critically — the gradient partitioning between the three
optimizers (SURVEY.md §7 'hard parts'):

- generator gradients flow through critic/value ACTIVATIONS but not into
  their parameters;
- value gradients see only the TD regression (no leakage from the
  generator's -q routine term);
- the discrete selection trains only via the surrogate term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exposure_jax.core.losses import critic_loss, generator_value_loss
from exposure_jax.models import CriticNet, PolicyNet
from exposure_jax.utils import load_config
from exposure_jax.utils.ops import STATE_STEP_DIM


@pytest.fixture(scope='module')
def setup():
    cfg = load_config('test')
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
    plain = jnp.zeros((2, 64, 64, 3))
    crit_params = critic.init(key, plain)
    val_params = value.init(key, plain, jnp.zeros((2, cfg.num_state_dim)))
    return cfg, filters, policy, critic, value, gen_params, crit_params, \
        val_params


def _loss_args(setup, rng, batch=2):
    cfg, filters, policy, critic, value, gen, crit, val = setup
    img = jnp.asarray(rng.rand(batch, 64, 64, 3).astype(np.float32) * 0.5)
    states = jnp.zeros((batch, cfg.num_state_dim))
    return cfg, filters, policy, critic, value, gen, crit, val, img, states


class TestGeneratorValueLoss:
    def test_td_identities(self, setup, rng):
        cfg, filters, policy, critic, value, gen, crit, val, img, states = \
            _loss_args(setup, rng)
        (total, aux) = generator_value_loss(
            {'gen': gen, 'val': val}, crit, policy, critic, value, img,
            states, jax.random.PRNGKey(1), jnp.int32(1), 0.3, cfg, filters)
        # v_loss = mean(advantage^2)
        np.testing.assert_allclose(
            float(aux.v_loss), float(jnp.mean(aux.advantage ** 2)),
            rtol=1e-5)
        assert float(total) == pytest.approx(
            float(aux.g_loss + aux.v_loss), rel=1e-5)
        # non-terminal first step: q = reward + V(s') (gamma=1)
        old_v = value.apply(val, img, states)
        adv_manual = np.asarray(aux.q_value) - np.asarray(old_v)
        np.testing.assert_allclose(np.asarray(aux.advantage), adv_manual,
                                   rtol=1e-4, atol=1e-5)

    def test_terminal_step_has_no_future_value(self, setup, rng):
        cfg, filters, policy, critic, value, gen, crit, val, img, states = \
            _loss_args(setup, rng)
        states = states.at[:, STATE_STEP_DIM].set(cfg.test_steps - 1)
        _, aux = generator_value_loss(
            {'gen': gen, 'val': val}, crit, policy, critic, value, img,
            states, jax.random.PRNGKey(1), jnp.int32(1), 0.3, cfg, filters)
        # stopped=1 -> q == reward exactly
        np.testing.assert_allclose(np.asarray(aux.q_value),
                                   np.asarray(aux.reward), rtol=1e-5)

    def test_gradient_partitioning(self, setup, rng):
        cfg, filters, policy, critic, value, gen, crit, val, img, states = \
            _loss_args(setup, rng)
        key = jax.random.PRNGKey(2)

        grads = jax.grad(
            lambda p: generator_value_loss(
                p, crit, policy, critic, value, img, states, key,
                jnp.int32(1), 0.3, cfg, filters)[0])({'gen': gen,
                                                      'val': val})
        # value grads must equal grads of v_loss alone: the generator's
        # -q routine term must NOT leak into theta_v (reference keeps
        # separate variable scopes, net.py:205-210).
        grads_v_only = jax.grad(
            lambda v: generator_value_loss(
                {'gen': gen, 'val': v}, crit, policy, critic, value, img,
                states, key, jnp.int32(1), 0.3, cfg, filters)[1].v_loss)(val)
        for a, b in zip(jax.tree_util.tree_leaves(grads['val']),
                        jax.tree_util.tree_leaves(grads_v_only)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-7)
        # generator grads exist and are finite
        g_leaves = jax.tree_util.tree_leaves(grads['gen'])
        total_mag = sum(float(jnp.abs(g).sum()) for g in g_leaves)
        assert np.isfinite(total_mag) and total_mag > 0

    def test_pathwise_reward_gradient_through_critic(self, setup, rng):
        # With use_TD off and penalties off, g_loss = mean(-reward +
        # surrogate*sg(-reward)); the pathwise part must differentiate
        # through the critic's activations into the generator.
        cfg, filters, policy, critic, value, gen, crit, val, img, states = \
            _loss_args(setup, rng)
        cfg = cfg.copy()
        cfg.use_TD = False
        cfg.use_penalty = False
        grads = jax.grad(
            lambda p: generator_value_loss(
                p, crit, policy, critic, value, img, states,
                jax.random.PRNGKey(2), jnp.int32(1), 0.3, cfg,
                filters)[0])({'gen': gen, 'val': val})
        mag = sum(float(jnp.abs(g).sum())
                  for g in jax.tree_util.tree_leaves(grads['gen']))
        assert mag > 0


class TestCriticLoss:
    def test_wgan_values(self, setup, rng):
        cfg, filters, policy, critic, value, gen, crit, val, img, states = \
            _loss_args(setup, rng)
        fake = jnp.asarray(rng.rand(2, 64, 64, 3).astype(np.float32))
        loss, aux = critic_loss(crit, critic, img, fake,
                                jax.random.PRNGKey(0), cfg)
        fake_l = critic.apply(crit, fake)
        real_l = critic.apply(crit, img)
        emd_manual = float(jnp.mean(real_l) - jnp.mean(fake_l))
        assert float(aux.emd) == pytest.approx(emd_manual, rel=1e-4,
                                               abs=1e-6)
        # c_loss includes the one-sided GP
        assert float(loss) == pytest.approx(
            -emd_manual + float(aux.gradient_penalty), rel=1e-4, abs=1e-6)
        assert float(aux.gradient_penalty) >= 0
        assert float(aux.critic_gradient_norm) > 0
        assert float(aux.c_average) == pytest.approx(
            float(jnp.mean(fake_l + real_l) * 0.5), rel=1e-4, abs=1e-6)

    def test_lsgan_values(self, setup, rng):
        cfg, filters, policy, critic, value, gen, crit, val, img, states = \
            _loss_args(setup, rng)
        cfg = cfg.copy()
        cfg.gan = 'ls'
        fake = jnp.asarray(rng.rand(2, 64, 64, 3).astype(np.float32))
        loss, aux = critic_loss(crit, critic, img, fake,
                                jax.random.PRNGKey(0), cfg)
        fake_l = critic.apply(crit, fake)
        real_l = critic.apply(crit, img)
        expected = float(jnp.mean(fake_l ** 2) +
                         jnp.mean((real_l - 1) ** 2))
        assert float(loss) == pytest.approx(expected, rel=1e-4)
        assert float(aux.c_average) == 0.0

    def test_critic_grads_flow(self, setup, rng):
        cfg, filters, policy, critic, value, gen, crit, val, img, states = \
            _loss_args(setup, rng)
        fake = jnp.asarray(rng.rand(2, 64, 64, 3).astype(np.float32))
        grads = jax.grad(lambda p: critic_loss(
            p, critic, img, fake, jax.random.PRNGKey(0), cfg)[0])(crit)
        mag = sum(float(jnp.abs(g).sum())
                  for g in jax.tree_util.tree_leaves(grads))
        assert np.isfinite(mag) and mag > 0
