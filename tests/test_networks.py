"""Shape and behavior tests for the policy / critic networks and the agent
step (state machine, selection semantics, packed-trajectory consistency)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exposure_jax.models import (
    CriticNet,
    PolicyNet,
    agent_step,
    enrich_image_input,
    initial_states,
)
from exposure_jax.models.networks import critic_stats
from exposure_jax.utils import load_config
from exposure_jax.utils.ops import (
    STATE_DROPOUT_BEGIN,
    STATE_REWARD_DIM,
    STATE_STEP_DIM,
    STATE_STOPPED_DIM,
)


@pytest.fixture(scope='module')
def cfg():
    c = load_config('test')
    return c


@pytest.fixture(scope='module')
def filters(cfg):
    return [f(cfg) for f in cfg.filters]


@pytest.fixture(scope='module')
def policy_and_vars(cfg, filters):
    policy = PolicyNet(
        filter_output_dims=tuple(
            f.get_num_filter_parameters() + f.get_num_mask_parameters()
            for f in filters),
        feature_extractor_dims=cfg.feature_extractor_dims,
        base_channels=cfg.base_channels,
        fc1_size=cfg.fc1_size,
        dropout_keep_prob=cfg.dropout_keep_prob)
    key = jax.random.PRNGKey(0)
    img = jnp.zeros((2, 64, 64, 3 + cfg.num_state_dim))
    variables = policy.init({'params': key, 'dropout': key}, img)
    return policy, variables


def test_policy_shapes(cfg, filters, policy_and_vars):
    policy, variables = policy_and_vars
    img = jnp.zeros((4, 64, 64, 3 + cfg.num_state_dim))
    raw, logits = policy.apply(variables, img,
                               rngs={'dropout': jax.random.PRNGKey(1)})
    assert logits.shape == (4, len(filters))
    for f, r in zip(filters, raw):
        assert r.shape == (4, f.get_num_filter_parameters() +
                           f.get_num_mask_parameters())


def test_feature_extractor_conv_progression(cfg, policy_and_vars):
    # 64x64 input goes through 4 stride-2 convs doubling channels from
    # base_channels, with the last conv sized dims/16 (reference
    # agent.py:11-37).
    _, variables = policy_and_vars
    params = variables['params']['shared_extractor']
    convs = sorted(k for k in params if k.startswith('Conv'))
    out_channels = [params[k]['kernel'].shape[-1] for k in convs]
    b = cfg.base_channels
    assert out_channels == [b, 2 * b, 4 * b, cfg.feature_extractor_dims // 16]


def test_flagship_extractor_matches_reference_shapes():
    # Flagship (config_example) sizes: 32 -> 64 -> 128 -> 256 with a
    # 4096-d bottleneck (reference agent.py:11-37, config_example.py:71,80).
    from exposure_jax.models.networks import FeatureExtractor
    fe = FeatureExtractor(output_dim=4096, base_channels=32)
    key = jax.random.PRNGKey(0)
    variables = fe.init({'params': key, 'dropout': key},
                        jnp.zeros((1, 64, 64, 14)))
    convs = sorted(k for k in variables['params'] if k.startswith('Conv'))
    chans = [variables['params'][k]['kernel'].shape[-1] for k in convs]
    assert chans == [32, 64, 128, 256]


def test_critic_shapes(cfg):
    critic = CriticNet(base_channels=cfg.base_channels,
                       fc1_size=cfg.fc1_size)
    key = jax.random.PRNGKey(0)
    img = jnp.zeros((4, 64, 64, 3))
    variables = critic.init(key, img)
    logit = critic.apply(variables, img)
    assert logit.shape == (4, 1)
    # value-net mode: extra state channels
    states = jnp.zeros((4, cfg.num_state_dim))
    value_vars = critic.init(key, img, states)
    v = critic.apply(value_vars, img, states)
    assert v.shape == (4, 1)


def test_critic_stats_oracle(rng):
    img = rng.rand(3, 8, 8, 3).astype(np.float32) * 1.2 - 0.1
    stats = np.asarray(critic_stats(jnp.asarray(img)))
    lum = (img[..., 0] * 0.27 + img[..., 1] * 0.67 + img[..., 2] * 0.06
           + 1e-5)
    np.testing.assert_allclose(stats[:, 0], lum.mean(axis=(1, 2)), rtol=1e-5)
    np.testing.assert_allclose(stats[:, 1], lum.var(axis=(1, 2)), rtol=1e-4,
                               atol=1e-7)
    clip = np.clip(img, 0, 1)
    mx, mn = clip.max(axis=3), clip.min(axis=3)
    sat = (mx - mn) / (np.minimum(mx + mn, 2 - mx - mn) + 1e-2)
    np.testing.assert_allclose(stats[:, 2], sat.mean(axis=(1, 2)), rtol=1e-5)


def test_enrich_image_input(cfg, rng):
    img = jnp.asarray(rng.rand(2, 8, 8, 3).astype(np.float32))
    states = jnp.asarray(rng.rand(2, cfg.num_state_dim).astype(np.float32))
    out = enrich_image_input(cfg, img, states)
    assert out.shape == (2, 8, 8, 3 + cfg.num_state_dim)
    np.testing.assert_allclose(np.asarray(out[:, 3, 5, 3:]),
                               np.asarray(states), rtol=1e-6)


class TestAgentStep:
    def run_step(self, cfg, filters, policy_and_vars, states=None,
                 is_train=1, seed=0, batch=2):
        policy, variables = policy_and_vars
        key = jax.random.PRNGKey(seed)
        img = jax.random.uniform(key, (batch, 64, 64, 3)) * 0.6
        if states is None:
            states = initial_states(batch, cfg.num_state_dim)
        return agent_step(policy, variables, img, states,
                          key=jax.random.PRNGKey(seed + 1),
                          is_train=is_train, progress=0.0, cfg=cfg,
                          filters=filters), img

    def test_output_shapes(self, cfg, filters, policy_and_vars):
        out, _ = self.run_step(cfg, filters, policy_and_vars)
        K = len(filters)
        assert out.image.shape == (2, 64, 64, 3)
        assert out.new_states.shape == (2, cfg.num_state_dim)
        assert out.surrogate.shape == (2, 1)
        assert out.penalty.shape == (2, 1)
        assert out.pdf.shape == (2, K)
        assert out.selected_filter_id.shape == (2,)
        assert out.selected_params.shape[0] == 2

    def test_state_transition(self, cfg, filters, policy_and_vars):
        out, _ = self.run_step(cfg, filters, policy_and_vars)
        ns = np.asarray(out.new_states)
        assert (ns[:, STATE_STEP_DIM] == 1).all()
        assert (ns[:, STATE_STOPPED_DIM] == 0).all()
        assert (ns[:, STATE_REWARD_DIM] == 0).all()
        sel = np.asarray(out.selected_filter_id)
        usage = ns[:, STATE_DROPOUT_BEGIN:]
        for b in range(2):
            assert usage[b, sel[b]] == 1
            assert usage[b].sum() == 1

    def test_terminates_at_test_steps(self, cfg, filters, policy_and_vars):
        states = initial_states(2, cfg.num_state_dim)
        states = states.at[:, STATE_STEP_DIM].set(cfg.test_steps - 1)
        out, _ = self.run_step(cfg, filters, policy_and_vars, states=states)
        ns = np.asarray(out.new_states)
        assert (ns[:, STATE_STOPPED_DIM] == 1).all()
        assert (ns[:, STATE_REWARD_DIM] == 1).all()
        assert (ns[:, STATE_STEP_DIM] == cfg.test_steps).all()

    def test_eval_mode_is_argmax(self, cfg, filters, policy_and_vars):
        out, _ = self.run_step(cfg, filters, policy_and_vars, is_train=0)
        sel = np.asarray(out.selected_filter_id)
        pdf = np.asarray(out.pdf)
        np.testing.assert_array_equal(sel, pdf.argmax(axis=1))

    def test_surrogate_is_log_prob_of_selected(self, cfg, filters,
                                               policy_and_vars):
        out, _ = self.run_step(cfg, filters, policy_and_vars)
        pdf = np.asarray(out.pdf)
        sel = np.asarray(out.selected_filter_id)
        expected = np.log(pdf[np.arange(2), sel] + 1e-10)[:, None]
        np.testing.assert_allclose(np.asarray(out.surrogate), expected,
                                   rtol=1e-5)

    def test_packed_params_reproduce_output(self, cfg, filters,
                                            policy_and_vars):
        # The white-box property: replaying (filter_id, packed_params) on
        # the input must reproduce the agent's output image exactly.
        out, img = self.run_step(cfg, filters, policy_and_vars)
        sel = np.asarray(out.selected_filter_id)
        for b in range(2):
            f = filters[sel[b]]
            n = f.get_num_filter_parameters()
            p = out.selected_params[b:b + 1, :n]
            replayed, _, _ = f.apply(img[b:b + 1], specified_parameter=p)
            np.testing.assert_allclose(np.asarray(replayed[0]),
                                       np.asarray(out.image[b]), atol=1e-5)

    def test_reuse_penalty(self, cfg, filters, policy_and_vars):
        out1, _ = self.run_step(cfg, filters, policy_and_vars)
        # mark ALL filters as already used: reusing any costs penalty 1
        states = initial_states(2, cfg.num_state_dim)
        states = states.at[:, STATE_DROPOUT_BEGIN:].set(1.0)
        out2, _ = self.run_step(cfg, filters, policy_and_vars, states=states)
        diff = np.asarray(out2.penalty) - np.asarray(out1.penalty)
        # same rng -> same selection; extra usage penalty must appear
        assert (diff > 0.9 * cfg.filter_usage_penalty).all()


class TestExplorationRemedies:
    """Round-4 lock-in remedies (DIVERSITY.md addendum 3): replay-pool
    off-policy injection + mid-training entropy re-spike.  Both knobs
    default OFF and must then leave the reference-parity step (and its
    RNG stream) bit-identical."""

    def _step(self, cfg, filters, policy_and_vars, progress=0.0,
              is_train=1, seed=3, batch=16):
        policy, variables = policy_and_vars
        img = jax.random.uniform(jax.random.PRNGKey(seed),
                                 (batch, 64, 64, 3)) * 0.6
        states = initial_states(batch, cfg.num_state_dim)
        return agent_step(policy, variables, img, states,
                          key=jax.random.PRNGKey(seed + 1),
                          is_train=is_train, progress=progress,
                          cfg=cfg, filters=filters)

    def _cfg(self, **knobs):
        c = load_config('test')
        for k, v in knobs.items():
            c[k] = v
        return c

    def test_disabled_knobs_are_bit_identical(self, cfg, filters,
                                              policy_and_vars):
        base = self._step(cfg, filters, policy_and_vars)
        mod = self._step(self._cfg(replay_inject_prob=0.0,
                                   entropy_respike=0.0),
                         filters, policy_and_vars)
        for name in ('image', 'surrogate', 'penalty',
                     'selected_filter_id', 'pdf'):
            np.testing.assert_array_equal(
                np.asarray(getattr(base, name)),
                np.asarray(getattr(mod, name)), err_msg=name)

    def test_injection_forces_offpolicy_actions(self, cfg, filters,
                                                policy_and_vars):
        base = self._step(cfg, filters, policy_and_vars)
        out = self._step(self._cfg(replay_inject_prob=1.0),
                         filters, policy_and_vars)
        # every record forced: surrogate zeroed (no REINFORCE pull)...
        np.testing.assert_array_equal(np.asarray(out.surrogate), 0.0)
        # ...and the ids are the uniform draw, not the policy sample
        assert (np.asarray(out.selected_filter_id) !=
                np.asarray(base.selected_filter_id)).any()
        # the packed record still follows the forced id (white-box
        # replay stays exact for injected trajectories)
        sel = np.asarray(out.selected_filter_id)
        pdf = np.asarray(out.pdf)
        assert not (sel == pdf.argmax(axis=1)).all()

    def test_anti_injection_targets_neglected_filters(
            self, cfg, filters, policy_and_vars):
        """'anti' mode (round 5): the forced draw comes from
        q ~ 1/(pdf + c), so filters the policy neglects get forced at a
        multiple of their policy probability — the targeted W-revival
        remedy (VERDICT r4 #2).  A random-init policy's pdf is too
        uniform to show the tilt, so use a stub policy locked onto
        filter 0: anti-forcing must then nearly never pick filter 0 and
        spread the forced mass over the neglected filters."""
        class _LockedPolicy:
            def apply(self, variables, img, rngs=None):
                b = img.shape[0]
                raws = [jnp.zeros(
                    (b, f.get_num_filter_parameters() +
                     (f.get_num_mask_parameters() if f.use_masking()
                      else 0)), img.dtype) for f in filters]
                logits = jnp.zeros((b, len(filters)), img.dtype)
                return raws, logits.at[:, 0].set(8.0)

        c = self._cfg(replay_inject_prob=1.0,
                      replay_inject_mode='anti')
        batch = 512
        img = jax.random.uniform(jax.random.PRNGKey(3),
                                 (batch, 64, 64, 3)) * 0.6
        states = initial_states(batch, c.num_state_dim)
        out = agent_step(_LockedPolicy(), {}, img, states,
                         key=jax.random.PRNGKey(4), is_train=1,
                         progress=0.0, cfg=c, filters=filters)
        # off-policy contract unchanged
        np.testing.assert_array_equal(np.asarray(out.surrogate), 0.0)
        sel = np.asarray(out.selected_filter_id)
        k = len(filters)
        counts = np.bincount(sel, minlength=k) / len(sel)
        # the policy's pdf puts ~97% on filter 0; anti forcing must
        # invert that: filter 0 well below uniform, every neglected
        # filter well above its policy probability
        assert counts[0] < 0.5 / k, counts
        assert counts[1:].min() > 0.5 / k, counts

    def test_injection_respects_eval_and_window(self, cfg, filters,
                                                policy_and_vars):
        # eval mode: injection must not fire
        base = self._step(cfg, filters, policy_and_vars, is_train=0)
        out = self._step(self._cfg(replay_inject_prob=1.0),
                         filters, policy_and_vars, is_train=0)
        np.testing.assert_array_equal(
            np.asarray(base.selected_filter_id),
            np.asarray(out.selected_filter_id))
        # past the injection window: identical to the plain step
        base = self._step(cfg, filters, policy_and_vars, progress=0.9)
        out = self._step(self._cfg(replay_inject_prob=1.0,
                                   replay_inject_until=0.75),
                         filters, policy_and_vars, progress=0.9)
        np.testing.assert_array_equal(np.asarray(base.surrogate),
                                      np.asarray(out.surrogate))
        np.testing.assert_array_equal(
            np.asarray(base.selected_filter_id),
            np.asarray(out.selected_filter_id))

    def test_respike_bumps_entropy_penalty_only_near_center(
            self, cfg, filters, policy_and_vars):
        spiked = self._cfg(entropy_respike=1.0,
                           entropy_respike_center=0.5,
                           entropy_respike_width=0.15)
        # at the bump center the penalty strictly exceeds the linear
        # decay (entropy < log K for any non-uniform pdf)
        base = self._step(cfg, filters, policy_and_vars, progress=0.5)
        out = self._step(spiked, filters, policy_and_vars, progress=0.5)
        diff = np.asarray(out.penalty) - np.asarray(base.penalty)
        assert (diff > 0).all()
        import math as _math
        expected = float(cfg.exploration_penalty) * (
            -np.asarray(base.entropy) + _math.log(len(filters)))
        np.testing.assert_allclose(diff, expected, rtol=1e-4, atol=1e-7)
        # outside the bump: equal up to f32 roundoff (the zero-valued
        # bump term downcasts the Python-float decay coefficient)
        base = self._step(cfg, filters, policy_and_vars, progress=0.9)
        out = self._step(spiked, filters, policy_and_vars, progress=0.9)
        np.testing.assert_allclose(np.asarray(base.penalty),
                                   np.asarray(out.penalty), rtol=1e-5,
                                   atol=1e-9)


def _flax_reference_modules():
    """The networks as flax.linen modules (the form checkpoints were
    first trained with), for comparison on identical parameters."""
    nn = pytest.importorskip('flax.linen')
    from exposure_jax.utils.ops import lrelu
    glorot = nn.initializers.glorot_uniform()

    class FeatureExtractor(nn.Module):
        output_dim: int
        base_channels: int = 32
        dropout_keep_prob: float = 0.5

        @nn.compact
        def __call__(self, x):
            x = x - 0.5
            size, channels = x.shape[2], self.base_channels
            x = lrelu(nn.Conv(channels, (4, 4), strides=(2, 2),
                              padding='SAME', kernel_init=glorot)(x))
            size //= 2
            while size > 4:
                channels = self.output_dim // 16 if size == 8 \
                    else channels * 2
                x = lrelu(nn.Conv(channels, (4, 4), strides=(2, 2),
                                  padding='SAME', kernel_init=glorot)(x))
                size //= 2
            x = x.reshape((x.shape[0], self.output_dim))
            return nn.Dropout(rate=1.0 - self.dropout_keep_prob,
                              deterministic=False)(x)

    class PolicyNet(nn.Module):
        filter_output_dims: tuple
        feature_extractor_dims: int
        base_channels: int
        fc1_size: int
        dropout_keep_prob: float

        @nn.compact
        def __call__(self, x):
            fe = dict(output_dim=self.feature_extractor_dims,
                      base_channels=self.base_channels,
                      dropout_keep_prob=self.dropout_keep_prob)
            shared = FeatureExtractor(**fe, name='shared_extractor')(x)
            raw = []
            for j, d in enumerate(self.filter_output_dims):
                h = lrelu(nn.Dense(self.fc1_size, kernel_init=glorot,
                                   name='filter_%d_fc1' % j)(shared))
                raw.append(nn.Dense(d, kernel_init=glorot,
                                    name='filter_%d_fc2' % j)(h))
            sel = FeatureExtractor(**fe, name='selector_extractor')(x)
            sel = lrelu(nn.Dense(self.fc1_size, kernel_init=glorot,
                                 name='selector_fc1')(sel))
            return raw, nn.Dense(len(self.filter_output_dims),
                                 kernel_init=glorot,
                                 name='selector_fc2')(sel)

    class CriticNet(nn.Module):
        base_channels: int
        fc1_size: int

        @nn.compact
        def __call__(self, images, states=None):
            from exposure_jax.models.networks import critic_stats
            stat = critic_stats(images)
            states = stat if states is None else \
                jnp.concatenate([states, stat], axis=1)
            x = jnp.concatenate(
                [images, states[:, None, None, :] + images[..., 0:1] * 0],
                axis=3) - 0.5
            size, channels = x.shape[2], self.base_channels
            x = lrelu(nn.Conv(channels, (4, 4), strides=(2, 2),
                              padding='SAME', kernel_init=glorot)(x))
            size //= 2
            while size > 4:
                channels *= 2
                size //= 2
                x = lrelu(nn.Conv(channels, (4, 4), strides=(2, 2),
                                  padding='SAME', kernel_init=glorot)(x))
            x = x.reshape((x.shape[0], 16 * channels))
            x = lrelu(nn.Dense(self.fc1_size, kernel_init=glorot)(x))
            return nn.Dense(1, kernel_init=glorot)(x)

    return PolicyNet, CriticNet


@pytest.mark.parametrize('net', ['policy', 'critic', 'value'])
def test_plain_networks_match_flax(cfg, filters, net):
    # with dropout off (keep_prob 1) the plain-lax networks compute what
    # the flax.linen modules compute, on parameters either one created:
    # same tree, same names, same shapes, same outputs
    FlaxPolicy, FlaxCritic = _flax_reference_modules()
    key = jax.random.PRNGKey(3)
    dims = tuple(f.get_num_filter_parameters() +
                 f.get_num_mask_parameters() for f in filters)
    if net == 'policy':
        args = dict(filter_output_dims=dims,
                    feature_extractor_dims=cfg.feature_extractor_dims,
                    base_channels=cfg.base_channels, fc1_size=cfg.fc1_size,
                    dropout_keep_prob=1.0)
        ours, ref = PolicyNet(**args), FlaxPolicy(**args)
        inputs = (jax.random.uniform(key, (3, 64, 64,
                                           3 + cfg.num_state_dim)),)
    else:
        ours = CriticNet(cfg.base_channels, cfg.fc1_size)
        ref = FlaxCritic(cfg.base_channels, cfg.fc1_size)
        inputs = (jax.random.uniform(key, (3, 64, 64, 3)),)
        if net == 'value':
            inputs += (jax.random.uniform(key, (3, cfg.num_state_dim)),)
    rngs = {'params': key, 'dropout': key}
    v_ref = ref.init(rngs, *inputs)
    v_ours = ours.init(rngs, *inputs)
    assert (jax.tree_util.tree_structure(v_ref) ==
            jax.tree_util.tree_structure(v_ours))
    for a, b in zip(jax.tree_util.tree_leaves(v_ref),
                    jax.tree_util.tree_leaves(v_ours)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for variables in (v_ref, v_ours):
        got = ours.apply(variables, *inputs, rngs={'dropout': key})
        want = ref.apply(variables, *inputs, rngs={'dropout': key})
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-5)


def test_dropout_masks_follow_the_key(cfg, filters, policy_and_vars):
    # dropout is always on: one key gives one trajectory of masks (the
    # two extractors draw different ones), another key other masks
    policy, variables = policy_and_vars
    img = jnp.full((2, 64, 64, 3 + cfg.num_state_dim), 0.3)
    a = policy.apply(variables, img, rngs={'dropout': jax.random.PRNGKey(1)})
    b = policy.apply(variables, img, rngs={'dropout': jax.random.PRNGKey(1)})
    c = policy.apply(variables, img, rngs={'dropout': jax.random.PRNGKey(2)})
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    assert not np.array_equal(np.asarray(a[1]), np.asarray(c[1]))
    with pytest.raises(ValueError, match='dropout'):
        policy.apply(variables, img)
