"""Supervised-mode tests: paired data plumbing, MSE reward semantics, and
an end-to-end smoke train run with no critic updates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exposure_jax.core.losses import (
    generator_value_loss,
    supervised_distance,
)
from exposure_jax.data.device_sampler import (
    DevicePack,
    channels_to_paired,
    paired_to_channels,
    sample_batch,
)
from exposure_jax.data.synthetic import (
    PairedSyntheticDataProvider,
    make_paired_synthetic_pack,
)
from exposure_jax.utils import load_config


class TestPairedData:
    def test_pack_shapes_and_alignment(self):
        pairs = make_paired_synthetic_pack(8, 32, 0)
        assert pairs.shape == (8, 2, 32, 32, 3)
        # input must be a darkened version of the target
        assert pairs[:, 0].mean() < pairs[:, 1].mean()

    def test_channel_roundtrip(self, rng):
        pairs = jnp.asarray(rng.rand(4, 2, 8, 8, 3).astype(np.float32))
        stacked = paired_to_channels(pairs)
        assert stacked.shape == (4, 8, 8, 6)
        a, b = channels_to_paired(stacked, 3)
        np.testing.assert_allclose(np.asarray(a), np.asarray(pairs[:, 0]))
        np.testing.assert_allclose(np.asarray(b), np.asarray(pairs[:, 1]))

    def test_augmented_sampling_keeps_pairs_aligned(self, rng):
        # input = target * 0.5 pixelwise; after any crop/flip the relation
        # must hold exactly.
        target = rng.rand(6, 80, 80, 3).astype(np.float32)
        pairs = np.stack([target * 0.5, target], axis=1)
        stacked = paired_to_channels(jnp.asarray(pairs))
        pack = DevicePack(stacked, 64, True)
        batch = sample_batch(pack, jax.random.PRNGKey(0), 8)
        a, b = channels_to_paired(batch, 3)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b) * 0.5,
                                   rtol=1e-6)

    def test_provider_host_batches(self):
        dp = PairedSyntheticDataProvider(n=16, size=80, output_size=64,
                                         augmentation=0.3)
        batch, _ = dp.get_next_batch(4)
        assert batch.shape == (4, 2, 64, 64, 3)


class TestSupervisedLoss:
    def test_reward_is_negative_distance(self, rng):
        cfg = load_config('supervised_test')
        from exposure_jax.core.trainer import build_models, \
            init_train_state
        filters, policy, critic, value = build_models(cfg)
        state, _ = init_train_state(cfg, policy, critic, value, 0)
        img = jnp.asarray(rng.rand(2, 64, 64, 3).astype(np.float32) * 0.5)
        gt = jnp.asarray(rng.rand(2, 64, 64, 3).astype(np.float32))
        states = jnp.zeros((2, cfg.num_state_dim))
        cfg2 = cfg.copy()
        cfg2.use_penalty = False
        _, aux = generator_value_loss(
            {'gen': state.gen_params, 'val': state.val_params},
            state.crit_params, policy, critic, value, img, states,
            jax.random.PRNGKey(0), jnp.int32(1), 0.5, cfg2, filters,
            ground_truth=gt)
        # reward == -mse(out, gt) exactly (all_reward=1, no penalty)
        expected = -np.asarray(supervised_distance(
            jnp.asarray(aux.new_images), gt))
        np.testing.assert_allclose(np.asarray(aux.reward), expected,
                                   rtol=1e-4, atol=1e-6)

    def test_requires_ground_truth(self, rng):
        cfg = load_config('supervised_test')
        from exposure_jax.core.trainer import build_models, \
            init_train_state
        filters, policy, critic, value = build_models(cfg)
        state, _ = init_train_state(cfg, policy, critic, value, 0)
        img = jnp.zeros((2, 64, 64, 3))
        with pytest.raises(AssertionError):
            generator_value_loss(
                {'gen': state.gen_params, 'val': state.val_params},
                state.crit_params, policy, critic, value, img,
                jnp.zeros((2, cfg.num_state_dim)), jax.random.PRNGKey(0),
                jnp.int32(1), 0.5, cfg, filters, ground_truth=None)


def test_supervised_smoke_train(tmp_path):
    cfg = load_config('supervised_test')
    cfg.name = 'supervised_test/smoke'
    cfg.max_iter_step = 2
    from exposure_jax.core.trainer import Trainer
    trainer = Trainer(cfg, restore=False, model_root=str(tmp_path))
    trainer.train()
    if trainer.tee:
        trainer.tee.close()
    assert trainer.pool.ground_truth is not None
    assert trainer.latest_checkpoint() is not None
    # params moved under the supervised reward
    ps = np.asarray(trainer.pool.states)
    assert (ps[:, 2] >= 0).all()


def test_supervised_fused_dispatch(tmp_path):
    # supervised + iters_per_dispatch: fused chunks with citers=0 and the
    # paired sample_fake path
    cfg = load_config('supervised_test').copy()
    cfg.name = 'supervised_test/fused'
    cfg.max_iter_step = 8
    cfg.iters_per_dispatch = 4
    cfg.checkpoint_interval = 8
    from exposure_jax.core.trainer import Trainer
    trainer = Trainer(cfg, restore=False, model_root=str(tmp_path))
    metrics = trainer.train()
    if trainer.tee:
        trainer.tee.close()
    assert int(trainer.state.step) == 9
    assert np.isfinite(np.asarray(metrics.g_loss))
    assert float(metrics.emd) == 0.0  # no critic phase ever ran


def test_quality_report_supervised_branch(tmp_path):
    # the report scores against the paired ground truth and adds MSE
    from exposure_jax.core.trainer import Trainer
    from exposure_jax.tools.quality_report import quality_report
    cfg = load_config('supervised_test').copy()
    cfg.name = 'supervised_test/qr'
    cfg.max_iter_step = 1
    trainer = Trainer(cfg, restore=False, model_root=str(tmp_path))
    trainer.train()
    if trainer.tee:
        trainer.tee.close()
    r = quality_report(cfg, n=8, model_root=str(tmp_path),
                       state=trainer.state)
    assert 'mse_before' in r and 'mse_after' in r
    assert r['mse_before'] > 0
    assert len(r['intersection_after']) == 3
