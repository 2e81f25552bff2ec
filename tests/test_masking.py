"""Masking-mode tests: the dormant spatial-mask capability
(cfg.masking=True, reference filters.py:101-148) must train end to end —
masks modulate filter strength per pixel and gradients flow into the mask
head outputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exposure_jax.models import PolicyNet, agent_step, initial_states
from exposure_jax.ops.filters import ExposureFilter
from exposure_jax.utils import load_config


@pytest.fixture(scope='module')
def masked_cfg():
    cfg = load_config('test')
    cfg = cfg.copy()
    cfg.masking = True
    return cfg


def test_mask_varies_spatially(masked_cfg, rng):
    f = ExposureFilter(masked_cfg)
    img = jnp.asarray(rng.rand(2, 16, 16, 3).astype(np.float32))
    mp = jnp.asarray(rng.randn(2, 6).astype(np.float32) * 2)
    mask = np.asarray(f.get_mask(img, mp))
    assert mask.shape == (2, 16, 16, 1)
    assert mask.std() > 1e-4  # actually spatial, not constant


def test_masked_apply_blends(masked_cfg, rng):
    f = ExposureFilter(masked_cfg)
    img = jnp.asarray(rng.rand(1, 8, 8, 3).astype(np.float32) * 0.5)
    raw = jnp.full((1, 1), 3.0)  # strong exposure boost
    mp = jnp.asarray(rng.randn(1, 6).astype(np.float32))
    out, _, params = f.apply(img, raw_parameters=raw, mask_parameters=mp)
    full = f.process(img, params)
    # masked output lies between input and fully-processed image
    assert float(jnp.abs(out - img).sum()) > 0
    assert float(jnp.abs(out - full).sum()) > 0
    lo = jnp.minimum(img, full) - 1e-5
    hi = jnp.maximum(img, full) + 1e-5
    assert bool(jnp.all((out >= lo) & (out <= hi)))


def test_masked_whitebox_replay(masked_cfg, rng):
    # With masking on, replaying (filter_id, params, mask_params) must
    # reproduce the rollout's final image — the white-box property
    # extends to the spatial masks.
    import jax
    from exposure_jax.core.rollout import rollout
    from exposure_jax.ops.chain import apply_filter_chain

    cfg = masked_cfg
    filters = [f(cfg) for f in cfg.filters]
    policy = PolicyNet(
        filter_output_dims=tuple(
            f.get_num_filter_parameters() + f.get_num_mask_parameters()
            for f in filters),
        feature_extractor_dims=cfg.feature_extractor_dims,
        base_channels=cfg.base_channels,
        fc1_size=cfg.fc1_size,
        dropout_keep_prob=cfg.dropout_keep_prob)
    key = jax.random.PRNGKey(0)
    variables = policy.init(
        {'params': key, 'dropout': key},
        jnp.zeros((2, 64, 64, 3 + cfg.num_state_dim)))
    imgs = jnp.asarray(rng.rand(2, 64, 64, 3).astype(np.float32) * 0.6)
    traj = rollout(policy, variables, imgs, jax.random.PRNGKey(1),
                   cfg=cfg, filters=filters, is_train=0)
    replayed = apply_filter_chain(imgs, traj.filter_ids, traj.params,
                                  filters, mask_params=traj.mask_params)
    np.testing.assert_allclose(np.asarray(replayed),
                               np.asarray(traj.final_image), atol=2e-4)
    # and WITHOUT the mask params the replay must differ (mask is real)
    replayed_nomask = apply_filter_chain(
        imgs, traj.filter_ids, traj.params,
        [type(f)(load_config('test')) for f in filters])
    assert float(jnp.abs(replayed_nomask - traj.final_image).max()) > 1e-4


def test_agent_step_trains_mask_heads(masked_cfg, rng):
    cfg = masked_cfg
    filters = [f(cfg) for f in cfg.filters]
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

    x = jnp.asarray(rng.rand(2, 64, 64, 3).astype(np.float32) * 0.6)
    states = initial_states(2, cfg.num_state_dim)

    def loss(v):
        out = agent_step(policy, v, x, states, key=jax.random.PRNGKey(1),
                         is_train=jnp.int32(1), progress=0.0, cfg=cfg,
                         filters=filters)
        return jnp.sum(out.image ** 2)

    grads = jax.grad(loss)(variables)
    # the fc2 head columns beyond n_params feed the mask; with masking on
    # the SELECTED filters' mask columns must receive gradient (pathwise
    # gradients only flow through the one-hot-selected branch)
    total = 0.0
    for j, f in enumerate(filters):
        g = grads['params']['filter_%d_fc2' % j]['kernel']
        n = f.get_num_filter_parameters()
        total += float(np.abs(np.asarray(g[:, n:])).sum())
    assert total > 0


@pytest.fixture(scope='module')
def masked_trained(tmp_path_factory):
    """Shrunken masked training smoke: masking on, Vignet+Level in the
    bank (the config_masked setup at test scale)."""
    from exposure_jax.core.trainer import Trainer
    from exposure_jax.ops.filters import LevelFilter, VignetFilter
    root = tmp_path_factory.mktemp('models')
    cfg = load_config('test').copy()
    cfg.masking = True
    cfg.filters = list(cfg.filters) + [VignetFilter, LevelFilter]
    cfg.num_state_dim = 3 + len(cfg.filters)
    cfg.name = 'masked/smoke'
    cfg.max_iter_step = 2
    cfg.write_image_interval = 0
    trainer = Trainer(cfg, restore=False, model_root=str(root))
    trainer.train()
    if trainer.tee:
        trainer.tee.close()
    return cfg, trainer, root


def test_masked_training_runs(masked_trained):
    cfg, trainer, root = masked_trained
    assert trainer.latest_checkpoint() is not None


def test_masked_viz_grid_has_mask_row(masked_trained):
    import os
    cfg, trainer, root = masked_trained
    trainer.visualize(1)
    path = os.path.join(trainer.image_dir, '000001.png')
    assert os.path.exists(path)


def test_masked_evaluator_steps_strip(masked_trained, tmp_path, rng):
    import os
    from exposure_jax.core.evaluator import Evaluator
    from exposure_jax.utils.image_io import write_image
    cfg, trainer, root = masked_trained
    in_path = str(tmp_path / 'input.png')
    write_image(in_path, rng.rand(96, 128, 3).astype(np.float32))
    ev = Evaluator(cfg, model_root=str(root))
    out_dir = str(tmp_path / 'outputs')
    results = ev.eval([in_path], output_dir=out_dir, step_by_step=False)
    assert np.isfinite(results[0]['retouched']).all()
    # debug records carry the raw mask parameters for white-box replay
    for d in results[0]['debug']:
        assert 'mask_parameters' in d
        assert d['mask_parameters'].shape[0] >= 5
    assert os.path.exists(os.path.join(out_dir, 'input.png.steps.png'))


def test_draw_mask_panel_vignette_contour(masked_cfg, rng):
    # the vignette's 0.5 contour (the ellipse) must be drawn in red
    from exposure_jax.ops.filters import VignetFilter
    from exposure_jax.utils.viz import draw_mask_panel
    f = VignetFilter(masked_cfg)
    img = rng.rand(64, 64, 3).astype(np.float32)
    # params that give a mid-strength elliptical mask crossing 0.5
    panel = draw_mask_panel(f, img, np.asarray([2.0, 2.0, 1.5, -2.0, 2.0],
                                               np.float32))
    assert panel.shape == (64, 64, 3)
    red = (panel[:, :, 0] > 0.9) & (panel[:, :, 1] < 0.4)
    assert red.any(), 'no contour drawn'


def test_config_masked_loads():
    cfg = load_config('masked')
    assert cfg.masking
    names = [f.__name__ for f in cfg.filters]
    assert 'VignetFilter' in names and 'LevelFilter' in names
    assert cfg.num_state_dim == 3 + len(cfg.filters)
