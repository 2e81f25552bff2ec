"""Durable serving artifacts (core/artifacts.py): compact .npz policy
exports that survive fresh checkouts, and the checkpoint->artifact
restore fallback serving/eval/bench all share."""

import os

import jax
import numpy as np
import pytest

from exposure_jax.core.artifacts import (
    artifact_path,
    export_serving_artifact,
    has_trained_params,
    restore_for_serving,
    restore_serving_artifact,
)
from exposure_jax.core.checkpoint import save_checkpoint
from exposure_jax.core.trainer import build_models, init_train_state
from exposure_jax.utils.config import load_config


@pytest.fixture(scope='module')
def small_state():
    cfg = load_config('test')
    cfg.name = 'test/artifact-run'
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, seed=0)
    # perturb gen_params away from init so a restore mix-up can't pass
    state = state.replace(gen_params=jax.tree_util.tree_map(
        lambda x: x + 0.25, state.gen_params))
    return cfg, policy, critic, value, state


def _fresh_template(small_state):
    cfg, policy, critic, value, _ = small_state
    tmpl, _ = init_train_state(cfg, policy, critic, value, seed=1)
    return tmpl


@pytest.mark.parametrize('dtype,exact', [(np.float32, True),
                                         (np.float16, False)])
def test_roundtrip(tmp_path, small_state, dtype, exact):
    cfg, _, _, _, state = small_state
    path = str(tmp_path / 'a.npz')
    export_serving_artifact(cfg.name, state, 123, path, dtype=dtype)
    restored, step = restore_serving_artifact(
        path, _fresh_template(small_state))
    assert step == 123
    src = jax.tree_util.tree_leaves(state.gen_params)
    dst = jax.tree_util.tree_leaves(restored.gen_params)
    assert len(src) == len(dst)
    for a, b in zip(src, dst):
        a = np.asarray(a, np.float32)
        b = np.asarray(b)
        assert b.dtype == np.float32
        if exact:  # the f32 default is bit-exact
            np.testing.assert_array_equal(a, b)
        else:      # f16 relative rounding (magnitudes here are O(1))
            np.testing.assert_allclose(a, b, atol=2e-3, rtol=1e-3)
    # only gen_params restored: critic params stay at template values
    c_src = jax.tree_util.tree_leaves(state.crit_params)
    c_dst = jax.tree_util.tree_leaves(restored.crit_params)
    assert any(not np.allclose(np.asarray(a), np.asarray(b))
               for a, b in zip(c_src, c_dst))


def test_restore_rejects_mismatched_tree(tmp_path, small_state):
    cfg, _, _, _, state = small_state
    path = str(tmp_path / 'a.npz')
    export_serving_artifact(cfg.name, state, 1, path)
    bad = _fresh_template(small_state)
    # template with an extra-shaped leaf must fail loudly
    gp = jax.tree_util.tree_map(lambda x: np.zeros(x.shape + (1,),
                                                   np.float32),
                                bad.gen_params)
    bad = bad.replace(gen_params=gp)
    with pytest.raises(ValueError):
        restore_serving_artifact(path, bad)


def test_restore_for_serving_prefers_checkpoint(tmp_path, small_state,
                                                monkeypatch):
    cfg, _, _, _, state = small_state
    monkeypatch.chdir(tmp_path)
    run = cfg.name
    ckpt_dir = os.path.join('models', run)
    save_checkpoint(ckpt_dir, state, 77)
    export_serving_artifact(run, state, 55)
    got, step, src = restore_for_serving(
        run, _fresh_template(small_state))
    assert (step, src) == (77, 'checkpoint')

    # remove the checkpoint: falls back to the artifact
    for p in os.listdir(ckpt_dir):
        os.remove(os.path.join(ckpt_dir, p))
    got, step, src = restore_for_serving(
        run, _fresh_template(small_state))
    assert (step, src) == (55, 'artifact')
    ref = jax.tree_util.tree_leaves(state.gen_params)
    out = jax.tree_util.tree_leaves(got.gen_params)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b), atol=2e-3, rtol=1e-3)

    # neither present -> loud failure
    os.remove(artifact_path(run))
    with pytest.raises(FileNotFoundError):
        restore_for_serving(run, _fresh_template(small_state))


def test_has_trained_params(tmp_path, small_state, monkeypatch):
    cfg, _, _, _, state = small_state
    monkeypatch.chdir(tmp_path)
    run = cfg.name
    assert not has_trained_params(run)
    export_serving_artifact(run, state, 1)
    assert has_trained_params(run)


def test_tracked_artifact_restores_into_flagship_template():
    # the git-tracked artifact holds every generator leaf of the
    # synthetic_explore config, by the parameter names the plain
    # networks create, and restores as finite float32 arrays
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config('synthetic_explore')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, seed=0)
    path = os.path.join(here, artifact_path('synthetic_explore/best'))
    restored, step = restore_serving_artifact(path, state)
    assert step > 0
    leaves = jax.tree_util.tree_leaves(restored.gen_params)
    assert len(leaves) == len(jax.tree_util.tree_leaves(state.gen_params))
    for leaf in leaves:
        assert leaf.dtype == np.float32
        assert np.isfinite(np.asarray(leaf)).all()
    conv = restored.gen_params['params']['shared_extractor']['Conv_0']
    assert conv['kernel'].shape == (4, 4, 3 + cfg.num_state_dim,
                                    cfg.base_channels)
