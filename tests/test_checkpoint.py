"""Checkpoint crash-safety: atomic writes, pruning, corrupt-latest
fallback."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from exposure_jax.core.checkpoint import (
    latest_checkpoint_step,
    restore_checkpoint,
    save_checkpoint,
)


def make_state(v):
    return {'w': jnp.full((4,), float(v)), 'step': jnp.int32(v)}


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, make_state(3), 3)
    restored, step = restore_checkpoint(d, make_state(0))
    assert step == 3
    np.testing.assert_array_equal(np.asarray(restored['w']), 3.0)


def test_keep_pruning(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        save_checkpoint(d, make_state(s), s, keep=2)
    files = sorted(os.listdir(d))
    assert files == ['model.ckpt-2.npz', 'model.ckpt-3.npz']
    assert latest_checkpoint_step(d) == 3


def test_corrupt_latest_falls_back(tmp_path, capsys):
    d = str(tmp_path)
    save_checkpoint(d, make_state(5), 5, keep=3)
    # simulate a kill mid-write of a newer checkpoint
    with open(os.path.join(d, 'model.ckpt-10.npz'), 'wb') as f:
        f.write(b'')
    restored, step = restore_checkpoint(d, make_state(0))
    assert step == 5
    np.testing.assert_array_equal(np.asarray(restored['w']), 5.0)


def test_no_tmp_left_behind(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, make_state(1), 1)
    assert not [p for p in os.listdir(d) if p.endswith('.tmp')]


def test_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / 'nope'), make_state(0))


def test_restore_returns_device_committed_arrays(tmp_path):
    # the file holds host numpy; if restore returned that, EVERY jitted
    # call would re-upload the params — the restored tree must be jax
    # Arrays committed to a device
    import jax
    d = str(tmp_path)
    save_checkpoint(d, make_state(3), 1)
    restored, _ = restore_checkpoint(d, make_state(0))
    for leaf in jax.tree_util.tree_leaves(restored):
        assert isinstance(leaf, jax.Array), type(leaf)


def test_train_state_roundtrip_is_bit_exact(tmp_path):
    # the full TrainState (three parameter trees, three Adam states, the
    # EMA and the step) survives the .npz round trip bit for bit and
    # keeps its types
    import jax

    from exposure_jax.core.train_state import TrainState
    from exposure_jax.core.trainer import build_models, init_train_state
    from exposure_jax.utils import load_config

    cfg = load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, seed=0)
    state = state.replace(
        gen_params=jax.tree_util.tree_map(lambda x: x + 0.5,
                                          state.gen_params),
        ema=state.ema.update(3.0), step=jnp.int32(7))
    save_checkpoint(str(tmp_path), state, 7)
    template, _ = init_train_state(cfg, policy, critic, value, seed=1)
    restored, step = restore_checkpoint(str(tmp_path), template)
    assert step == 7 and isinstance(restored, TrainState)
    a = jax.tree_util.tree_leaves_with_path(state)
    b = jax.tree_util.tree_leaves_with_path(restored)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_restore_rejects_other_tree(tmp_path):
    # a checkpoint whose keys or shapes differ from the template is
    # unreadable for it (and restore says so instead of mis-assigning)
    d = str(tmp_path)
    save_checkpoint(d, make_state(2), 2)
    with pytest.raises(ValueError):
        restore_checkpoint(d, {'w': jnp.zeros((5,)), 'step': jnp.int32(0)})
    with pytest.raises(ValueError):
        restore_checkpoint(d, {'v': jnp.zeros((4,)), 'step': jnp.int32(0)})
