"""End-to-end streaming training: Trainer with stream_data=True fed by
the native hostloader providers (the big-dataset path)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from exposure_jax.data.synthetic import make_synthetic_pack
from exposure_jax.utils import load_config


@pytest.fixture(scope='module')
def native_packs(tmp_path_factory):
    from exposure_jax.native import library_available
    if not library_available():
        subprocess.check_call(
            [sys.executable, '-m', 'exposure_jax.native.build'])
    d = tmp_path_factory.mktemp('packs')
    raw_path = str(d / 'raw.npy')
    real_path = str(d / 'real.npy')
    np.save(raw_path, make_synthetic_pack(48, 80, 'raw', 0))
    np.save(real_path, make_synthetic_pack(48, 64, 'retouched', 1))
    return raw_path, real_path


def test_streaming_trainer_smoke(native_packs, tmp_path):
    raw_path, real_path = native_packs
    from exposure_jax.data.native_provider import NativePackProvider

    cfg = load_config('test')
    cfg.name = 'stream_test/smoke'
    cfg.max_iter_step = 8
    cfg.stream_data = True
    # exercise the fused multi-iteration streaming dispatch
    # (trainer._run_fused_streaming) including a remainder chunk
    cfg.stream_iters_per_dispatch = 3
    cfg.fake_data_provider = lambda: NativePackProvider(
        raw_path, output_size=64, augmentation=0.3, seed=0)
    cfg.real_data_provider = lambda: NativePackProvider(
        real_path, output_size=64, augmentation=0.0, seed=1)

    from exposure_jax.core.trainer import Trainer
    trainer = Trainer(cfg, restore=False, model_root=str(tmp_path))
    assert trainer.streaming
    assert trainer.fake_images is None
    trainer.train()
    if trainer.tee:
        trainer.tee.close()
    for pf in getattr(trainer, '_prefetchers', {}).values():
        pf.stop()
    assert trainer.latest_checkpoint() is not None
    ps = np.asarray(trainer.pool.states)
    assert np.isfinite(np.asarray(trainer.pool.images)).all()
    assert (ps[:, 2] >= 0).all()


def test_streaming_supervised_trainer_smoke(tmp_path):
    # supervised + stream_data: paired ground truth rides channel-stacked
    # in the per-call fresh data (steps.py::build_streaming_outer_step)
    from exposure_jax.core.trainer import Trainer

    cfg = load_config('supervised_test')
    cfg.name = 'stream_test/supervised'
    cfg.max_iter_step = 2
    cfg.stream_data = True

    trainer = Trainer(cfg, restore=False, model_root=str(tmp_path))
    assert trainer.streaming and trainer.supervised
    metrics = trainer.train()
    if trainer.tee:
        trainer.tee.close()
    for pf in getattr(trainer, '_prefetchers', {}).values():
        pf.stop()
    assert np.isfinite(np.asarray(metrics.g_loss))
    assert float(np.asarray(metrics.emd)) == 0.0  # no critic phase
    assert np.isfinite(np.asarray(trainer.pool.images)).all()
    # the pool carries aligned ground truth in supervised mode
    assert trainer.pool.ground_truth is not None


def test_prefetcher_overlap_and_errors():
    from exposure_jax.utils.prefetch import AsyncPrefetcher
    import time

    calls = []

    def produce():
        calls.append(time.time())
        return len(calls)

    pf = AsyncPrefetcher(produce)
    a = pf.get_next()
    b = pf.get_next()
    assert (a, b) == (1, 2)
    pf.stop()

    def boom():
        raise ValueError('producer failure')

    pf2 = AsyncPrefetcher(boom)
    with pytest.raises(ValueError):
        pf2.get_next()
    pf2.stop()
