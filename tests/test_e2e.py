"""End-to-end smoke test: train a few iterations on synthetic data through
the Trainer (full CLI stack), checkpoint, restore with the Evaluator, and
retouch a real image file at full resolution (the reference's
train.py -> evaluate.py workflow, SURVEY.md §3.1-3.2)."""

import os

import numpy as np
import pytest

from exposure_jax.utils import load_config
from exposure_jax.utils.image_io import write_image


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp('models')
    cfg = load_config('test')
    cfg.name = 'test/smoke'
    cfg.max_iter_step = 3
    from exposure_jax.core.trainer import Trainer
    trainer = Trainer(cfg, restore=False, model_root=str(root))
    trainer.train()
    if trainer.tee:
        trainer.tee.close()
    return cfg, trainer, root


def test_training_produces_checkpoint_and_logs(trained):
    cfg, trainer, root = trained
    run_dir = os.path.join(str(root), 'test', 'smoke')
    assert trainer.latest_checkpoint() is not None
    assert os.path.exists(os.path.join(run_dir, 'log.txt'))
    assert os.path.exists(os.path.join(run_dir, 'metrics.jsonl'))
    assert os.path.isdir(os.path.join(run_dir, 'scripts'))
    # config snapshot captured for self-describing runs
    assert os.path.exists(os.path.join(run_dir, 'scripts',
                                       'config_test.py'))


def test_resume_from_checkpoint(trained):
    cfg, trainer, root = trained
    step = trainer.restore()
    assert step >= 2
    assert int(trainer.state.step) == step


def test_evaluator_full_resolution(trained, tmp_path):
    cfg, trainer, root = trained
    # write a non-square sRGB input image
    rng = np.random.RandomState(0)
    img = rng.rand(96, 128, 3).astype(np.float32)
    in_path = str(tmp_path / 'input.png')
    write_image(in_path, img)

    from exposure_jax.core.evaluator import Evaluator
    ev = Evaluator(cfg, model_root=str(root))
    out_dir = str(tmp_path / 'outputs')
    results = ev.eval([in_path], output_dir=out_dir, step_by_step=True)
    assert len(results) == 1
    retouched = results[0]['retouched']
    assert retouched.shape == (96, 128, 3)
    assert np.isfinite(retouched).all()
    base = 'input.png'
    for tag in ('linear', 'input_tone_mapped', 'retouched', 'steps'):
        assert os.path.exists(os.path.join(out_dir,
                                           base + '.' + tag + '.png')), tag
    assert os.path.exists(os.path.join(out_dir, base + '_debug.pkl'))
    # debug record sanity: K steps with valid filter ids and pdfs
    debug = results[0]['debug']
    assert len(debug) == cfg.test_steps
    for d in debug:
        assert 0 <= d['filter_id'] < len(cfg.filters)
        assert abs(d['pdf'].sum() - 1.0) < 1e-3


def test_visualization_grid(trained):
    cfg, trainer, root = trained
    trainer.visualize(7)
    path = os.path.join(trainer.image_dir, '000007.png')
    assert os.path.exists(path)
    import imageio.v2 as imageio
    img = imageio.imread(path)
    assert img.ndim == 3 and img.shape[2] == 3
    assert img.shape[0] > 100 and img.shape[1] > 100


def test_evaluator_batched(trained, tmp_path):
    cfg, trainer, root = trained
    rng = np.random.RandomState(1)
    paths = []
    for i, shape in enumerate([(96, 128, 3), (96, 128, 3), (64, 64, 3)]):
        p = str(tmp_path / ('in%d.png' % i))
        write_image(p, rng.rand(*shape).astype(np.float32))
        paths.append(p)
    from exposure_jax.core.evaluator import Evaluator
    ev = Evaluator(cfg, model_root=str(root))
    out_dir = str(tmp_path / 'outs')
    results = ev.eval_batched(paths, output_dir=out_dir)
    assert len(results) == 3
    for i, p in enumerate(paths):
        base = os.path.basename(p)
        assert os.path.exists(os.path.join(out_dir,
                                           base + '.retouched.png'))
    shapes = sorted(r['retouched'].shape for r in results)
    assert shapes == [(64, 64, 3), (96, 128, 3), (96, 128, 3)]


def test_chain_replay_matches_lowres_rollout(trained):
    # White-box consistency at trajectory level: replaying the recorded
    # chain on the 64x64 proxy must reproduce the rollout's final image.
    cfg, trainer, root = trained
    import jax
    import jax.numpy as jnp
    from exposure_jax.ops.chain import apply_filter_chain

    raw, _ = trainer.fake_provider.get_next_batch(4)
    traj = trainer.run_rollout(raw, key=jax.random.PRNGKey(3), is_train=0)
    replayed = apply_filter_chain(jnp.asarray(raw), traj.filter_ids,
                                  traj.params, trainer.filters)
    np.testing.assert_allclose(np.asarray(replayed),
                               np.asarray(traj.final_image), atol=2e-4)


def test_evaluator_batched_u8_fallback(trained, tmp_path, capsys):
    # on CPU --u8 replays through the jnp chain under the kernel's uint8
    # contract: valid outputs on the 8-bit grid, close to the f32 path
    cfg, trainer, root = trained
    rng = np.random.RandomState(2)
    p = str(tmp_path / 'in.png')
    write_image(p, rng.rand(96, 128, 3).astype(np.float32))
    from exposure_jax.core.evaluator import Evaluator
    ev = Evaluator(cfg, model_root=str(root))
    results = ev.eval_batched([p], output_dir=str(tmp_path / 'o'), u8=True)
    out = results[0]['retouched']
    assert out.shape == (96, 128, 3)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out * 255, np.round(out * 255), atol=1e-3)
    ref = ev.eval_batched([p], output_dir=str(tmp_path / 'f'))
    assert np.abs(out - np.clip(ref[0]['retouched'], 0, 1)).mean() < 0.02


def test_fused_dispatch_training(tmp_path_factory):
    # cfg.iters_per_dispatch > 1: whole stretches of plain iterations run
    # as one fused scan dispatch; bookkeeping (ckpt, logs) still happens
    root = tmp_path_factory.mktemp('models_fused')
    cfg = load_config('test').copy()
    cfg.name = 'test/fused'
    cfg.max_iter_step = 12
    cfg.iters_per_dispatch = 5
    cfg.checkpoint_interval = 10
    from exposure_jax.core.trainer import Trainer
    trainer = Trainer(cfg, restore=False, model_root=str(root))
    metrics = trainer.train()
    if trainer.tee:
        trainer.tee.close()
    assert int(trainer.state.step) == 13
    assert metrics is not None
    assert np.isfinite(np.asarray(metrics.g_loss))
    assert trainer.latest_checkpoint() is not None
    run_dir = os.path.join(str(root), 'test', 'fused')
    assert os.path.exists(os.path.join(run_dir, 'metrics.jsonl'))
