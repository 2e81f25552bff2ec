#!/usr/bin/env python3
"""Smoke test of exposure-jax on one NVIDIA GPU: the quickest proof that
the system still starts and computes right on the card.

  python chip_smoke.py               # one card: phases (a)-(d)
  python chip_smoke.py --four-cards  # four cards: phase (e) only

Phases, each printing its own lines; any failure exits non-zero:
  (a) device: JAX's devices, the card's name and power limit
      (nvidia-smi), the JAX version, XLA_FLAGS and the compile cache.
      Fails unless JAX runs on a GPU.
  (b) the tests marked ``gpu`` (tests/test_pallas_chain.py), then
      replay kernel parity at real widths: the Triton-compiled chain
      kernel against the jnp chain (ops/chain.py) on identical ids and
      params — each filter alone and the identity, random 5-step mixes,
      masked filters (Vignet, Level), and one 2x3000x4500 batch.
  (c) serving: RetouchPipeline on the trained synthetic_explore/best
      artifact, 512x512 uint8, batch 64, 4 batches; one batch checked
      row by row against the jnp chain on its own plan.
  (d) training: the Trainer on the flagship synthetic config (batch 64,
      1 G+V update and 5 critic updates per iteration), several fused
      dispatches timed under XLA's default flags; a checkpoint restored
      bit for bit; the next dispatch from the restored state, and the
      same dispatch repeated, within a bound of the uninterrupted one.
  (e) --four-cards: a 4-card data-parallel training dispatch with the
      replicated parameters checked bit-identical on every card, and a
      4-way sharded serving batch checked against the jnp chain.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from exposure_jax.ops.chain import (
    F32_TOL,
    SPREAD_FACTOR,
    U8_TOL,
    replay_filter_chain,
    replay_mismatch,
    rounding_spread,
)
from exposure_jax.ops.pallas_chain import pallas_apply_filter_chain
from exposure_jax.utils.config import load_config

# (d): bound on how far one training dispatch may end from another
# started from the same state (relative L2 difference of the updates;
# repeats under XLA's default GPU kernels differed by up to 2.5e-5 on an
# H100, PERF.md)
UPDATE_TOL = 1e-3

# parity phase: batch and side of the square cases; the large batch
SQUARE = (8, 512)
LARGE = (2, 3000, 4500)
# serving phase: batch, resolution, batches streamed
SERVING = (64, 512, 4)


def log(msg):
    print(msg, flush=True)


def phase_device(n_cards):
    devs = jax.devices()
    log('(a) devices: %s' % devs)
    if devs[0].platform != 'gpu':
        raise SystemExit('(a) FAIL: JAX runs on %r, not a GPU'
                         % devs[0].platform)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    log('(a) device_kind: %s, count %d' % (devs[0].device_kind, len(devs)))
    log('(a) card: %s' % card.replace('\n', ' | '))
    log('(a) jax %s, XLA_FLAGS=%r, compile cache %s' % (
        jax.__version__, os.environ.get('XLA_FLAGS', ''),
        jax.config.jax_compilation_cache_dir))
    if len(devs) < n_cards:
        raise SystemExit('(a) FAIL: need %d cards, JAX sees %d'
                         % (n_cards, len(devs)))
    return card.splitlines()[0]


def random_plan(rng, filters, k, b, fixed_id=None):
    """(ids [K, B], regressed params [K, B, max_p], masks [K, B, M])."""
    from exposure_jax.ops.filters import max_filter_parameters
    max_p = max_filter_parameters(filters)
    n_ids = len(filters) + 1  # the last id is the identity
    ids = np.full((k, b), fixed_id, np.int32) if fixed_id is not None \
        else rng.randint(0, n_ids, (k, b)).astype(np.int32)
    params = np.zeros((k, b, max_p), np.float32)
    for f_id, f in enumerate(filters):
        n = f.get_num_filter_parameters()
        raw = jnp.asarray(rng.randn(k * b, n).astype(np.float32))
        reg = np.asarray(f.filter_param_regressor(raw)).reshape(k, b, n)
        params[..., :n] = np.where((ids == f_id)[..., None], reg,
                                   params[..., :n])
    masks = rng.randn(k, b, 6).astype(np.float32)
    return ids, params, masks


def compare(name, got, ref_and_spread):
    """Hold the kernel's output to the jnp chain's under the replay
    tolerance (ops/chain.py); fail on any value outside it."""
    ref, spread = ref_and_spread
    worst, n_bad, n_eased = replay_mismatch(got, ref, spread)
    if np.asarray(got).dtype == np.uint8:
        log('(b) %-30s u8  max %d LSB, %d values over %d LSB'
            % (name, worst, n_bad, U8_TOL))
    else:
        log('(b) %-30s f32 max abs err %.3e, %d values over %.0e, %d '
            'within %dx the chain\'s own spread'
            % (name, worst, n_bad, F32_TOL, n_eased, SPREAD_FACTOR))
    if n_bad:
        if spread is not None:
            err = np.abs(np.asarray(got) - np.asarray(ref))
            for i in np.argsort(err.ravel())[::-1][:3]:
                log('(b)   err %.3e, ref %.6e, chain spread %.3e'
                    % (err.ravel()[i], np.asarray(ref).ravel()[i],
                       np.asarray(spread).ravel()[i]))
        raise SystemExit('(b) FAIL: %s' % name)


def phase_card_tests():
    """The card-only tests, in this process (a second JAX process could
    not get the card's memory)."""
    import pytest

    # tests/conftest.py defaults JAX_PLATFORMS to cpu when unset
    os.environ.setdefault('JAX_PLATFORMS', 'cuda')
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(['-q', '-m', 'gpu', '-p', 'no:cacheprovider',
                      os.path.join(here, 'tests', 'test_pallas_chain.py')])
    if rc != 0:
        raise SystemExit('(b) FAIL: card tests, pytest exit code %d' % rc)


def phase_kernel_parity():
    rng = np.random.RandomState(0)
    cfg = load_config('synthetic')
    filters = [f(cfg) for f in cfg.filters]
    mcfg = load_config('masked')
    mfilters = [f(mcfg) for f in mcfg.filters]

    def kernel(fs):
        return jax.jit(lambda img, i, p, m: pallas_apply_filter_chain(
            img, i, p, fs, mask_params=m if fs[0].use_masking() else None))

    def reference(fs):
        # the jnp chain's result and, for float32, its own rounding
        # spread; it has no identity id, and skips a step through
        # active_steps instead
        def fn(img, i, p, m):
            args = (img, jnp.where(i < len(fs), i, 0), p, fs,
                    (i < len(fs)).astype(jnp.float32),
                    m if fs[0].use_masking() else None)
            spread = None if img.dtype == jnp.uint8 else \
                rounding_spread(*args)
            return replay_filter_chain(*args), spread
        return jax.jit(fn)

    k_fn, r_fn = kernel(filters), reference(filters)
    km_fn, rm_fn = kernel(mfilters), reference(mfilters)
    t0 = time.perf_counter()
    b, side = SQUARE
    sq = '%dx%dx%d' % (b, side, side)
    base = rng.rand(b, side, side, 3).astype(np.float32) * 0.9
    for dtype in ('u8', 'f32'):
        img = jnp.asarray((base * 255).astype(np.uint8) if dtype == 'u8'
                          else base)
        cases = [(f.get_short_name(), f_id)
                 for f_id, f in enumerate(filters)]
        cases.append(('identity', len(filters)))
        for name, f_id in cases:
            ids, params, masks = random_plan(rng, filters, 1, b, f_id)
            args = (img, ids, params, masks)
            compare('%s %s' % (sq, name), k_fn(*args), r_fn(*args))
        for trial in range(3):
            ids, params, masks = random_plan(rng, filters, 5, b)
            args = (img, ids, params, masks)
            compare('%s 5-step mix %d' % (sq, trial), k_fn(*args),
                    r_fn(*args))
        ids, params, masks = random_plan(rng, mfilters, 5, b)
        args = (img, ids, params, masks)
        compare('%s masked mix' % sq, km_fn(*args), rm_fn(*args))
        for name in ('VignetFilter', 'LevelFilter'):
            f_id = [type(f).__name__ for f in mfilters].index(name)
            ids, params, masks = random_plan(rng, mfilters, 1, b, f_id)
            args = (img, ids, params, masks)
            compare('%s masked %s' % (sq, name), km_fn(*args),
                    rm_fn(*args))
    big = rng.rand(*LARGE, 3).astype(np.float32) * 0.9
    for dtype in ('u8', 'f32'):
        img = jnp.asarray((big * 255).astype(np.uint8) if dtype == 'u8'
                          else big)
        ids, params, masks = random_plan(rng, filters, 5, LARGE[0])
        args = (img, ids, params, masks)
        compare('%dx%dx%d 5-step mix' % LARGE, k_fn(*args), r_fn(*args))
    log('(b) kernel parity ok in %.1f s (compiles included)'
        % (time.perf_counter() - t0))


def serving_inputs(cfg, batch, res):
    base, _ = cfg.fake_data_provider_test().get_next_batch(batch)
    imgs = jax.image.resize(jnp.asarray(np.clip(base, 0.0, 1.0)),
                            (batch, res, res, 3), method='linear')
    return (imgs * 255).astype(jnp.uint8)


def check_rows(tag, out, imgs, ids, params, mask, filters, masking):
    ref = replay_filter_chain(imgs, ids, params, filters,
                              mask_params=mask if masking else None)
    diff = np.abs(np.asarray(out).astype(np.int32) -
                  np.asarray(ref).astype(np.int32))
    worst = diff.reshape(diff.shape[0], -1).max(axis=1)
    log('%s rows vs jnp chain on their own plan: max %d LSB (%d rows)'
        % (tag, worst.max(), len(worst)))
    if worst.max() > 1:
        raise SystemExit('%s FAIL: rows %s off by more than 1 LSB'
                         % (tag, np.nonzero(worst > 1)[0].tolist()))


def phase_serving(card):
    from exposure_jax.core.serving import RetouchPipeline

    cfg = load_config('synthetic_explore')
    cfg.name = 'synthetic_explore/best'
    batch, res, n_batches = SERVING
    t0 = time.perf_counter()
    pipe = RetouchPipeline.from_run(cfg)
    imgs = serving_inputs(cfg, batch, res)
    out, (ids, params, mask) = jax.block_until_ready(
        pipe.plan_and_replay(imgs))
    compile_s = time.perf_counter() - t0
    check_rows('(c)', out, imgs, ids, params, mask, pipe.filters,
               bool(cfg.masking))

    t0 = time.perf_counter()
    last = None
    for last in pipe.map_batches((imgs for _ in range(n_batches)),
                                 device_out=True):
        pass
    jax.block_until_ready(last)
    rate = batch * n_batches / (time.perf_counter() - t0)
    assert last.shape == imgs.shape and last.dtype == jnp.uint8

    # information only: TF32 convolutions can flip near-tie argmaxes
    with jax.default_matmul_precision('highest'):
        hi = jax.jit(pipe.program(imgs.shape, imgs.dtype))
        _, (ids_hi, _, _) = hi(pipe.state.gen_params, imgs,
                               jax.random.PRNGKey(0), 0)
    agree = float((np.asarray(ids) == np.asarray(ids_hi)).mean())
    log('(c) plan id agreement with a highest-precision plan: %.4f'
        % agree)
    log('(c) serving %dx%d u8 batch %d: first batch %.1f s (compile '
        'included), %.1f img/s over %d batches [%s]'
        % (res, res, batch, compile_s, rate, n_batches, card))


def flagship_trainer(model_root, iters_per_dispatch):
    from exposure_jax.core.trainer import Trainer

    cfg = load_config('synthetic')
    cfg.name = 'synthetic/chip-smoke'
    # plain iterations only: no critic bursts, no checkpoint or
    # visualization boundaries inside the smoke run
    cfg.critic_initialization = 0
    cfg.iters_per_dispatch = iters_per_dispatch
    cfg.checkpoint_interval = 10 ** 6
    cfg.write_image_interval = 0
    cfg.dispatch_pipeline_depth = 0
    trainer = Trainer(cfg, model_root=model_root)
    trainer.tee.close()
    # start after iteration 0 (the lr-0 warmup burst is its own program)
    trainer.state = trainer.state.replace(step=np.int32(1))
    return trainer


def train_to(trainer, last_iter):
    trainer.cfg.max_iter_step = last_iter
    metrics = trainer.train()
    for name, v in metrics._asdict().items():
        if not np.isfinite(np.asarray(v)).all():
            raise SystemExit('training FAIL: %s = %s' % (name, v))
    jax.block_until_ready(trainer.state)
    return metrics


def update_divergence(before, a, b):
    """How far two dispatches from the state ``before`` ended apart:
    ``(worst, leaf)``, the largest relative L2 difference of their
    updates (``a - before`` against ``b - before``) over the float leaves.
    Integer leaves (step and update counters) must be equal."""
    worst = (0.0, '-')
    for key, x0 in before.items():
        if not np.issubdtype(x0.dtype, np.floating):
            if not np.array_equal(a[key], b[key]):
                return np.inf, key
            continue
        da = a[key].astype(np.float64) - x0
        db = b[key].astype(np.float64) - x0
        scale = np.linalg.norm(da)
        rel = (np.linalg.norm(da - db) / scale if scale
               else (0.0 if not np.any(db) else np.inf))
        if rel > worst[0]:
            worst = (rel, key)
    return worst


def phase_training(card):
    from exposure_jax.core.checkpoint import (
        flatten_tree,
        restore_checkpoint,
        save_checkpoint,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    from exposure_jax.core.trainer import init_train_state

    n = 5
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        trainer = flagship_trainer(root, n)
        cfg = trainer.cfg
        log('(d) flagship synthetic: batch %d, extractor %d-d, giters %d, '
            'citers %d, %d iterations per dispatch' % (
                cfg.batch_size, cfg.feature_extractor_dims, cfg.giters,
                cfg.citers, n))
        train_to(trainer, n)  # iterations 1..5: one fused dispatch
        log('(d) setup + first dispatch %.1f s (compile included)'
            % (time.perf_counter() - t0))
        t0 = time.perf_counter()
        m = train_to(trainer, 3 * n)  # two more fused dispatches
        ms = 1e3 * (time.perf_counter() - t0) / (2 * n)
        log('(d) %.1f ms/iter over 2 fused dispatches, g_loss %.4f, '
            'emd %.4f [%s]' % (ms, float(m.g_loss), float(m.emd), card))

        # checkpoint fidelity: the restored state is the saved one, bit
        # for bit
        state, pool, step = trainer.state, trainer.pool, int(
            trainer.state.step)
        save_checkpoint(trainer.dir, state, step)
        template, _ = init_train_state(cfg, trainer.policy, trainer.critic,
                                       trainer.value, seed=1)
        template = jax.device_put(template,
                                  NamedSharding(trainer.mesh, P()))
        restored, got = restore_checkpoint(trainer.dir, template)
        saved, back = flatten_tree(state), flatten_tree(restored)
        differ = [k for k in saved if got != step or
                  saved[k].dtype != back[k].dtype or
                  not np.array_equal(saved[k], back[k])]
        if differ:
            raise SystemExit('(d) FAIL: restored checkpoint differs from '
                             'the saved state at %s' % differ[:5])
        log('(d) checkpoint at step %d: %d leaves restored bit-equal'
            % (step, len(saved)))

        # the next dispatch, twice from the state and once from the
        # restored copy: XLA's default GPU kernels leave the order of some
        # sums open, so runs differ in the last bits; both pairs must stay
        # within UPDATE_TOL
        ends = []
        for start in (state, state, restored):
            trainer.state, trainer.pool = start, pool
            train_to(trainer, step + n - 1)
            ends.append(flatten_tree(trainer.state))
        for what, end in (('repeated', ends[1]), ('resumed', ends[2])):
            worst, leaf = update_divergence(saved, ends[0], end)
            log('(d) %s dispatch vs uninterrupted: updates differ by '
                '%.2e (relative L2, worst leaf %s; bound %.0e)'
                % (what, worst, leaf, UPDATE_TOL))
            if not worst <= UPDATE_TOL:
                raise SystemExit('(d) FAIL: %s dispatch differs' % what)


def phase_four_cards(card):
    from jax.sharding import PartitionSpec as P

    from exposure_jax.core.serving import RetouchPipeline
    from exposure_jax.parallel.mesh import DATA_AXIS, data_parallel_mesh

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        trainer = flagship_trainer(root, 5)
        if trainer.n_dev != 4:
            raise SystemExit('(e) FAIL: trainer mesh has %d devices'
                             % trainer.n_dev)
        m = train_to(trainer, 5)
        log('(e) 4-card fused dispatch (batch %d over %d cards) in %.1f s '
            '(compile included), g_loss %.4f'
            % (trainer.cfg.batch_size, trainer.n_dev,
               time.perf_counter() - t0, float(m.g_loss)))
        for leaf in jax.tree_util.tree_leaves(trainer.state.gen_params):
            shards = [np.asarray(s.data) for s in leaf.addressable_shards]
            if len(shards) != 4 or not all(
                    np.array_equal(shards[0], s) for s in shards[1:]):
                raise SystemExit('(e) FAIL: replicated params differ '
                                 'across cards')
        log('(e) replicated generator params bit-identical on 4 cards')
        state = trainer.state

    cfg = load_config('synthetic_explore')
    pipe = RetouchPipeline(cfg, state)
    mesh = data_parallel_mesh(4)
    batch, res, _ = SERVING
    imgs = serving_inputs(cfg, batch, res)
    program = pipe.program((batch // 4, res, res, 3), jnp.uint8)
    serve = jax.jit(jax.shard_map(
        lambda p, x, k: program(p, x, k, jax.lax.axis_index(DATA_AXIS)),
        mesh=mesh, in_specs=(P(), P(DATA_AXIS), P()),
        out_specs=(P(DATA_AXIS), (P(None, DATA_AXIS),) * 3),
        check_vma=False))
    t0 = time.perf_counter()
    out, (ids, params, mask) = jax.block_until_ready(
        serve(state.gen_params, imgs, jax.random.PRNGKey(0)))
    log('(e) 4-way sharded serving batch of %d in %.1f s (compile '
        'included) [%s]' % (imgs.shape[0], time.perf_counter() - t0, card))
    check_rows('(e)', out, imgs, ids, params, mask, pipe.filters,
               bool(cfg.masking))


def main():
    four = '--four-cards' in sys.argv[1:]
    card = phase_device(4 if four else 1)
    if four:
        phase_four_cards(card)
        count = 4
    else:
        phase_card_tests()
        phase_kernel_parity()
        phase_serving(card)
        phase_training(card)
        count = 1
    dev = jax.devices()[0]
    log('card: %s' % card)
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': count}}), flush=True)


if __name__ == '__main__':
    main()
