"""Time the fused replay kernel against XLA's plain jnp chain on the GPU.

  python -m exposure_jax.tools.bench_replay [--batch 512] [--res 512]
      [--steps 5] [--reps 20] [--run synthetic_explore/best]

Both sides replay the same trajectories: ids and parameters planned by
the trained policy of ``--run`` on the config's own test images (the
serving action mix), tiled to the batch.  Cases: full-resolution replay
in uint8 and float32, and the 64x64 proxy step of the serving plan (one
step on float32 proxies).  Each case is compiled and its outputs are
checked against each other (``ops/chain.py::replay_mismatch``); the
tool exits non-zero, after printing the case, when they differ by more
than the replay tolerance.  Timings are the median of ``--reps`` calls,
each ending in ``block_until_ready``.  Prints one JSON line per case
with the device it ran on; exits non-zero when no GPU is present.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def gpu_line():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def time_call(fn, args, reps):
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def planned_mix(run, batch, steps):
    """(cfg, filters, ids [K, B], params [K, B, P]) planned by a trained
    policy on its config's test images."""
    from exposure_jax.core.artifacts import restore_for_serving
    from exposure_jax.core.rollout import serve_rollout
    from exposure_jax.core.trainer import build_models, init_train_state
    from exposure_jax.utils.config import load_config

    cfg = load_config(run.split('/', 1)[0])
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    state, _, _ = restore_for_serving(run, state)
    base, _ = cfg.fake_data_provider_test().get_next_batch(64)
    ids, params, _ = jax.jit(lambda p, x, k: serve_rollout(
        policy, p, x, k, cfg=cfg, filters=filters, num_steps=steps))(
            state.gen_params, jnp.asarray(np.clip(base, 0, 1)),
            jax.random.PRNGKey(0))
    reps = -(-batch // ids.shape[1])
    ids = jnp.tile(ids, (1, reps))[:, :batch]
    params = jnp.tile(params, (1, reps, 1))[:, :batch]
    return cfg, filters, ids, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--res', type=int, default=512)
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--run', default='synthetic_explore/best')
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != 'gpu':
        sys.exit('bench_replay measures the GPU; found %s' % jax.devices())

    from exposure_jax.ops.chain import (
        replay_filter_chain,
        replay_mismatch,
        rounding_spread,
    )
    from exposure_jax.ops.pallas_chain import pallas_apply_filter_chain

    card = gpu_line()
    dev = jax.devices()[0]
    cfg, filters, ids, params = planned_mix(args.run, args.batch,
                                            args.steps)
    counts = np.bincount(np.asarray(ids).ravel(),
                         minlength=len(filters)) / ids.size
    print('# action mix: ' + ', '.join(
        '%s %.2f' % (f.get_short_name(), c)
        for f, c in zip(filters, counts)))

    def kernel(img, i, p):
        return pallas_apply_filter_chain(img, i, p, filters)

    def xla(img, i, p):
        return replay_filter_chain(img, i, p, filters)

    def spread(img, i, p):
        return rounding_spread(img, i, p, filters)

    key = jax.random.PRNGKey(1)
    b, r = args.batch, args.res
    full = jax.random.uniform(key, (b, r, r, 3), jnp.float32) * 0.9
    proxy = jax.random.uniform(
        key, (b, cfg.source_img_size, cfg.source_img_size, 3),
        jnp.float32) * 0.9
    cases = [
        ('full_u8', (full * 255).astype(jnp.uint8), ids, params),
        ('full_f32', full, ids, params),
        ('proxy_step_f32', proxy, ids[:1], params[:1]),
    ]
    failed = []
    for name, img, i, p in cases:
        fk, fx = jax.jit(kernel), jax.jit(xla)
        got, ref = fk(img, i, p), fx(img, i, p)
        worst, n_bad, _ = replay_mismatch(got, ref)
        if n_bad and img.dtype == jnp.float32:
            # the chain's own spread: three more chain passes, so only
            # when some value needs the allowance
            worst, n_bad, _ = replay_mismatch(
                got, ref, jax.jit(spread)(img, i, p))
        if n_bad:
            failed.append(name)
        t_k = time_call(fk, (img, i, p), args.reps)
        t_x = time_call(fx, (img, i, p), args.reps)
        print(json.dumps({
            'case': name, 'shape': list(img.shape),
            'steps': int(i.shape[0]),
            'kernel_ms': t_k * 1e3, 'xla_ms': t_x * 1e3,
            'max_error': worst, 'n_over_tolerance': n_bad,
            'device': {'platform': dev.platform, 'kind': dev.device_kind,
                       'count': len(jax.devices())},
            'card': card}), flush=True)
    if failed:
        sys.exit('kernel and jnp chain differ beyond the replay tolerance: '
                 '%s' % failed)


if __name__ == '__main__':
    main()
