"""Attribute the outer-training-iteration cost on the real device.

The flagship outer iteration (cfg.giters G-phase + cfg.citers C-phase
updates, ONE fused dispatch — core/steps.py) is decomposed here with
dependency-CHAINED slope timing (state/pool feed the next call; a tiny
metric fetch forces completion, and fixed costs cancel):

  outer_ms          full (giters, citers) iteration
  g_phase_ms        (giters, 0) — rollout + losses + 3 Adam updates
  c_phase_ms        (0, citers) — critic updates incl. WGAN-GP
  c_single_ms       (0, 1)
  sampling_ms       the 3 fake + 1 real augmented batch samples alone

g_phase + c_phase ≈ outer is the decomposition sanity check (each phase
re-pays the fixed dispatch overhead, so a small surplus is expected).

Usage: python -m exposure_jax.tools.bench_train_split
           [--config synthetic] [--n-small 10] [--n-big 40]
           [--out PROFILE_SPLIT.json]
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def chained_slope(call, state, pool, key, n_small, n_big, rounds=2):
    """Slope of chained dispatch wall-clock; completion forced by a
    scalar fetch of the final metrics."""

    def span(n):
        st, pl = state, pool
        t0 = time.time()
        m = None
        for i in range(n):
            st, pl, m = call(st, pl, jax.random.fold_in(key, i))
        np.asarray(jax.tree_util.tree_leaves(m)[0]).ravel()[:1]
        return time.time() - t0

    span(max(4, n_small // 2))  # warmup (compile already done by caller)
    t_s = min(span(n_small) for _ in range(rounds))
    t_b = min(span(n_big) for _ in range(rounds))
    return max((t_b - t_s) / (n_big - n_small), 1e-9)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', default='synthetic')
    ap.add_argument('--n-small', type=int, default=10)
    ap.add_argument('--n-big', type=int, default=40)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()

    from exposure_jax.core.steps import build_outer_step
    from exposure_jax.core.trainer import Trainer
    from exposure_jax.data import DevicePack, sample_batch
    from exposure_jax.utils.config import load_config

    cfg = load_config(args.config)
    cfg.name = '%s/bench-split' % args.config
    trainer = Trainer(cfg, restore=False)
    state, pool = trainer.state, trainer.pool
    fake, real = trainer.fake_images, trainer.real_images
    fake_meta, real_meta = trainer.fake_meta, trainer.real_meta
    gi, ci = cfg.giters, cfg.citers
    key = jax.random.PRNGKey(7)
    lr = jnp.float32(1e-5)
    prog = jnp.float32(0.5)

    results = {}
    mixes = {'outer_ms': (gi, ci), 'g_phase_ms': (gi, 0),
             'c_phase_ms': (0, ci), 'c_single_ms': (0, 1)}
    for name, (g, c) in mixes.items():
        step = build_outer_step(cfg, trainer.policy, trainer.critic,
                                trainer.value, trainer.filters,
                                trainer.tx, trainer.mesh, fake_meta,
                                real_meta, g, c)

        def call(st, pl, k, _s=step):
            return _s(st, pl, fake, real, k, lr, lr, prog)

        t0 = time.time()
        jax.block_until_ready(call(state, pool, key))
        compile_s = time.time() - t0
        ms = chained_slope(call, state, pool, key, args.n_small,
                           args.n_big) * 1000
        results[name] = round(ms, 3)
        print('%-14s %8.3f ms   (first call %.1fs)'
              % (name, ms, compile_s), flush=True)

    # data sampling alone: the per-iteration augmented batches
    # (3x fake batch/pool + citers real), serialized via a carry scalar
    b, p = cfg.batch_size, cfg.replay_memory_size
    fk_size, fk_aug = fake_meta
    rl_size, rl_aug = real_meta

    @jax.jit
    def sample_only(carry, k):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        s = carry
        for kk, n in ((k1, b), (k2, b), (k3, p)):
            batch = sample_batch(DevicePack(fake, fk_size, fk_aug), kk, n)
            s = s + batch.ravel()[0]
        for i in range(ci):
            batch = sample_batch(
                DevicePack(real, rl_size, rl_aug),
                jax.random.fold_in(k4, i), b)
            s = s + batch.ravel()[0]
        return s

    s0 = jnp.float32(0.0)
    jax.block_until_ready(sample_only(s0, key))

    def span(n):
        s = s0
        t0 = time.time()
        for i in range(n):
            s = sample_only(s, jax.random.fold_in(key, i))
        np.asarray(s)
        return time.time() - t0

    span(5)
    t_s = min(span(args.n_small) for _ in range(2))
    t_b = min(span(args.n_big) for _ in range(2))
    results['sampling_ms'] = round(
        max((t_b - t_s) / (args.n_big - args.n_small), 1e-9) * 1000, 3)
    print('%-14s %8.3f ms' % ('sampling_ms', results['sampling_ms']))

    results['decomposition_surplus_ms'] = round(
        results['g_phase_ms'] + results['c_phase_ms']
        - results['outer_ms'], 3)

    # ---- fused-chunk slope: the DEVICE-ONLY per-iteration cost -------
    # Single-iteration programs above include per-dispatch host
    # overhead.  Timing ONE dispatch of an n-iteration fused program at
    # two sizes and taking (T(n2)-T(n1))/(n2-n1) cancels dispatch cost
    # exactly and leaves pure device compute per iteration.
    from exposure_jax.core.steps import build_fused_iterations_step
    n1, n2 = 10, 40
    for name, (g, c) in (('fused_outer_ms', (gi, ci)),
                         ('fused_g_ms', (gi, 0)),
                         ('fused_c_ms', (0, ci))):
        per_n = {}
        for n in (n1, n2):
            fstep = build_fused_iterations_step(
                cfg, trainer.policy, trainer.critic, trainer.value,
                trainer.filters, trainer.tx, trainer.mesh, fake_meta,
                real_meta, g, c, n)
            idx = jnp.arange(n, dtype=jnp.int32)
            lrs = jnp.full((n,), 1e-5, jnp.float32)
            progs = jnp.full((n,), 0.5, jnp.float32)

            def call(st, pl, k, _s=fstep, _i=idx, _l=lrs, _p=progs):
                return _s(st, pl, fake, real, k, _i, _l, _l, _p)

            jax.block_until_ready(call(state, pool, key))

            def span(reps):
                st, pl = state, pool
                t0 = time.time()
                m = None
                for i in range(reps):
                    st, pl, m = call(st, pl, jax.random.fold_in(key, i))
                np.asarray(jax.tree_util.tree_leaves(m)[0]).ravel()[:1]
                return time.time() - t0

            span(3)
            per_n[n] = min(span(6) for _ in range(2)) / 6
        ms = (per_n[n2] - per_n[n1]) / (n2 - n1) * 1000
        results[name] = round(ms, 3)
        print('%-16s %8.3f ms/iter (device-only, fused-chunk slope)'
              % (name, ms), flush=True)
    results['fused_surplus_ms'] = round(
        results['fused_g_ms'] + results['fused_c_ms']
        - results['fused_outer_ms'], 3)
    print(json.dumps(results))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(results, f, indent=1)


if __name__ == '__main__':
    main()
