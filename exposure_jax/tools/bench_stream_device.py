"""Pure-device cost of the fused streaming program (no per-call upload).

Uploads TWO stacked bundles once, then chains N fused dispatches over
them (alternating, state chained through), slope-timed with a forced
tiny fetch — isolates the streaming program's device execution cost
from the host-to-device upload.

Usage: python -m exposure_jax.tools.bench_stream_device [--fuse 10]
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from exposure_jax.core.replay import PoolState
from exposure_jax.core.steps import build_streaming_fused_step
from exposure_jax.core.trainer import build_models, init_train_state
from exposure_jax.parallel.mesh import DATA_AXIS, data_parallel_mesh
from exposure_jax.utils.config import load_config


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--fuse', type=int, default=10)
    ap.add_argument('--disp', type=int, default=12)
    ap.add_argument('--warm', type=int, default=3)
    args = ap.parse_args()

    cfg = load_config('example')
    mesh = data_parallel_mesh()
    filters, policy, critic, value = build_models(cfg)
    state, tx = init_train_state(cfg, policy, critic, value, 0)
    b, p = cfg.batch_size, cfg.replay_memory_size
    chunk = 2 * b + p
    giters, citers = cfg.giters, cfg.citers
    fuse = args.fuse

    rng = np.random.RandomState(0)
    shard = NamedSharding(mesh, P(DATA_AXIS))
    pool_imgs = jax.device_put(
        jnp.asarray(rng.rand(p, 64, 64, 3).astype(np.float32)), shard)
    pool = PoolState.create(pool_imgs, cfg.num_state_dim)
    pool = pool.replace(states=jax.device_put(pool.states, shard))

    step = build_streaming_fused_step(cfg, policy, critic, value, filters,
                                      tx, mesh, giters=giters,
                                      citers=citers, n_iters=fuse)

    bundles = []
    for s in range(2):
        g = jax.device_put(jnp.asarray(rng.rand(
            fuse, giters, chunk, 64, 64, 3).astype(np.float32)))
        r = jax.device_put(jnp.asarray(rng.rand(
            fuse, citers, b, 64, 64, 3).astype(np.float32)))
        jax.block_until_ready((g, r))
        bundles.append((g, r))

    key = jax.random.PRNGKey(0)

    def disp(st, pl, i):
        its = np.arange(i * fuse, (i + 1) * fuse, dtype=np.int32)
        g, r = bundles[i % 2]
        return step(st, pl, g, r, key, its,
                    np.full((fuse,), 1e-5, np.float32),
                    np.full((fuse,), 5e-5, np.float32),
                    np.asarray(its / 20000, np.float32))

    t0 = time.time()
    state, pool, m = disp(state, pool, 0)
    float(np.asarray(m.g_loss).ravel()[-1])
    print('# compile+first: %.1f s' % (time.time() - t0), flush=True)

    def run(n, st, pl):
        t0 = time.time()
        m = None
        for i in range(n):
            st, pl, m = disp(st, pl, i + 1)
        float(np.asarray(m.g_loss).ravel()[-1])  # force completion
        return time.time() - t0, st, pl

    t_warm, state, pool = run(args.warm, state, pool)
    t_full, state, pool = run(args.disp, state, pool)
    # slope: (full - warm) over (disp - warm) dispatches
    per_disp = (t_full - t_warm) / max(args.disp - args.warm, 1)
    print(json.dumps({
        'metric': 'stream_fused_device_ms_per_iter',
        'value': round(1000 * per_disp / fuse, 2),
        'ms_per_dispatch': round(1000 * per_disp, 1),
        'fuse': fuse,
        'warm_s': round(t_warm, 2), 'full_s': round(t_full, 2),
    }))


if __name__ == '__main__':
    main()
