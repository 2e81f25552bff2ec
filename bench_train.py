#!/usr/bin/env python3
"""Secondary benchmark: training iteration throughput on the device.

Measures the steady-state outer iteration (1 generator+value update + 5
critic WGAN-GP updates @ batch 64, the reference's cadence) with the
device-resident pipeline.  Reference: ~300 ms/iter on GTX 1080 Ti
(~100 min for 20k iters, BASELINE.md); target <10 min for 20k iters
(= 30 ms/iter).

Prints one JSON line (not the driver headline; see bench.py for that).
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from exposure_jax.core.replay import PoolState
from exposure_jax.core.steps import build_outer_step
from exposure_jax.core.trainer import build_models, init_train_state
from exposure_jax.data.synthetic import make_synthetic_pack
from exposure_jax.parallel.mesh import DATA_AXIS, data_parallel_mesh
from exposure_jax.utils.config import load_config


def main():
    iters = int(sys.argv[sys.argv.index('--iters') + 1]) \
        if '--iters' in sys.argv else 30
    pack_n = int(sys.argv[sys.argv.index('--pack-n') + 1]) \
        if '--pack-n' in sys.argv else 2048
    cfg = load_config('example')
    mesh = data_parallel_mesh()
    filters, policy, critic, value = build_models(cfg)
    state, tx = init_train_state(cfg, policy, critic, value, 0)

    shard = NamedSharding(mesh, P(DATA_AXIS))
    n = pack_n  # synthetic stand-in for the FiveK pack (--pack-n 8000
    # reproduces the full fold-filtered FiveK footprint in HBM)
    fake = jax.device_put(jnp.asarray(
        make_synthetic_pack(n, 80, 'raw', 0)), shard)
    real = jax.device_put(jnp.asarray(
        make_synthetic_pack(n, 64, 'retouched', 1)), shard)
    pool_imgs = jax.device_put(jnp.asarray(
        make_synthetic_pack(cfg.replay_memory_size, 80, 'raw', 2)
        [:, 8:72, 8:72]), shard)
    pool = PoolState.create(pool_imgs, cfg.num_state_dim)
    pool = pool.replace(states=jax.device_put(pool.states, shard))

    step = build_outer_step(cfg, policy, critic, value, filters, tx, mesh,
                            fake_meta=(64, True), real_meta=(64, True),
                            giters=cfg.giters, citers=cfg.citers)
    key = jax.random.PRNGKey(0)
    t_c = time.time()
    state, pool, metrics = step(state, pool, fake, real, key,
                                jnp.float32(1e-5), jnp.float32(5e-5),
                                jnp.float32(0.0))
    jax.block_until_ready(metrics)
    compile_s = time.time() - t_c

    # SLOPE timing over dependency-CHAINED calls (state feeds the next
    # call), completion forced by fetching a metric scalar: fixed costs
    # (dispatch, the final fetch) cancel in the difference of two
    # run lengths.
    def run(n, state, pool):
        t0 = time.time()
        for i in range(n):
            state, pool, metrics = step(
                state, pool, fake, real, jax.random.fold_in(key, i),
                np.float32(1e-5), np.float32(5e-5),
                np.float32(i / 20000))
        float(np.asarray(metrics.g_loss))  # force completion
        return time.time() - t0, state, pool

    _, state, pool = run(2, state, pool)
    n_small, n_big = max(iters // 6, 2), iters
    t_s = min(run(n_small, state, pool)[0] for _ in range(2))
    t_b = min(run(n_big, state, pool)[0] for _ in range(2))
    ms_per_iter = 1000 * max(t_b - t_s, 1e-9) / (n_big - n_small)
    projected_min = ms_per_iter * 20001 / 1000 / 60
    state, pool, metrics = step(state, pool, fake, real, key,
                                np.float32(1e-5), np.float32(5e-5),
                                np.float32(0.5))
    jax.block_until_ready(metrics)

    print(json.dumps({
        'metric': 'train_outer_iter_ms',
        'value': round(ms_per_iter, 2),
        'unit': 'ms/iter (1 G+V step + %d critic steps, batch %d)' %
                (cfg.citers, cfg.batch_size),
        'vs_baseline': round(300.0 / ms_per_iter, 2),
        'projected_20k_iters_min': round(projected_min, 2),
        'compile_s': round(compile_s, 1),
        'g_loss': float(np.asarray(metrics.g_loss)),
        'emd': float(np.asarray(metrics.emd)),
    }))


if __name__ == '__main__':
    main()
