#!/usr/bin/env python3
"""Streaming-pipeline benchmark: train from a multi-GB on-disk pack.

Exercises the scale path for datasets too large for device-memory residency:
a synthetic .npy pack of ``--pack-gb`` gigabytes is generated on disk
(memory-mapped, never fully in RAM), batches are assembled by the native
hostloader (C++/mmap/OpenMP) and double-buffered by the async prefetcher,
and the streaming outer step (core/steps.py:build_streaming_outer_step)
trains from them.  Reports median ms/outer-iter — directly comparable to
bench_train.py's device-resident number — plus the host assembly rate.

The reference's equivalent is its single Python prefetch thread over an
in-RAM array (reference data_provider.py:106-118, util.py:596-645); it
has no out-of-RAM story at all.

Usage: python bench_stream.py [--pack-gb 4] [--iters 100] [--keep-pack]
       [--config example]
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from exposure_jax.core.replay import PoolState
from exposure_jax.core.steps import build_streaming_outer_step
from exposure_jax.core.trainer import build_models, init_train_state
from exposure_jax.data.native_provider import NativePackProvider
from exposure_jax.parallel.mesh import DATA_AXIS, data_parallel_mesh
from exposure_jax.utils.config import load_config
from exposure_jax.utils.prefetch import AsyncPrefetcher


def _flag(name, default, cast=int):
    if name in sys.argv:
        return cast(sys.argv[sys.argv.index(name) + 1])
    return default


def make_disk_pack(path, gigabytes, size=80, seed=0, chunk=1024):
    """Procedural float32 [N, size, size, 3] pack written in chunks via a
    memmap — multi-GB without holding it in RAM."""
    bytes_per = size * size * 3 * 4
    n = max(int(gigabytes * (1 << 30) // bytes_per), chunk)
    if os.path.exists(path):
        try:
            hdr = np.lib.format.open_memmap(path, mode='r')
            if hdr.shape[0] == n and hdr.shape[1] == size:
                del hdr
                return path, n
            del hdr
        except Exception:
            pass
    print('# generating %.1f GB pack (%d images) at %s' %
          (n * bytes_per / (1 << 30), n, path), file=sys.stderr)
    arr = np.lib.format.open_memmap(path, mode='w+', dtype=np.float32,
                                    shape=(n, size, size, 3))
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        k = e - s
        # smooth gradients + noise: cheap but non-constant content
        phase = rng.rand(k, 1, 1, 3).astype(np.float32)
        freq = 1 + rng.rand(k, 1, 1, 3).astype(np.float32) * 3
        base = 0.5 + 0.4 * np.sin(
            2 * np.pi * (freq * (xx + yy)[None, :, :, None] + phase))
        noise = rng.rand(k, size, size, 3).astype(np.float32) * 0.05
        arr[s:e] = np.clip(base * 0.5 + noise, 0.0, 1.0)
    arr.flush()
    del arr
    return path, n


def main():
    pack_gb = _flag('--pack-gb', 4.0, float)
    iters = _flag('--iters', 100)
    pack_dir = _flag('--pack-dir', 'data/bench_packs', str)
    os.makedirs(pack_dir, exist_ok=True)

    from exposure_jax.native import library_available
    if not library_available():
        from exposure_jax.native.build import build
        build(verbose=False)

    fake_path, n_fake = make_disk_pack(
        os.path.join(pack_dir, 'stream_fake_%.1fgb.npy' % pack_gb), pack_gb)
    real_path, n_real = make_disk_pack(
        os.path.join(pack_dir, 'stream_real_1gb.npy'), min(pack_gb, 1.0),
        size=64, seed=7)

    cfg = load_config(_flag('--config', 'example', str))
    mesh = data_parallel_mesh()
    filters, policy, critic, value = build_models(cfg)
    state, tx = init_train_state(cfg, policy, critic, value, 0)

    fake_provider = NativePackProvider(fake_path, output_size=64,
                                       augmentation=0.3, seed=1)
    real_provider = NativePackProvider(real_path, output_size=64,
                                       augmentation=1.0, seed=2)

    shard = NamedSharding(mesh, P(DATA_AXIS))
    pool_imgs = jax.device_put(jnp.asarray(
        fake_provider.get_next_batch(cfg.replay_memory_size)[0]), shard)
    pool = PoolState.create(pool_imgs, cfg.num_state_dim)
    pool = pool.replace(states=jax.device_put(pool.states, shard))

    giters, citers = cfg.giters, cfg.citers
    fuse = _flag('--fuse', 1)
    if fuse > 1:
        from exposure_jax.core.steps import build_streaming_fused_step
        step = build_streaming_fused_step(cfg, policy, critic, value,
                                          filters, tx, mesh, giters=giters,
                                          citers=citers, n_iters=fuse)
    else:
        step = build_streaming_outer_step(cfg, policy, critic, value,
                                          filters, tx, mesh, giters=giters,
                                          citers=citers)

    b, p = cfg.batch_size, cfg.replay_memory_size
    chunk = 2 * b + p

    assembly_times = []
    legacy = '--legacy-assembly' in sys.argv
    debug = '--debug' in sys.argv
    # uint8 bundles: 4x smaller uploads, quantized at native assembly,
    # dequantized inside the jitted step (steps.py _dequant_stream)
    bdt = np.uint8 if '--u8' in sys.argv else np.float32

    def assemble():
        t0 = time.time()
        g_fresh = np.empty((fuse * giters, chunk, 64, 64, 3), bdt)
        if legacy:
            def q(x):
                return (np.clip(x, 0, 1) * 255 + 0.5).astype(bdt) \
                    if bdt == np.uint8 else x
            for i in range(fuse * giters):
                g_fresh[i] = q(fake_provider.get_next_batch(chunk)[0])
            real = q(np.stack([real_provider.get_next_batch(b)[0]
                               for _ in range(fuse * citers)]))
        else:
            # zero-restack path: ONE native call per stream fills the
            # bundle in its final layout (hostloader.cpp hl_sample_crops)
            fake_provider.sample_into(g_fresh.reshape(-1, 64, 64, 3))
            real = np.empty((fuse * citers * b, 64, 64, 3), bdt)
            real_provider.sample_into(real)
            real = real.reshape(fuse * citers, b, 64, 64, 3)
        if fuse > 1:
            g_fresh = g_fresh.reshape((fuse, giters) + g_fresh.shape[1:])
            real = real.reshape((fuse, citers) + real.shape[1:])
        t_np = time.time()
        out = jnp.asarray(g_fresh), jnp.asarray(real)
        t_enq = time.time()
        assembly_times.append(1000 * (t_enq - t0))
        if debug:
            jax.block_until_ready(out)
            print('# assemble: numpy %.0f ms, upload enq %.0f ms, '
                  'upload done +%.0f ms' %
                  (1000 * (t_np - t0), 1000 * (t_enq - t_np),
                   1000 * (time.time() - t_enq)), file=sys.stderr,
                  flush=True)
        return out

    prefetcher = AsyncPrefetcher(assemble, slots=_flag('--slots', 2))
    key = jax.random.PRNGKey(0)

    def dispatch(st, pl, g_fresh, real, i):
        if fuse > 1:
            its = np.arange(i * fuse, (i + 1) * fuse, dtype=np.int32)
            return step(st, pl, g_fresh, real, key, its,
                        np.full((fuse,), 1e-5, np.float32),
                        np.full((fuse,), 5e-5, np.float32),
                        np.asarray(its / 20000, np.float32))
        return step(st, pl, g_fresh, real, jax.random.fold_in(key, i),
                    jnp.float32(1e-5), jnp.float32(5e-5),
                    jnp.float32(i / 20000))

    t_c = time.time()
    g_fresh, real = prefetcher.get_next()
    state, pool, metrics = dispatch(state, pool, g_fresh, real, 0)
    jax.block_until_ready(metrics)
    compile_s = time.time() - t_c

    n_disp = max(iters // fuse, 1)
    times = []
    t_loop = time.time()
    for i in range(n_disp):
        t0 = time.time()
        g_fresh, real = prefetcher.get_next()
        t_get = time.time()
        state, pool, metrics = dispatch(state, pool, g_fresh, real, i + 1)
        t_disp = time.time()
        jax.block_until_ready(metrics)
        t_blk = time.time()
        times.append(1000 * (t_blk - t0) / fuse)
        if debug:
            print('# disp %d: get %.0f ms, call %.0f ms, block %.0f ms'
                  % (i, 1000 * (t_get - t0), 1000 * (t_disp - t_get),
                     1000 * (t_blk - t_disp)), file=sys.stderr, flush=True)
    # force completion: fetch a scalar of the final chained state
    # before closing the wall-clock window
    float(np.asarray(metrics.g_loss).ravel()[-1])
    wall_ms = 1000 * (time.time() - t_loop) / (n_disp * fuse)
    prefetcher.stop()

    ms = max(float(np.median(times)), wall_ms)
    bytes_per_iter = ((giters * chunk + citers * b) * 64 * 64 * 3
                      * np.dtype(bdt).itemsize)
    bundle_bytes = fuse * bytes_per_iter
    print(json.dumps({
        'metric': 'stream_train_outer_iter_ms',
        'value': round(ms, 2),
        'unit': 'ms/iter (streamed from %.1f GB on-disk pack%s)' % (
            pack_gb, ', fused x%d' % fuse if fuse > 1 else ''),
        'vs_baseline': round(300.0 / ms, 2),
        'pack_images': n_fake,
        'iters_per_dispatch': fuse,
        'bundle_dtype': str(np.dtype(bdt)),
        'median_host_assembly_ms': round(float(np.median(assembly_times)),
                                         2),
        'host_assembly_gb_per_s': round(
            bundle_bytes / (np.median(assembly_times) / 1000) / (1 << 30),
            2),
        'wall_ms_per_iter': round(wall_ms, 2),
        'projected_20k_iters_min': round(ms * 20001 / 1000 / 60, 2),
        'compile_s': round(compile_s, 1),
        'g_loss': float(np.asarray(metrics.g_loss).ravel()[-1]),
        'emd': float(np.asarray(metrics.emd).ravel()[-1]),
    }))
    if '--keep-pack' not in sys.argv:
        fake_provider.close()
        real_provider.close()
        os.remove(fake_path)
        os.remove(real_path)


if __name__ == '__main__':
    main()
