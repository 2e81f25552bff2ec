"""Host-side streaming-assembly roofline probe (no JAX, no accelerator).

Measures what bounds the streaming training input pipeline on THIS
host: the native hostloader's crop/flip bundle assembly rate
(``hl_sample_crops``, exposure_jax/native/hostloader.cpp) versus the
host's raw memcpy bandwidth, with an OpenMP thread-scaling curve
(each thread count runs in a fresh subprocess so libgomp picks up
OMP_NUM_THREADS at load).

The reference has no comparable path at all — its input pipeline is a
single Python thread re-stacking numpy crops from an in-RAM array
(reference data_provider.py:59-118, util.py:596-645).

Usage:
  python -m exposure_jax.tools.bench_host_assembly \
      [--pack-gb 1] [--threads 1 2 4] [--out assembly_roofline.json]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def make_pack(path, gigabytes, size=80, seed=0, chunk=2048):
    bytes_per = size * size * 3 * 4
    n = max(int(gigabytes * (1 << 30) // bytes_per), chunk)
    if os.path.exists(path):
        try:
            hdr = np.lib.format.open_memmap(path, mode='r')
            ok = hdr.shape[0] == n and hdr.shape[1] == size
            del hdr
            if ok:
                return path, n
        except (ValueError, OSError):
            pass
    arr = np.lib.format.open_memmap(path, mode='w+', dtype=np.float32,
                                    shape=(n, size, size, 3))
    rng = np.random.RandomState(seed)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        arr[s:e] = rng.rand(e - s, size, size, 3).astype(np.float32)
    arr.flush()
    del arr
    return path, n


def measure_assembly(pack_path, bundle_images, out_size, reps):
    """Runs in the child process: time hl_sample_crops bundle fills."""
    from exposure_jax.data.native_provider import NativePackProvider
    prov = NativePackProvider(pack_path, output_size=out_size,
                              augmentation=0.3, seed=3)
    dest = np.empty((bundle_images, out_size, out_size, 3), np.float32)
    prov.sample_into(dest)  # warm: fault in pack pages, touch dest
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        prov.sample_into(dest)
        times.append(time.perf_counter() - t0)
    prov.close()
    return min(times), float(np.median(times))


def measure_memcpy(nbytes, reps=5):
    src = np.random.rand(nbytes // 8).astype(np.float64)
    dst = np.empty_like(src)
    np.copyto(dst, src)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        times.append(time.perf_counter() - t0)
    return min(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--pack-gb', type=float, default=1.0)
    ap.add_argument('--threads', type=int, nargs='+', default=[1, 2, 4])
    ap.add_argument('--reps', type=int, default=12)
    ap.add_argument('--bundle-images', type=int, default=576,
                    help='images per bundle; default = one flagship '
                         'outer iteration (giters*(2B+P) + citers*B '
                         '= 256 + 320 at B=64, P=128)')
    ap.add_argument('--out-size', type=int, default=64)
    ap.add_argument('--pack-dir', default='data/bench_packs')
    ap.add_argument('--out', default=None)
    ap.add_argument('--child', action='store_true',
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    os.makedirs(args.pack_dir, exist_ok=True)
    pack_path, n = make_pack(
        os.path.join(args.pack_dir, 'assembly_%.1fgb.npy' % args.pack_gb),
        args.pack_gb)

    from exposure_jax.native import library_available
    if not library_available():
        from exposure_jax.native.build import build
        build(verbose=False)

    if args.child:
        best, med = measure_assembly(pack_path, args.bundle_images,
                                     args.out_size, args.reps)
        print(json.dumps({'best_s': best, 'median_s': med}))
        return

    bundle_bytes = args.bundle_images * args.out_size ** 2 * 3 * 4
    host_cpus = os.cpu_count() or 1
    curve = {}
    for t in args.threads:
        # the children measure the host only: keep any JAX they import
        # off the accelerator, which one process per card already holds
        env = dict(os.environ, OMP_NUM_THREADS=str(t), JAX_PLATFORMS='cpu')
        proc = subprocess.run(
            [sys.executable, '-m',
             'exposure_jax.tools.bench_host_assembly', '--child',
             '--pack-gb', str(args.pack_gb),
             '--bundle-images', str(args.bundle_images),
             '--out-size', str(args.out_size),
             '--reps', str(args.reps), '--pack-dir', args.pack_dir],
            env=env, capture_output=True, text=True, timeout=600)
        line = proc.stdout.strip().splitlines()[-1]
        r = json.loads(line)
        curve[t] = {
            'assembly_ms': round(r['median_s'] * 1000, 3),
            'gb_per_s': round(bundle_bytes / r['median_s'] / (1 << 30),
                              2),
        }
        print('OMP_NUM_THREADS=%d: %.2f ms/bundle (%.2f GB/s)'
              % (t, r['median_s'] * 1000, curve[t]['gb_per_s']),
              flush=True)

    memcpy_s = measure_memcpy(bundle_bytes)
    report = {
        'host_cpus': host_cpus,
        'bundle_images': args.bundle_images,
        'bundle_mb': round(bundle_bytes / (1 << 20), 1),
        'pack_images': n,
        'memcpy_ms': round(memcpy_s * 1000, 3),
        'memcpy_gb_per_s': round(bundle_bytes / memcpy_s / (1 << 30), 2),
        'threads': curve,
    }
    t1 = curve.get(1, next(iter(curve.values())))
    report['assembly_vs_memcpy'] = round(
        t1['assembly_ms'] / report['memcpy_ms'], 2)
    print(json.dumps(report))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=1)
        print('# wrote', args.out)


if __name__ == '__main__':
    main()
