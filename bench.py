#!/usr/bin/env python3
"""Serving benchmark: 5-step filter-chain inference at 512x512.

Pipeline per batch (the full white-box inference path, matching what the
reference does per image in net.py:796-821 but batched and fused into
one jitted program, ``core/serving.py::RetouchPipeline``):
  1. downsample 512x512 -> 64x64 proxies (on device),
  2. 5-step policy plan on the proxies (one lax.scan),
  3. replay the recorded chains on the 512x512 originals — through the
     fused Pallas kernel on the GPU, or with ``--no-pallas`` through
     XLA's jnp chain (ops/chain.py).

The policy is the trained ``synthetic_explore/best`` run (checkpoint if
present, else the git-tracked serving artifact); without either, fresh
weights on noise images.  Images are uint8 unless ``--f32``.

Timing: the pipeline is compiled and run once, then each of ``RERUNS``
spans times ``N_BATCHES`` streamed batches ending in
``block_until_ready``; the value is the median span's images/s, with the
spread recorded.  Prints one JSON line naming the device it ran on.

Flags:
  --batch N      images per batch (default 512).
  --run C/R      benchmark another trained run.
  --bf16         policy plan in bfloat16.
  --f32          float32 image I/O instead of uint8.
  --no-pallas    replay through XLA's jnp chain instead of the kernel.
"""

import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

N_BATCHES = 20
RERUNS = 3


def _flag_value(name, default):
    if name in sys.argv:
        return sys.argv[sys.argv.index(name) + 1]
    return default


def build_pipeline(batch, res, u8, run, bf16):
    from exposure_jax.core.artifacts import (
        has_trained_params,
        restore_for_serving,
    )
    from exposure_jax.core.serving import RetouchPipeline
    from exposure_jax.core.trainer import build_models, init_train_state
    from exposure_jax.utils.config import load_config

    trained = has_trained_params(run)
    cfg = load_config(run.split('/', 1)[0] if trained else 'example')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, seed=0)
    key = jax.random.PRNGKey(0)
    if trained:
        state, step, src = restore_for_serving(run, state)
        print('# bench: restored %s at step %d (%s)' % (run, step, src),
              file=sys.stderr)
        # representative content: the run's own held-out inputs
        base, _ = cfg.fake_data_provider_test().get_next_batch(batch)
        imgs = jax.image.resize(jnp.asarray(np.clip(base, 0.0, 1.0)),
                                (batch, res, res, 3), method='linear')
    else:
        imgs = jax.random.uniform(key, (batch, res, res, 3)) * 0.8
    if u8:
        imgs = (imgs * 255).astype(jnp.uint8)
    return RetouchPipeline(cfg, state, bf16=bf16), imgs, trained


def main():
    batch = int(_flag_value('--batch', 512))
    res = 512
    run = _flag_value('--run', 'synthetic_explore/best')
    u8 = '--f32' not in sys.argv
    bf16 = '--bf16' in sys.argv
    pipe, imgs, trained = build_pipeline(batch, res, u8, run, bf16)
    xla = '--no-pallas' in sys.argv
    if xla:
        from exposure_jax.ops.chain import replay_filter_chain
        pipe.replay = replay_filter_chain

    def span(n):
        t0 = time.perf_counter()
        out = None
        for out in pipe.map_batches((imgs for _ in range(n)),
                                    device_out=True):
            pass
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    t_compile = span(1)
    values = [batch * N_BATCHES / span(N_BATCHES) for _ in range(RERUNS)]
    dev = jax.devices()[0]
    tags = ('_u8io' if u8 else '') + ('_bf16' if bf16 else '') + \
        ('_trained' if trained else '') + ('_xla' if xla else '')
    print(json.dumps({
        'metric': '512px_images_per_sec_5step_inference' + tags,
        'value': statistics.median(values),
        'unit': 'images/sec',
        'value_min': min(values),
        'value_max': max(values),
        'n_reruns': len(values),
        'first_batch_seconds': t_compile,
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices())},
    }), flush=True)


if __name__ == '__main__':
    main()
