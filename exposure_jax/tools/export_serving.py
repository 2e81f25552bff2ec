"""Export a trained run's policy as a durable serving artifact.

Usage:
    python -m exposure_jax.tools.export_serving --run <config>/<run> \
        [--out artifacts/serving/<config>--<run>.npz] [--verify]

Writes the gen_params-only artifact (core/artifacts.py; f32 by
default — bit-exact restore) and, with ``--verify``, round-trips it:
restores the artifact into a fresh template state, checks every leaf
against the checkpoint, then plans one small batch with both parameter
sets and reports how many filter-id decisions differ — the
serving-visible effect of any precision cast (0 at f32; ~3%% of
near-tie argmax decisions at f16, measured on synthetic_explore/best).
"""

import argparse
import os
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--run', required=True,
                    help='<config>/<run> under models/')
    ap.add_argument('--out', default=None)
    ap.add_argument('--verify', action='store_true')
    ap.add_argument('--model-root', default='models')
    ap.add_argument('--dtype', default='float32',
                    choices=('float32', 'float16'),
                    help='float32 (default): bit-exact restore; '
                         'float16: half the size, ~3%% of near-tie '
                         'argmax decisions flip')
    args = ap.parse_args()

    import jax
    from exposure_jax.core.artifacts import (
        export_serving_artifact,
        restore_serving_artifact,
    )
    from exposure_jax.core.checkpoint import restore_checkpoint
    from exposure_jax.core.trainer import build_models, init_train_state
    from exposure_jax.utils.config import load_config

    cfg = load_config(args.run.split('/', 1)[0])
    cfg.name = args.run
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, seed=0)
    state, step = restore_checkpoint(
        os.path.join(args.model_root, args.run), state)
    path = export_serving_artifact(args.run, state, step, args.out,
                                   dtype=args.dtype)
    print('# exported %s (step %d) -> %s (%.1f MB)'
          % (args.run, step, path, os.path.getsize(path) / 1e6))

    if args.verify:
        tmpl, _ = init_train_state(cfg, policy, critic, value, seed=0)
        restored, rstep = restore_serving_artifact(path, tmpl)
        assert rstep == step, (rstep, step)
        src = jax.tree_util.tree_leaves(state.gen_params)
        dst = jax.tree_util.tree_leaves(restored.gen_params)
        worst = max(float(np.max(np.abs(np.asarray(a, np.float32)
                                        - np.asarray(b))))
                    for a, b in zip(src, dst))
        print('# verify: %d leaves, worst |f32 - f16| = %.3e'
              % (len(src), worst))

        # serving-visible check: plan a small batch with both parameter
        # sets; argmax decisions should be (near-)identical
        from exposure_jax.core.rollout import rollout
        import jax.numpy as jnp
        prov = cfg.fake_data_provider_test()
        base, _ = prov.get_next_batch(32)
        proxy = jnp.asarray(np.clip(base, 0.0, 1.0), jnp.float32)
        if proxy.ndim == 5:
            proxy = proxy[:, 0]
        proxy = jax.image.resize(
            proxy, (proxy.shape[0], cfg.source_img_size,
                    cfg.source_img_size, 3), 'linear')
        key = jax.random.PRNGKey(0)
        fn = jax.jit(lambda p: rollout(policy, p, proxy, key, cfg=cfg,
                                       filters=filters,
                                       is_train=0).filter_ids)
        ids_a = np.asarray(fn(state.gen_params))
        ids_b = np.asarray(fn(restored.gen_params))
        mism = float((ids_a != ids_b).mean())
        print('# verify: filter-id decision mismatch %.4f (%d/%d)'
              % (mism, int((ids_a != ids_b).sum()), ids_a.size))
        if mism > 0.02:
            print('# WARNING: f16 artifact shifts >2%% of decisions',
                  file=sys.stderr)
            return 1
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
