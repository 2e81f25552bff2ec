"""Action-trajectory parity of the selected-branch serving plan.

``core/rollout.py::serve_rollout`` (the serving plan) advances the
64px proxy through the chain replay on the SELECTED branch only,
instead of the training formulation's 8-candidate bank + one-hot blend
(reference agent.py:58-77,124-125 — differentiability machinery serving
doesn't need).  Proxies therefore differ from the bank plan by the
replay-vs-jnp tolerance, which can flip argmax actions at near-tie pdf
margins.  This probe measures how often that actually happens on a
TRAINED checkpoint (confident pdfs), with the platform's replay
(ops/pallas_chain.py ``select_chain_replay``).

Usage:
  python -m exposure_jax.tools.probe_selected_plan \
      [--run synthetic_explore/best] [--batch 512] [--batches 4] \
      [--out selplan.json]
"""

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--run', default='synthetic_explore/best')
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--batches', type=int, default=4)
    ap.add_argument('--f32', action='store_true',
                    help='compare the f32 plans instead of the serving '
                         'default bf16 plans')
    ap.add_argument('--out', default='selplan.json')
    args = ap.parse_args()

    from exposure_jax.core.artifacts import restore_for_serving
    from exposure_jax.core.rollout import rollout, serve_rollout
    from exposure_jax.core.trainer import build_models, init_train_state
    from exposure_jax.ops.pallas_chain import select_chain_replay
    from exposure_jax.utils.config import load_config

    cfg = load_config(args.run.split('/', 1)[0])
    cfg.name = args.run
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, seed=0)
    state, step, src = restore_for_serving(args.run, state)
    print('# restored %s at step %d (%s)' % (args.run, step, src),
          file=sys.stderr)

    prov = cfg.fake_data_provider_test()
    base, _ = prov.get_next_batch(args.batch)
    proxy = jnp.asarray(np.clip(base, 0.0, 1.0))
    proxy = jax.image.resize(
        proxy, (args.batch, cfg.source_img_size, cfg.source_img_size, 3),
        method='linear')
    gp = state.gen_params
    use_bf16 = not args.f32
    if use_bf16:
        gp = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16), gp)
        proxy = proxy.astype(jnp.bfloat16)

    bank = jax.jit(lambda p, im, k: rollout(
        policy, p, im, k, cfg=cfg, filters=filters,
        is_train=0).filter_ids)
    replay = select_chain_replay()
    sel = jax.jit(lambda p, im, k: serve_rollout(
        policy, p, im, k, cfg=cfg, filters=filters, replay=replay)[0])

    agree = tot = 0
    per_step = None
    for s in range(args.batches):
        k = jax.random.PRNGKey(100 + s)
        a = np.asarray(bank(gp, proxy, k))
        b = np.asarray(sel(gp, proxy, k))
        if per_step is None:
            per_step = np.zeros(a.shape[0], np.int64)
        per_step += (a == b).sum(axis=1)
        agree += int((a == b).sum())
        tot += a.size
    report = {
        'run': args.run, 'batch': args.batch, 'batches': args.batches,
        'bf16': use_bf16, 'ids_total': int(tot),
        'ids_agree': int(agree),
        'agreement': round(agree / tot, 6),
        'per_step_agreement': [
            round(float(x) / (args.batch * args.batches), 6)
            for x in per_step],
    }
    with open(args.out, 'w') as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    print('# wrote %s' % args.out, file=sys.stderr)


if __name__ == '__main__':
    main()
