"""Diagnose trajectory-diversity: WHY does a trained policy emit few
distinct filter sequences?

Round-2 finding (PARITY_RUNS.json): all seeds reported
``distinct_sequences_frac`` = 8/256 with near-zero W/BW usage.  The
reference's stated test-time diversity mechanism is always-on dropout
perturbing the selector (reference README.md:76-79, agent.py:36), with
ARGMAX selection at test (reference agent.py:113-116) — so low diversity
can mean (a) dropout noise not reaching the selector, (b) a policy
confident enough that argmax is dropout-stable (legitimate), or (c) a
data distribution where unused filters are genuinely useless.

This tool separates those:

1. **Dropout sensitivity**: plan the SAME inputs under different PRNG
   keys (argmax mode).  ``key_flip_frac`` = fraction of images whose
   sequence changes across keys.  >0 proves dropout reaches the
   selector; ~0 would indicate (a).
2. **Policy confidence**: mean/min top-1 probability of the post-mixing
   action pdf per step.  Top-1 near 1-eps explains argmax stability
   as (b), not a bug.
3. **Sampling ceiling**: distinct sequences when SAMPLING from the pdf
   (is_train=1) — the diversity the pdf itself supports.
4. **Gray-shift ablation** for (c): color-cast the eval inputs
   (channel scales) and measure White-Balance usage.  A policy that
   picks W on casted inputs but not on the procedural set shows the
   LOW W USAGE IS DATA-DRIVEN, not a collapse.

Usage:
  python -m exposure_jax.tools.diagnose_diversity \
      --run synthetic/parity-seed0 [--n 256] [--keys 4] \
      [--out DIVERSITY.json]
"""

import argparse
import collections
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np


def sequences_of(ids, applied):
    """Per-image applied-step filter-id tuples."""
    k, b = ids.shape
    return [tuple(ids[:applied[i], i].tolist()) for i in range(b)]


def seq_entropy_bits(seqs):
    counts = collections.Counter(seqs)
    n = sum(counts.values())
    return -sum(c / n * math.log2(c / n) for c in counts.values())


def analyze(cfg, ev, inputs, keys=4, n_sample_keys=2):
    from exposure_jax.core.rollout import rollout

    filters = ev.filters
    short = [f.get_short_name() for f in filters]
    plan = jax.jit(lambda p, im, k, it: rollout(
        ev.policy, p, im, k, cfg=cfg, filters=filters, is_train=it))

    imgs = jnp.asarray(inputs)
    report = {}

    # 1+2: argmax under different dropout keys
    per_key = []
    pdf_top1 = []
    usage_tot = np.zeros(len(filters), np.int64)
    for ki in range(keys):
        traj = plan(ev.state.gen_params, imgs,
                    jax.random.PRNGKey(1000 + ki), jnp.int32(0))
        ids = np.asarray(traj.filter_ids)
        k, b = ids.shape
        applied = np.full((b,), k, np.int32)
        seqs = sequences_of(ids, applied)
        per_key.append(seqs)
        pdfs = np.asarray(traj.pdfs)  # [K, B, F]
        pdf_top1.append(pdfs.max(axis=2))
        for f in range(len(filters)):
            usage_tot[f] += int((ids == f).sum())
    b = len(per_key[0])
    flips = 0
    for i in range(b):
        if len({sk[i] for sk in per_key}) > 1:
            flips += 1
    union = set()
    for sk in per_key:
        union.update(sk)
    top1 = np.concatenate([t.reshape(-1) for t in pdf_top1])
    report['argmax'] = {
        'keys': keys,
        'distinct_frac_per_key': round(
            np.mean([len(set(sk)) / b for sk in per_key]), 4),
        'distinct_union': len(union),
        'key_flip_frac': round(flips / b, 4),
        'pdf_top1_mean': round(float(top1.mean()), 4),
        'pdf_top1_p05': round(float(np.percentile(top1, 5)), 4),
        'filter_usage_frac': {short[f]: round(float(
            usage_tot[f] / usage_tot.sum()), 4)
            for f in range(len(filters))},
    }

    # 3: sampling-mode ceiling
    samp_seqs = []
    for ki in range(n_sample_keys):
        traj = plan(ev.state.gen_params, imgs,
                    jax.random.PRNGKey(2000 + ki), jnp.int32(1))
        ids = np.asarray(traj.filter_ids)
        k, b2 = ids.shape
        samp_seqs.extend(sequences_of(ids, np.full((b2,), k, np.int32)))
    report['sampling'] = {
        'distinct_frac': round(len(set(samp_seqs)) / len(samp_seqs), 4),
        'entropy_bits': round(seq_entropy_bits(samp_seqs), 3),
    }

    # 4: gray-shift ablation — does a color cast summon W?
    w_idx = [f for f, flt in enumerate(filters)
             if type(flt).__name__ == 'ImprovedWhiteBalanceFilter']
    ablations = {}
    for name, scale in (('neutral', (1.0, 1.0, 1.0)),
                        ('warm_cast', (1.35, 1.0, 0.65)),
                        ('cool_cast', (0.65, 1.0, 1.35))):
        cast = jnp.clip(imgs * jnp.asarray(scale), 0.0, 1.0)
        traj = plan(ev.state.gen_params, cast, jax.random.PRNGKey(7),
                    jnp.int32(0))
        ids = np.asarray(traj.filter_ids)
        w_frac = float(np.isin(ids, w_idx).mean()) if w_idx else 0.0
        per_image_w = float(np.isin(ids, w_idx).any(axis=0).mean()) \
            if w_idx else 0.0
        ablations[name] = {
            'w_step_frac': round(w_frac, 4),
            'images_using_w_frac': round(per_image_w, 4),
        }
    report['gray_shift_ablation'] = ablations
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--run', default='synthetic/parity-seed0')
    ap.add_argument('--n', type=int, default=256)
    ap.add_argument('--keys', type=int, default=4)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()

    from exposure_jax.core.evaluator import Evaluator
    from exposure_jax.utils.config import load_config

    config_name, _ = args.run.split('/', 1)
    cfg = load_config(config_name)
    cfg.name = args.run
    ev = Evaluator(cfg)
    prov = cfg.fake_data_provider_test()
    inputs, _ = prov.get_next_batch(args.n)

    report = {'run': args.run, 'n': args.n,
              **analyze(cfg, ev, inputs, keys=args.keys)}
    print(json.dumps(report, indent=1))
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                data = json.load(f)
            existing = data if isinstance(data, list) else [data]
        existing.append(report)
        with open(args.out, 'w') as f:
            json.dump(existing, f, indent=1)
        print('# wrote', args.out)


if __name__ == '__main__':
    main()
