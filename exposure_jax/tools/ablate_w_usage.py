"""W-usage ablation: is near-zero White-Balance usage data-driven?

DIVERSITY.json (round 3) shows trained synthetic policies never pick
the White-Balance filter (W), even when eval inputs are artificially
color-casted — but the default procedural training data is perfectly
color-balanced (data/synthetic.py 'raw' style), so W has nothing to
earn reward on DURING TRAINING.  The reference's W filter earns its
keep on real RAW captures with illuminant casts (reference
filters.py:215-244).

This tool closes the loop: train the SAME flagship architecture on
cast-augmented synthetic data (per-image random channel scales,
luminance-renormalized; ``make_synthetic_pack(cast=...)``) against the
same balanced target set, then measure W usage on casted eval inputs.
W usage appearing here proves the near-zero usage on the default data
is a property of the data, not a policy/selector defect.

Usage:
  python -m exposure_jax.tools.ablate_w_usage \
      [--cast 0.35] [--iters 20000] [--n 256] [--out W_ABLATION.json]
"""

import argparse
import json
import time

import jax
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--cast', type=float, default=0.35)
    ap.add_argument('--iters', type=int, default=20000)
    ap.add_argument('--n', type=int, default=256)
    ap.add_argument('--skip-trained', action='store_true')
    ap.add_argument('--drop-filters', nargs='*', default=[],
                    help='short names (e.g. C Ct BW) to REMOVE from the '
                         'bank — with the per-channel Color curve gone, '
                         'W becomes the only cast corrector, isolating '
                         'whether the policy CAN learn it')
    ap.add_argument('--color-curve-range', nargs=2, type=float,
                    default=None, metavar=('LO', 'HI'),
                    help='shrink the C curve\'s per-knot gain range '
                         '(reference default 0.90 1.10) WITHOUT removing '
                         'the filter — the soft version of --drop-filters '
                         'C: a range too narrow to absorb the injected '
                         'cast separates "W is redundant given C" from '
                         '"W head is broken" (VERDICT r3 item 8; the '
                         'hard drop already shows W usage 0->0.2, '
                         'W_ABLATION_NOC.json)')
    ap.add_argument('--inject', type=float, default=0.0,
                    help='replay_inject_prob for the run (off-policy '
                         'forced draws into the replay pool)')
    ap.add_argument('--inject-mode', choices=('uniform', 'anti'),
                    default='uniform',
                    help='anti: force from q ~ 1/(pdf+c) — the policy\'s '
                         'LEAST-picked filters get forced most (round-5 '
                         'targeted remedy for per-filter exploration '
                         'lock-in; models/agent.py)')
    ap.add_argument('--out', default='W_ABLATION.json')
    args = ap.parse_args()

    from exposure_jax.core.evaluator import Evaluator
    from exposure_jax.core.trainer import Trainer
    from exposure_jax.data import SyntheticDataProvider
    from exposure_jax.tools.diagnose_diversity import analyze
    from exposure_jax.utils.config import load_config

    cfg = load_config('synthetic')
    cfg.name = 'synthetic/cast-ablation'
    cfg.max_iter_step = args.iters
    if args.drop_filters:
        drop = set(args.drop_filters)
        cfg.filters = [f for f in cfg.filters
                       if f.short_name not in drop]
        # the agent state layout carries one usage slot per filter
        # (config_example.py: num_state_dim = 3 + len(filters))
        cfg.num_state_dim = 3 + len(cfg.filters)
        cfg.name += '-no' + ''.join(sorted(drop))
    if args.color_curve_range is not None:
        lo, hi = args.color_curve_range
        cfg.color_curve_range = (lo, hi)
        cfg.name += '-c%g_%g' % (lo, hi)
    if args.inject > 0.0:
        cfg.replay_inject_prob = args.inject
        cfg.replay_inject_until = 0.9
        cfg.replay_inject_mode = args.inject_mode
        cfg.name += '-inj%s%g' % (
            'a' if args.inject_mode == 'anti' else '', args.inject)
    cfg.write_image_interval = 2000
    cast = args.cast
    cfg.fake_data_provider = lambda: SyntheticDataProvider(
        n=2048, size=80, style='raw', seed=0, cast=cast,
        output_size=64, augmentation=0.3,
        default_batch_size=cfg.batch_size)
    cfg.fake_data_provider_test = lambda: SyntheticDataProvider(
        n=args.n, size=80, style='raw', seed=1, cast=cast,
        output_size=64, augmentation=0.0,
        default_batch_size=cfg.batch_size)

    t0 = time.time()
    import os
    run_dir = os.path.join('models', cfg.name)
    if args.skip_trained and os.path.isdir(run_dir):
        trainer = Trainer(cfg, restore=True)
        trainer.restore()
        print('# reusing existing run at step %d'
              % int(trainer.state.step))
    else:
        trainer = Trainer(cfg, restore=False)
        trainer.train()
        if trainer.tee:
            trainer.tee.close()
    train_minutes = (time.time() - t0) / 60.0

    ev = Evaluator(cfg, state=trainer.state)
    inputs, _ = cfg.fake_data_provider_test().get_next_batch(args.n)
    report = {
        'cast': args.cast,
        'color_curve_range': list(cfg.color_curve_range),
        'dropped_filters': sorted(args.drop_filters),
        'inject': args.inject,
        'inject_mode': args.inject_mode if args.inject > 0 else None,
        'iters': int(trainer.state.step),
        'train_minutes': round(train_minutes, 1),
        **analyze(cfg, ev, inputs, keys=4),
    }
    print(json.dumps(report, indent=1))
    with open(args.out, 'w') as f:
        json.dump(report, f, indent=1)
    print('# wrote', args.out)


if __name__ == '__main__':
    main()
