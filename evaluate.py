#!/usr/bin/env python3
"""Retouch photos with a trained model:
``python3 evaluate.py <config> <run-name> <image files...>``.

CLI parity with the reference evaluate.py:8-31, including reloading the
config snapshot backed up into ``models/<config>/<run>/scripts/`` as the
source of truth (copied to ``config_tmp.py``)."""

import argparse
import os
import shutil
import sys

from exposure_jax.utils.config import load_config


def evaluate():
    parser = argparse.ArgumentParser()
    parser.add_argument('config')
    parser.add_argument('model_name')
    parser.add_argument('images', nargs='+')
    parser.add_argument('--ckpt', type=int, default=None,
                        help='checkpoint step (default: latest)')
    parser.add_argument('--output-dir', default='./outputs')
    parser.add_argument('--no-step-by-step', action='store_true')
    parser.add_argument('--batched', action='store_true',
                        help='batch inputs by resolution (one rollout + '
                             'one fused replay per resolution group)')
    parser.add_argument('--u8', action='store_true',
                        help='with --batched: replay in uint8 fixed '
                             'point (fastest; trades sub-1/255 shadow '
                             'precision)')
    args = parser.parse_args()

    snapshot = os.path.join('models', args.config, args.model_name,
                            'scripts', 'config_%s.py' % args.config)
    if os.path.exists(snapshot):
        shutil.copy(snapshot, 'config_tmp.py')
        cfg = load_config('tmp')
    else:
        print('Warning: no config snapshot at %s; loading config_%s '
              'directly' % (snapshot, args.config))
        cfg = load_config(args.config)
    cfg.name = args.config + '/' + args.model_name

    from exposure_jax.core.evaluator import Evaluator
    ev = Evaluator(cfg, ckpt=args.ckpt)
    if args.batched:
        ev.eval_batched(spec_files=args.images,
                        output_dir=args.output_dir, u8=args.u8)
    else:
        ev.eval(spec_files=args.images, output_dir=args.output_dir,
                step_by_step=not args.no_step_by_step)


if __name__ == '__main__':
    if len(sys.argv) < 4:
        print('Usage: python3 evaluate.py [config] [model name] '
              '[image files ...]')
        sys.exit(-1)
    evaluate()
