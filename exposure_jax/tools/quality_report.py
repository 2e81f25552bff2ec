"""Quantitative quality report for a trained run.

Retouches a batch of held-out inputs with the trained policy and reports
the histogram-intersection metric (SURVEY.md §2 #34) between output and
target distributions, before vs after retouching — the "did training
actually move the distribution toward the artist" check.

Usage: python -m exposure_jax.tools.quality_report <config> <run-name>
       [--n 256] [--ckpt STEP]
"""

import argparse
import json

import jax
import numpy as np

from exposure_jax.core.evaluator import Evaluator
from exposure_jax.tools.histogram_intersection import compare_image_sets
from exposure_jax.utils.config import load_config


def quality_report(cfg, n=256, ckpt=None, model_root='models', seed=0,
                   state=None):
    fake_test = cfg.fake_data_provider_test()
    supervised = bool(cfg.get('supervised', False))
    if supervised:
        # paired provider: [B, 2, S, S, C] (input, ground truth) — score
        # against the pixel-aligned ground truth set
        pairs, _ = fake_test.get_next_batch(n)
        inputs, targets = pairs[:, 0], pairs[:, 1]
    else:
        real = cfg.real_data_provider()
        inputs, _ = fake_test.get_next_batch(n)
        targets, _ = real.get_next_batch(n)

    ev = Evaluator(cfg, model_root=model_root, ckpt=ckpt, state=state)
    traj, applied = ev.plan_trajectory(inputs, jax.random.PRNGKey(seed))
    outputs = np.asarray(traj.final_image)

    before = compare_image_sets(np.clip(inputs, 0, 1),
                                np.clip(targets, 0, 1))
    after = compare_image_sets(np.clip(outputs, 0, 1),
                               np.clip(targets, 0, 1))
    report = {
        'n': n,
        'intersection_before': [round(float(x), 4) for x in before],
        'intersection_after': [round(float(x), 4) for x in after],
        'avg_before': round(float(np.mean(before)), 4),
        'avg_after': round(float(np.mean(after)), 4),
        'avg_steps_applied': round(float(np.mean(applied)), 2),
    }
    if supervised:
        report['mse_before'] = round(float(
            np.mean((np.clip(inputs, 0, 1) - targets) ** 2)), 5)
        report['mse_after'] = round(float(
            np.mean((np.clip(outputs, 0, 1) - targets) ** 2)), 5)
    return report


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('config')
    parser.add_argument('run_name')
    parser.add_argument('--n', type=int, default=256)
    parser.add_argument('--ckpt', type=int, default=None)
    args = parser.parse_args()
    cfg = load_config(args.config)
    cfg.name = args.config + '/' + args.run_name
    print(json.dumps(quality_report(cfg, n=args.n, ckpt=args.ckpt)))


if __name__ == '__main__':
    main()
