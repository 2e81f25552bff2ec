#!/usr/bin/env python3
"""Train a retouching agent: ``python3 train.py <config> <run-name>``.

CLI parity with the reference train.py:9-14 (same positional arguments,
same ``models/<config>/<run>`` layout).  Extra optional flags are
additions (resume, device count)."""

import argparse

from exposure_jax.utils.config import load_config
from exposure_jax.core.trainer import Trainer


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('config')
    parser.add_argument('run_name')
    parser.add_argument('--resume', action='store_true',
                        help='resume from the latest checkpoint')
    parser.add_argument('--num-devices', type=int, default=None)
    args = parser.parse_args()

    cfg = load_config(args.config)
    cfg.name = args.config + '/' + args.run_name
    trainer = Trainer(cfg, restore=False, num_devices=args.num_devices)
    if args.resume and trainer.latest_checkpoint() is not None:
        trainer.restore()
    trainer.train()


if __name__ == '__main__':
    main()
