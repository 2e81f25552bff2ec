"""Replay-pool off-policy injection, middle dose (prob = 0.15).

Dose response so far (5 seeds each, avg histogram intersection):

  prob 0.0  (explore):  min 0.50  mean 0.635  (PARITY_EXPLORE_FLAGSHIP)
  prob 0.1  (inject):   min 0.569 mean 0.629  (PARITY_INJECT)
  prob 0.2  (inject2):  min 0.546 mean 0.650, 3/5 seeds >= 0.70
                        (PARITY_INJECT2 — the 0.70-class rate tripled
                        but the hard-draw floor stayed ~0.55)

This config fills in the 0.15 point: does the 0.70-class rate rise
monotonically with dose (pool diversity is the mechanism) or is 0.2
past the optimum (too much off-policy state dilutes the critic's
on-policy discrimination)?  Same injection window as the other doses.

Validate: ``python -m exposure_jax.tools.validate_parity --config
synthetic_inject15 --seeds 0 1 2 3 4 --out PARITY_INJECT15.json``
(compare min/mean and the >= 0.70 count to the table above).
"""

from exposure_jax.utils.config import load_config

cfg = load_config('synthetic_explore')

cfg.replay_inject_prob = 0.15
cfg.replay_inject_until = 0.75
