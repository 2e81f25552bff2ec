"""Exploration-fix flagship + replay-pool off-policy injection.

Round-3 closed the catastrophic bimodality (entropy bonus 4x,
``config_synthetic_explore``) but left a 0.50 tail: 1 in 5 seeds still
converges visibly worse (PARITY_EXPLORE_FLAGSHIP.json min 0.50, mean
0.63).  The measured mechanism (DIVERSITY.md addendum 3) is replay-pool
lock-in — the pool fills exclusively with the converged family's own
trajectories, so neither the critic nor the policy gradient ever sees
states outside the family again.

This config tests the first untried remedy from the diagnosis: with
probability ``replay_inject_prob`` per record per generator step the
action is forced to a uniform-random filter (models/agent.py).  The
forced records are off-policy — their score-function surrogate is
zeroed, so the policy is NOT pulled toward random actions — but their
trajectories land in the replay pool, keeping out-of-family states in
the critic's and value net's training distribution for the whole run.

Validate: ``python -m exposure_jax.tools.validate_parity --config
synthetic_inject --seeds 0 1 2 3 4 --out PARITY_INJECT.json`` and
compare min/mean avg-intersection to PARITY_EXPLORE_FLAGSHIP.json
(bar from VERDICT r3: min >= 0.58, mean >= 0.62).
"""

from exposure_jax.utils.config import load_config

cfg = load_config('synthetic_explore')

cfg.replay_inject_prob = 0.1
# keep injecting until the entropy bonus has fully decayed; the final
# 25% of training runs pure on-policy so convergence is undisturbed
cfg.replay_inject_until = 0.75
