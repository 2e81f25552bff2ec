"""Exploration-fix flagship + mid-training entropy re-spike.

The second untried remedy for the replay-pool lock-in tail
(DIVERSITY.md addendum 3, VERDICT r3 item 1; see
``config_synthetic_inject`` for the problem statement): instead of
keeping off-policy states flowing into the pool, briefly RE-OPEN the
policy's own exploration after the first family has converged — a
triangular bump in the entropy-bonus decay coefficient centered at 50%
of training (models/agent.py ``entropy_respike``).  At the bump peak
the effective coefficient is 1.5x the run-start value (0.5 residual
linear decay + 1.0 bump), enough to melt a premature argmax without
resetting parameter heads.

Validate: ``python -m exposure_jax.tools.validate_parity --config
synthetic_respike --seeds 0 1 2 3 4 --out PARITY_RESPIKE.json``
(bar from VERDICT r3: min >= 0.58, mean >= 0.62).
"""

from exposure_jax.utils.config import load_config

cfg = load_config('synthetic_explore')

cfg.entropy_respike = 1.0
cfg.entropy_respike_center = 0.5
cfg.entropy_respike_width = 0.15
