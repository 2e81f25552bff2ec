"""Exploration-fix flagship + STRONGER replay-pool off-policy injection.

``config_synthetic_inject`` (replay_inject_prob=0.1) lifted the 5-seed
worst case from 0.50 to 0.569 at equal mean (PARITY_INJECT.json) — just
under the VERDICT r3 bar of min >= 0.58.  The mid-training entropy
re-spike was refuted outright (PARITY_RESPIKE.json), leaving injection
dose as the remaining dial on the measured mechanism (the replay pool
sees only the locked-in family's states, DIVERSITY.md addendum 3/4).

This config doubles the dose: 20% of records per generator step carry a
forced uniform-random action (surrogate zeroed — still strictly
off-policy for the policy gradient; the critic/value distribution is
what changes), injection off after 75% of training as before.

Validate: ``python -m exposure_jax.tools.validate_parity --config
synthetic_inject2 --seeds 0 1 2 3 4 --out PARITY_INJECT2.json``
(bar: min >= 0.58, mean >= 0.62).
"""

from exposure_jax.utils.config import load_config

cfg = load_config('synthetic_explore')

cfg.replay_inject_prob = 0.2
cfg.replay_inject_until = 0.75
