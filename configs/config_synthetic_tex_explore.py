"""Textured stand-in + 4x entropy bonus — the generator-side
exploration intervention.

CRITIC_PROBE.json / DIVERSITY.md addendum 3 localized the quality
bimodality to GENERATOR exploration lock-in: seeds settle into a policy
family early (pdf top-1 confidence 0.64-0.79) and cannot hop families,
even though every trained critic scores the better family's outputs as
more real.  Both data-side interventions (spread, texture) were
refuted; this config tests the RL-side one the diagnosis predicts
should work: hold the policy's action entropy up longer so the
selector keeps visiting both families while the critic's preference is
still steep.  ``exploration_penalty`` 0.05 -> 0.2 (the entropy-bonus
coefficient, models/agent.py:165-166 — still linearly decayed to 0
over training, reference agent.py penalty schedule).

Seeds 0/2/3 of PARITY_TEX.json converged to the low-saturation Ct
family (saturation intersection 0.21); success = those same seeds now
finding the high-saturation family (>0.5) under the identical data and
reward.  Validate with ``python -m exposure_jax.tools.validate_parity
--config synthetic_tex_explore --seeds 0 2 3``.
"""

from exposure_jax.utils.config import load_config

cfg = load_config('synthetic_tex')

cfg.exploration_penalty = 0.2
