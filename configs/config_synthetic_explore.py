"""Flagship synthetic config + the validated exploration fix.

The 3-seed intervention campaign on textured data
(`config_synthetic_tex_explore`, PARITY_EXPLORE.json) confirmed the
generator-side lock-in diagnosis: holding the policy's action entropy
up 4x longer (``exploration_penalty`` 0.05 -> 0.2) moved EVERY
previously-locked seed into the high-quality region (avg intersection
0.30/0.39/0.36 -> 0.59/0.56/0.69; saturation std 0.25 -> 0.04) — with
Ct usage unchanged, i.e. the lock-in was premature PARAMETER confidence,
not filter identity.  This config applies the same single-knob fix to
the plain (narrow-target) flagship stand-in to measure generalization
across data distributions; the reference default (0.05,
config_example.py parity) is untouched elsewhere.

Validate with ``python -m exposure_jax.tools.validate_parity --config
synthetic_explore --seeds 0 1 2 3 4`` and compare to PARITY_RUNS.json.
"""

from exposure_jax.utils.config import load_config

cfg = load_config('synthetic')

cfg.exploration_penalty = 0.2
