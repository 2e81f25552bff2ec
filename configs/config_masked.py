"""Masked-training config: enables the dormant spatial-mask capability on
the flagship synthetic setup (cfg.masking=True, reference
filters.py:101-148, config_example.py:36) and adds the two mask-native
dormant filters — the elliptical Vignet (reference filters.py:341-401)
and Level (filters.py:449-471) — to the bank.

Every filter step becomes spatially modulated: the policy's mask head
emits 6 parameters (5 for the vignette ellipse) defining a sigmoid mask
over (x, y, luminance), and the filter is lerped in by that mask.  The
recorded trajectories carry the raw mask parameters, so white-box replay
(jnp chain and fused Pallas kernel) stays exact at any resolution."""

from exposure_jax.ops.filters import LevelFilter, VignetFilter
from exposure_jax.utils.config import load_config

cfg = load_config('synthetic')

cfg.masking = True
cfg.filters = list(cfg.filters) + [VignetFilter, LevelFilter]
cfg.num_state_dim = 3 + len(cfg.filters)
cfg.z_dim = 3 + len(cfg.filters) * cfg.z_dim_per_filter
