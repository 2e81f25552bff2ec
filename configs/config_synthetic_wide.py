"""Flagship architecture on procedural data with WIDENED targets.

The 5-seed quality campaign (PARITY_RUNS.json, DIVERSITY.md addendum)
showed the default procedural target set is narrow enough along the
contrast/saturation axes that two reward-equivalent policy families
coexist: gentle per-channel color curves (match the targets, high
histogram intersection) and a uniform aggressive cosine-contrast remap
(overshoots them, low intersection) — the source of the bimodal quality
stats.  Real artist sets are broad along those axes, so a policy that
over-concentrates its outputs gets penalized by the WGAN critic's
density estimate.  This config reproduces that pressure on the stand-in:
targets are drawn with ``spread=1.0`` (per-image Ct-axis strength in
[-0.5, 0.9], chroma boost ~[0.8, 2.3], tone gamma ~[0.45, 1.18];
data/synthetic.py make_synthetic_pack).

Inputs (raw style) are unchanged, so runs are comparable input-side with
config_synthetic; only the target distribution (and hence metric
reference) differs.  Validate with
``python -m exposure_jax.tools.validate_parity --config synthetic_wide``.
"""

from exposure_jax.data import SyntheticDataProvider
from exposure_jax.utils.config import load_config

cfg = load_config('synthetic')

cfg.real_data_provider = lambda: SyntheticDataProvider(
    n=2048, size=64, style='retouched', seed=2, spread=1.0,
    output_size=64, augmentation=1.0,
    default_batch_size=cfg.batch_size)
