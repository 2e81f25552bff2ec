"""Flagship architecture on TEXTURED procedural data — the
structural-realism experiment.

The wide-target campaign (PARITY_WIDE.json, DIVERSITY.md addendum 2)
refuted distribution WIDTH as the missing pressure behind the
contrast/saturation bimodality: on smooth procedural fields an
over-contrasted output is still a plausible smooth field, so the
uniform-Ct policy family stays reward-optimal no matter how wide the
target statistics are.  The diagnosis predicted the real separating
signal is PER-PATCH STRUCTURAL: on real photos, aggressive uniform
contrast blows highlights and blocks shadows into clipped-flat texture
that appears in NO artist-retouched patch.

This config manufactures exactly that signal on the stand-in
(data/synthetic.py ``texture=1.0``): both packs carry
luminance-correlated high-frequency texture, and the 'retouched'
targets are tone-compressed through a soft tanh knee instead of a hard
clip — so no target patch is ever flat.  A Ct-heavy policy then
produces flat saturated patches the convolutional WGAN critic can
separate per-patch.  Prediction under test: the Ct/C policy bimodality
of PARITY_RUNS.json resolves (contrast-intersection std tightens)
without touching the reward, agent, or critic.  Validate with
``python -m exposure_jax.tools.validate_parity --config synthetic_tex``.
"""

from exposure_jax.data import SyntheticDataProvider
from exposure_jax.utils.config import load_config

cfg = load_config('synthetic')

cfg.fake_data_provider = lambda: SyntheticDataProvider(
    n=2048, size=80, style='raw', seed=0, texture=1.0,
    output_size=64, augmentation=0.3,
    default_batch_size=cfg.batch_size)

cfg.fake_data_provider_test = lambda: SyntheticDataProvider(
    n=256, size=80, style='raw', seed=1, texture=1.0,
    output_size=64, augmentation=0.0,
    default_batch_size=cfg.batch_size)

cfg.real_data_provider = lambda: SyntheticDataProvider(
    n=2048, size=64, style='retouched', seed=2, texture=1.0,
    output_size=64, augmentation=1.0,
    default_batch_size=cfg.batch_size)
