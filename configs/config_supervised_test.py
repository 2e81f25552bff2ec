"""Tiny supervised-mode config: paired (input, ground-truth) synthetic
data, MSE reward, no critic updates (reference cfg.supervised,
net.py:100-102, 360-364)."""

from exposure_jax.data import SyntheticDataProvider
from exposure_jax.data.synthetic import PairedSyntheticDataProvider
from exposure_jax.utils.config import load_config

cfg = load_config('test')

cfg.supervised = True
cfg.citers = 2          # critic-phase program shape (never invoked)
cfg.critic_burst = 0

cfg.fake_data_provider = lambda: PairedSyntheticDataProvider(
    n=64, size=80, seed=0, output_size=64, augmentation=0.3,
    default_batch_size=cfg.batch_size)

cfg.fake_data_provider_test = lambda: PairedSyntheticDataProvider(
    n=32, size=80, seed=1, output_size=64, augmentation=0.0,
    default_batch_size=cfg.batch_size)

# the real/target provider is only used for visualization in this mode
cfg.real_data_provider = lambda: SyntheticDataProvider(
    n=64, size=64, style='retouched', seed=2,
    output_size=64, augmentation=1.0,
    default_batch_size=cfg.batch_size)
