"""Flagship-architecture supervised mode: paired (input, ground-truth)
synthetic data, MSE-distance reward, no critic updates (reference
cfg.supervised, net.py:100-102, 360-364 — shipped but inert there; fully
functional here).  5k iterations converge the paired objective."""

from exposure_jax.data import SyntheticDataProvider
from exposure_jax.data.synthetic import PairedSyntheticDataProvider
from exposure_jax.utils.config import load_config

cfg = load_config('example')

# inherit example's 100-iteration fused dispatch + pipelined bookkeeping
cfg.supervised = True
cfg.critic_burst = 0
cfg.max_iter_step = 5000

cfg.fake_data_provider = lambda: PairedSyntheticDataProvider(
    n=2048, size=80, seed=0, output_size=64, augmentation=0.3,
    default_batch_size=cfg.batch_size)

cfg.fake_data_provider_test = lambda: PairedSyntheticDataProvider(
    n=256, size=80, seed=1, output_size=64, augmentation=0.0,
    default_batch_size=cfg.batch_size)

# the real/target provider is only used for visualization in this mode
cfg.real_data_provider = lambda: SyntheticDataProvider(
    n=2048, size=64, style='retouched', seed=2,
    output_size=64, augmentation=1.0,
    default_batch_size=cfg.batch_size)
