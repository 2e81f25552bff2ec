"""Sintel-style config: retouch toward an arbitrary folder of target
images (parity with reference config_sintel.py, which is config_example
with folder data providers, config_sintel.py:180-191)."""

from exposure_jax.data import FiveKDataProvider, FolderDataProvider
from exposure_jax.utils.config import load_config

cfg = load_config('example')

# Input dataset (train): FiveK RAW
cfg.fake_data_provider = lambda: FiveKDataProvider(
    raw=True,
    bnw=cfg.bnw,
    output_size=64,
    default_batch_size=cfg.batch_size,
    augmentation=0.3,
    set_name='2k_train')

cfg.fake_data_provider_test = lambda: FiveKDataProvider(
    set_name='u_test',
    raw=True,
    bnw=cfg.bnw,
    output_size=64,
    default_batch_size=cfg.batch_size,
    augmentation=0.0)

# Target dataset: frames from the movie (any image folder)
cfg.real_data_provider = lambda: FolderDataProvider(
    folder='data/sintel/outputs',
    default_batch_size=cfg.batch_size)
