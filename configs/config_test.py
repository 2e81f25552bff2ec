"""Tiny synthetic config for tests / smoke training: same architecture as
config_example but a procedural dataset, small batch and few iterations.
Runs in seconds on the CPU backend."""

from exposure_jax.data import SyntheticDataProvider
from exposure_jax.utils.config import load_config

cfg = load_config('example')

cfg.batch_size = 16
cfg.replay_memory_size = 32
cfg.num_samples = 16
cfg.max_iter_step = 20
cfg.critic_initialization = 1
cfg.citers = 2
cfg.critic_burst = 4
cfg.summary_freq = 5
cfg.write_image_interval = 0
cfg.warmup_giters = 6
cfg.checkpoint_interval = 2
# single-dispatch in tests (the fused/pipelined path has its own
# dedicated tests: test_e2e.py::test_fused_dispatch_training)
cfg.iters_per_dispatch = 1
cfg.dispatch_pipeline_depth = 0

# shrunken networks for fast CPU compilation
cfg.base_channels = 16
cfg.feature_extractor_dims = 1024
cfg.fc1_size = 32

cfg.fake_data_provider = lambda: SyntheticDataProvider(
    n=64, size=80, style='raw', seed=0,
    output_size=64, augmentation=0.3,
    default_batch_size=cfg.batch_size)

cfg.fake_data_provider_test = lambda: SyntheticDataProvider(
    n=32, size=80, style='raw', seed=1,
    output_size=64, augmentation=0.0,
    default_batch_size=cfg.batch_size)

cfg.real_data_provider = lambda: SyntheticDataProvider(
    n=64, size=64, style='retouched', seed=2,
    output_size=64, augmentation=1.0,
    default_batch_size=cfg.batch_size)
