"""Flagship-architecture config on procedural data: validates end-to-end
learning dynamics (EMD convergence, pool health) in environments without
the FiveK download (zero-egress dev / CI on the accelerator)."""

from exposure_jax.data import SyntheticDataProvider
from exposure_jax.utils.config import load_config

cfg = load_config('example')

# amortize per-dispatch host latency: up to 100 plain iterations per fused
# call (bit-identical to single dispatch; metrics come back stacked per
# iteration so the 10-iter logging cadence is preserved, core/steps.py);
# bookkeeping is pipelined 2 chunks behind dispatch (core/trainer.py)
cfg.iters_per_dispatch = 100
cfg.dispatch_pipeline_depth = 2

cfg.fake_data_provider = lambda: SyntheticDataProvider(
    n=2048, size=80, style='raw', seed=0,
    output_size=64, augmentation=0.3,
    default_batch_size=cfg.batch_size)

cfg.fake_data_provider_test = lambda: SyntheticDataProvider(
    n=256, size=80, style='raw', seed=1,
    output_size=64, augmentation=0.0,
    default_batch_size=cfg.batch_size)

cfg.real_data_provider = lambda: SyntheticDataProvider(
    n=2048, size=64, style='retouched', seed=2,
    output_size=64, augmentation=1.0,
    default_batch_size=cfg.batch_size)
