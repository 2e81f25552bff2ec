from exposure_jax.core.train_state import EmaState, TrainState, make_optimizer
from exposure_jax.core.replay import PoolState


def __getattr__(name):
    # Lazy heavyweight entry points (avoid importing the full training
    # stack for ops-only users).
    if name == 'Trainer':
        from exposure_jax.core.trainer import Trainer
        return Trainer
    if name == 'Evaluator':
        from exposure_jax.core.evaluator import Evaluator
        return Evaluator
    if name == 'RetouchPipeline':
        from exposure_jax.core.serving import RetouchPipeline
        return RetouchPipeline
    raise AttributeError(name)
