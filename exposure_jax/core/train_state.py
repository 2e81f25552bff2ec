"""Training state: three parameter trees, three Adam chains, EMA scalar.

Parity: the reference keeps three ``ly.optimize_loss`` optimizers — value
(lr = value_lr_mul x lr_g), generator (lr_g) and critic (lr_c), all
Adam(beta1=0.5, beta2=0.9) (reference net.py:216-251,
config_example.py:158-161) — plus a zero-debiased ExponentialMovingAverage
(decay 0.99) of the mean critic logit used to center displayed scores
(net.py:119-120, 166-168).

The learning rate is applied OUTSIDE the optax chain (the chain is
scale_by_adam + scale(-1)); the per-iteration lr from the config schedule
callables is multiplied in at update time.  This reproduces the
reference's behavior of feeding the lr per step through a placeholder —
including the iter-0 warmup where lr=0 still updates Adam moments
(net.py:318-328)."""

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax


def pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree whose fields are all
    children, with ``.replace(**changes)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self,
                                                               **changes)
    return jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[])


def make_optimizer(beta1=0.5, beta2=0.9):
    return optax.chain(optax.scale_by_adam(b1=beta1, b2=beta2),
                       optax.scale(-1.0))


def apply_lr_update(tx, grads, opt_state, params, lr):
    """One optimizer step with an externally supplied learning rate."""
    updates, new_opt_state = tx.update(grads, opt_state, params)
    updates = jax.tree_util.tree_map(lambda u: u * lr, updates)
    new_params = optax.apply_updates(params, updates)
    return new_params, new_opt_state


def clip_tree(tree, bound):
    """Clamp every leaf to [-bound, bound] — the WGAN weight-clipping
    fallback used when the gradient penalty is disabled (reference
    net.py:253-266; note biases are clamped too, as there)."""
    return jax.tree_util.tree_map(
        lambda w: jnp.clip(w, -bound, bound), tree)


@pytree_dataclass
class EmaState:
    """Zero-debiased EMA of a scalar (tf.train.ExponentialMovingAverage
    with zero_debias=True, reference net.py:119-120)."""

    biased: jnp.ndarray
    count: jnp.ndarray

    @classmethod
    def create(cls):
        return cls(biased=jnp.zeros(()), count=jnp.zeros((), jnp.int32))

    def update(self, value, decay=0.99):
        biased = self.biased * decay + (1.0 - decay) * value
        return EmaState(biased=biased, count=self.count + 1)

    @property
    def value(self):
        debias = 1.0 - 0.99 ** jnp.maximum(self.count, 1).astype(jnp.float32)
        return jnp.where(self.count > 0, self.biased / debias, 0.0)


@pytree_dataclass
class TrainState:
    gen_params: Any
    val_params: Any
    crit_params: Any
    opt_g: Any
    opt_v: Any
    opt_c: Any
    ema: EmaState
    step: jnp.ndarray

    @classmethod
    def create(cls, gen_params, val_params, crit_params, tx):
        return cls(
            gen_params=gen_params,
            val_params=val_params,
            crit_params=crit_params,
            opt_g=tx.init(gen_params),
            opt_v=tx.init(val_params),
            opt_c=tx.init(crit_params),
            ema=EmaState.create(),
            step=jnp.zeros((), jnp.int32),
        )
