"""Network definitions in plain ``jax.lax``: policy (generator), critic
and value CNNs.

Architecture parity with the reference:

- ``FeatureExtractor``: the agent CNN (reference agent.py:11-37) — input
  minus 0.5, stride-2 4x4 convs with lrelu(0.2) doubling channels from
  ``base_channels`` down to a 4x4 map whose channel count is
  ``output_dim / 16``, flattened to ``output_dim`` and passed through
  dropout.  NOTE: the reference applies dropout *unconditionally* (even at
  eval time, agent.py:36); trajectory diversity at test time comes from
  dropout, not from the z noise (reference README.md:76-79).  We keep that
  behavior: callers must always provide a ``dropout`` rng.
- ``PolicyNet``: shared feature extractor -> per-filter 2-layer heads
  (fc 128 lrelu -> n_params + n_mask_params raw outputs, reference
  filters.py:28-44) plus a *separate* feature extractor -> fc 128 -> fc K
  for action selection (reference agent.py:80-99).
- ``CriticNet``: hand-crafted stats channels (luminance mean/variance,
  saturation) + optional state channels appended to the image, a conv
  stack with NO normalization, then fc 128 lrelu -> fc 1 (reference
  critics.py:6-98).  The same module doubles as the value network when
  ``states`` is passed (reference net.py:76-90, config_example.py:100).

All dense/conv kernels use Glorot-uniform initialization to match
tf.contrib.layers defaults (xavier_initializer); biases start at zero.

Each module has the two-call contract the rest of the code uses:
``variables = net.init(rngs, *inputs)`` and
``net.apply(variables, *inputs, rngs={'dropout': key})``, where
``variables = {'params': tree}``.  Parameter names follow the layer
naming the checkpoints carry (``shared_extractor/Conv_0/kernel``,
``filter_3_fc2/bias``, ``Dense_1/kernel``, ...): convs and dense layers
without an explicit name are numbered per module in call order.
"""

import dataclasses
import zlib
from typing import Sequence

import jax
import jax.numpy as jnp

from exposure_jax.utils.ops import lrelu

_glorot = jax.nn.initializers.glorot_uniform()


class _Layers:
    """Creates (init) or reads (apply) the parameters of one module while
    its forward function runs, so both share one description of the
    architecture.  Unnamed layers are numbered per kind in call order."""

    def __init__(self, params=None, key=None, dropout_key=None):
        self.creating = params is None
        self.params = {} if params is None else params
        self._key = key
        self._dropout_key = dropout_key
        self._counts = {}

    def scope(self, name):
        def derive(key):
            if key is None:
                return None
            return jax.random.fold_in(key, zlib.crc32(name.encode()))

        sub = _Layers(None if self.creating else self.params[name],
                      derive(self._key), derive(self._dropout_key))
        if self.creating:
            self.params[name] = sub.params
        return sub

    def _layer(self, kind, name, kernel_shape):
        if name is None:
            n = self._counts.get(kind, 0)
            self._counts[kind] = n + 1
            name = '%s_%d' % (kind, n)
        if self.creating:
            k = jax.random.fold_in(self._key, zlib.crc32(name.encode()))
            self.params[name] = {
                'kernel': _glorot(k, kernel_shape, jnp.float32),
                'bias': jnp.zeros(kernel_shape[-1:], jnp.float32)}
        p = self.params[name]
        return p['kernel'], p['bias']

    def conv(self, x, features, name=None):
        """4x4 stride-2 SAME conv, NHWC input and HWIO kernel."""
        kernel, bias = self._layer('Conv', name,
                                   (4, 4, x.shape[-1], features))
        dt = jnp.result_type(x, kernel)
        y = jax.lax.conv_general_dilated(
            x.astype(dt), kernel.astype(dt), window_strides=(2, 2),
            padding='SAME', dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
        return y + bias.astype(dt)

    def dense(self, x, features, name=None):
        kernel, bias = self._layer('Dense', name, (x.shape[-1], features))
        dt = jnp.result_type(x, kernel)
        return x.astype(dt) @ kernel.astype(dt) + bias.astype(dt)

    def dropout(self, x, keep_prob):
        if keep_prob >= 1.0:
            return x
        if keep_prob <= 0.0:
            return jnp.zeros_like(x)
        if self._dropout_key is None:
            raise ValueError("dropout needs rngs={'dropout': key}")
        keep = jax.random.bernoulli(self._dropout_key, keep_prob, x.shape)
        return jnp.where(keep, x / keep_prob, jnp.zeros_like(x))


def _split_rngs(rngs):
    """(params key, dropout key) from a key or a {'params', 'dropout'}
    dict."""
    if isinstance(rngs, dict):
        return rngs.get('params'), rngs.get('dropout')
    return rngs, None


class _Module:
    """init/apply around a ``_forward(layers, *inputs)`` definition."""

    def init(self, rngs, *inputs):
        key, dropout_key = _split_rngs(rngs)
        if dropout_key is None:
            dropout_key = key
        layers = _Layers(key=key, dropout_key=dropout_key)
        self._forward(layers, *inputs)
        return {'params': layers.params}

    def apply(self, variables, *inputs, rngs=None):
        _, dropout_key = _split_rngs(rngs or {})
        return self._forward(_Layers(variables['params'],
                                     dropout_key=dropout_key), *inputs)


@dataclasses.dataclass(frozen=True)
class FeatureExtractor(_Module):
    """Strided-conv feature pyramid -> flat feature vector with dropout."""

    output_dim: int
    base_channels: int = 32
    dropout_keep_prob: float = 0.5
    min_feature_map_size: int = 4

    def _forward(self, layers, x):
        assert self.output_dim % (self.min_feature_map_size ** 2) == 0
        x = x - 0.5
        size = x.shape[2]
        channels = self.base_channels
        x = lrelu(layers.conv(x, channels))
        size //= 2
        while size > self.min_feature_map_size:
            if size == self.min_feature_map_size * 2:
                channels = self.output_dim // (self.min_feature_map_size ** 2)
            else:
                channels *= 2
            x = lrelu(layers.conv(x, channels))
            size //= 2
        x = x.reshape((x.shape[0], self.output_dim))
        return layers.dropout(x, self.dropout_keep_prob)


@dataclasses.dataclass(frozen=True)
class PolicyNet(_Module):
    """Produces per-filter raw parameter vectors and selector logits.

    The actual filter application / sampling / state-machine logic lives in
    ``exposure_jax.models.agent.agent_step`` so it can be reused by the
    high-resolution replay path with the same weights.
    """

    filter_output_dims: Sequence[int]  # n_params + n_mask_params per filter
    feature_extractor_dims: int = 4096
    base_channels: int = 32
    fc1_size: int = 128
    dropout_keep_prob: float = 0.5

    def _extractor(self):
        return FeatureExtractor(self.feature_extractor_dims,
                                self.base_channels, self.dropout_keep_prob)

    def _forward(self, layers, enriched):
        shared = self._extractor()._forward(
            layers.scope('shared_extractor'), enriched)
        raw_params = []
        for j, out_dim in enumerate(self.filter_output_dims):
            h = lrelu(layers.dense(shared, self.fc1_size,
                                   name='filter_%d_fc1' % j))
            raw_params.append(layers.dense(h, out_dim,
                                           name='filter_%d_fc2' % j))
        sel = self._extractor()._forward(
            layers.scope('selector_extractor'), enriched)
        sel = lrelu(layers.dense(sel, self.fc1_size, name='selector_fc1'))
        logits = layers.dense(sel, len(self.filter_output_dims),
                              name='selector_fc2')
        return raw_params, logits


def critic_stats(images):
    """Hand-crafted stats: [lum mean, lum variance, saturation mean]
    (reference critics.py:47-74)."""
    lum = (images[..., 0] * 0.27 + images[..., 1] * 0.67 +
           images[..., 2] * 0.06 + 1e-5)
    luminance = jnp.mean(lum, axis=(1, 2))
    contrast = jnp.var(lum, axis=(1, 2))
    clipped = jnp.clip(images, 0.0, 1.0)
    i_max = jnp.max(clipped, axis=3)
    i_min = jnp.min(clipped, axis=3)
    sat = (i_max - i_min) / (jnp.minimum(i_max + i_min, 2.0 - i_max - i_min)
                             + 1e-2)
    saturation = jnp.mean(sat, axis=(1, 2))
    return jnp.stack([luminance, contrast, saturation], axis=1)


@dataclasses.dataclass(frozen=True)
class CriticNet(_Module):
    """WGAN critic / value network with stats (+state) channels."""

    base_channels: int = 32
    fc1_size: int = 128

    def _forward(self, layers, images, states=None):
        stat = critic_stats(images)
        if states is None:
            states = stat
        else:
            states = jnp.concatenate([states, stat], axis=1)
        # Broadcast per-image scalars as constant channels
        # (reference critics.py:82-87).
        bcast = states[:, None, None, :] + images[:, :, :, 0:1] * 0
        x = jnp.concatenate([images, bcast], axis=3)

        x = x - 0.5
        size = x.shape[2]
        channels = self.base_channels
        x = lrelu(layers.conv(x, channels))
        size //= 2
        while size > 4:
            channels *= 2
            size //= 2
            x = lrelu(layers.conv(x, channels))
        x = x.reshape((x.shape[0], 4 * 4 * channels))
        x = lrelu(layers.dense(x, self.fc1_size))
        return layers.dense(x, 1)
