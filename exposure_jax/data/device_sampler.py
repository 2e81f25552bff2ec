"""On-device batch sampling: the device-resident input pipeline.

The reference streams numpy batches through feed_dicts with a one-slot
prefetch thread (data_provider.py:106-118, util.py:596-645).  Here the
whole (small) dataset pack lives in HBM and every batch is materialized
*inside* the jitted train step: index gather + dynamic-slice random crop +
flip, all on device, zero host involvement.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp


class DevicePack(NamedTuple):
    """A dataset resident on device plus static sampling metadata."""

    images: jnp.ndarray  # [N, H, W, C] float32
    output_size: int     # crop / resize target
    augment: bool        # random crop + flip if True, resize if False


def paired_to_channels(pairs):
    """[N, 2, H, W, C] (input, ground-truth) pairs -> [N, H, W, 2C] so
    crop/flip augmentation applies identically to both halves."""
    n, two, h, w, c = pairs.shape
    assert two == 2
    return jnp.transpose(pairs, (0, 2, 3, 1, 4)).reshape(n, h, w, 2 * c)


def channels_to_paired(batch, channels):
    """Inverse of :func:`paired_to_channels` on a sampled batch:
    [B, h, w, 2C] -> (input [B, h, w, C], ground_truth [B, h, w, C])."""
    b, h, w, c2 = batch.shape
    pairs = batch.reshape(b, h, w, 2, channels)
    return pairs[:, :, :, 0, :], pairs[:, :, :, 1, :]


def sample_batch(pack: DevicePack, key, batch_size: int):
    """Draw a [batch_size, out, out, C] batch from the pack.

    Sampling is i.i.d. with replacement (the reference uses epoch
    shuffling without replacement, data_provider.py:80-90; with pools of
    thousands of crops the distributions are indistinguishable for
    training purposes and i.i.d. keeps the step shape static).
    """
    images = pack.images
    n, h, w, c = images.shape
    out = pack.output_size
    k_idx, k_ox, k_oy, k_flip = jax.random.split(key, 4)
    idx = jax.random.randint(k_idx, (batch_size,), 0, n)
    batch = jnp.take(images, idx, axis=0)
    if pack.augment:
        if h > out or w > out:
            ox = jax.random.randint(k_ox, (batch_size,), 0, h - out + 1)
            oy = jax.random.randint(k_oy, (batch_size,), 0, w - out + 1)

            def crop(im, x, y):
                return jax.lax.dynamic_slice(im, (x, y, 0), (out, out, c))

            batch = jax.vmap(crop)(batch, ox, oy)
        flip = jax.random.bernoulli(k_flip, 0.5, (batch_size,))
        batch = jnp.where(flip[:, None, None, None], batch[:, :, ::-1, :],
                          batch)
    elif (h, w) != (out, out):
        batch = jax.image.resize(batch, (batch_size, out, out, c),
                                 method='linear')
    return batch
