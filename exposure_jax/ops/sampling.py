"""Inverse-CDF categorical sampling.

Parity with the reference ``pdf_sample`` op (pdf_sample_layer.py:5-10):
normalize the pdf, take an exclusive cumulative sum, and count how many cdf
entries fall below the uniform noise sample.  Pure jnp; the cumsum/compare
is a tiny fused reduction.
"""

import jax.numpy as jnp


def pdf_sample(pdf, uniform_noise):
    """Sample category indices via inverse-CDF.

    Args:
      pdf: [B, K] unnormalized probabilities (strictly positive).
      uniform_noise: [B, 1] uniform samples in [0, 1).

    Returns:
      [B] int32 sampled indices.
    """
    pdf = pdf / (jnp.sum(pdf, axis=1, keepdims=True) + 1e-36)
    cdf = jnp.cumsum(pdf, axis=1) - pdf  # exclusive cumsum
    indices = jnp.sum((cdf < uniform_noise).astype(jnp.int32), axis=1) - 1
    # The reference formula (pdf_sample_layer.py:5-10) returns -1 when the
    # noise is exactly 0.0 (cdf[0]==0 is not < 0), which jax.random.uniform
    # CAN produce; a -1 index would select an all-zero one-hot and black
    # out the image.  Clamp to the valid range.
    return jnp.clip(indices, 0, pdf.shape[1] - 1)
