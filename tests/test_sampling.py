"""Distribution tests for the inverse-CDF categorical sampler (mirrors the
reference's statistical smoke check, pdf_sample_layer.py:55-78)."""

import jax.numpy as jnp
import numpy as np

from exposure_jax.ops import pdf_sample


def test_exact_boundaries():
    pdf = jnp.asarray([[0.25, 0.25, 0.5]])
    # cdf (exclusive) = [0, .25, .5]
    assert int(pdf_sample(pdf, jnp.asarray([[0.1]]))[0]) == 0
    assert int(pdf_sample(pdf, jnp.asarray([[0.26]]))[0]) == 1
    assert int(pdf_sample(pdf, jnp.asarray([[0.51]]))[0]) == 2
    assert int(pdf_sample(pdf, jnp.asarray([[0.999]]))[0]) == 2


def test_unnormalized_pdf_frequencies(rng):
    n = 3
    batch = 4096
    pdf = jnp.asarray([[2.0 ** i for i in range(1, n + 1)]] * batch)
    counts = np.zeros(n)
    for _ in range(20):
        noise = jnp.asarray(rng.rand(batch, 1).astype(np.float32))
        idx = np.asarray(pdf_sample(pdf, noise))
        assert ((idx >= 0) & (idx < n)).all()
        for i in range(n):
            counts[i] += (idx == i).sum()
    freq = counts / counts.sum()
    expected = np.array([2.0, 4.0, 8.0])
    expected /= expected.sum()
    np.testing.assert_allclose(freq, expected, atol=0.02)


def test_zero_noise_clamped():
    # jax.random.uniform can return exactly 0.0; the raw reference formula
    # (pdf_sample_layer.py:5-10) would yield index -1 there (all-zero
    # one-hot -> black image).  We clamp to the valid range.
    pdf = jnp.asarray([[0.25, 0.25, 0.5]])
    assert int(pdf_sample(pdf, jnp.asarray([[0.0]]))[0]) == 0
    assert int(pdf_sample(pdf, jnp.asarray([[1.0]]))[0]) == 2


def test_batch_independent_rows(rng):
    pdf = jnp.asarray([[1.0, 0.0], [0.0, 1.0]])
    noise = jnp.asarray([[0.5], [0.5]])
    idx = np.asarray(pdf_sample(pdf, noise))
    assert idx.tolist() == [0, 1]
