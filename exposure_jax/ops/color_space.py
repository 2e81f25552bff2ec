"""Differentiable RGB<->HSV conversion in pure jnp.

The reference leans on tf.image.rgb_to_hsv / hsv_to_rgb inside the
saturation filter (reference filters.py:484-498).  JAX has no built-in, so
we implement the standard elementwise conversion; every branch is expressed
with jnp.where so the op is jit/vmap/grad friendly and fuses into plain
elementwise code.  Channels are the trailing axis.
"""

import jax.numpy as jnp


def rgb_to_hsv(img):
    """NHWC (or any [..., 3]) RGB in [0, 1] -> HSV with h, s, v in [0, 1]."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    rng = v - mn
    safe_rng = jnp.where(rng > 0, rng, 1.0)
    safe_v = jnp.where(v > 0, v, 1.0)
    s = jnp.where(v > 0, rng / safe_v, 0.0)
    hr = jnp.mod((g - b) / safe_rng, 6.0)
    hg = (b - r) / safe_rng + 2.0
    hb = (r - g) / safe_rng + 4.0
    h = jnp.where(v == r, hr, jnp.where(v == g, hg, hb))
    h = jnp.where(rng > 0, h / 6.0, 0.0)
    return jnp.stack([h, s, v], axis=-1)


def hsv_to_rgb(hsv):
    """Inverse of :func:`rgb_to_hsv`; h, s, v in [0, 1] -> RGB in [0, 1]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    dh = h * 6.0
    i = jnp.floor(dh)
    f = dh - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sextant = jnp.mod(i.astype(jnp.int32), 6)
    r = jnp.select([sextant == k for k in range(6)], [v, q, p, p, t, v])
    g = jnp.select([sextant == k for k in range(6)], [t, v, v, q, p, p])
    b = jnp.select([sextant == k for k in range(6)], [p, p, t, v, v, q])
    return jnp.stack([r, g, b], axis=-1)
