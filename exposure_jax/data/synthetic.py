"""Procedural datasets for tests, smoke training and benchmarking.

The real FiveK pack is a 2.4 GB download (reference fetch_fivek.py); CI and
the zero-egress dev environment need a stand-in.  ``SyntheticDataProvider``
produces smooth random fields styled either like linearized RAW inputs
(dark, low saturation) or like retouched targets (bright, saturated), so
the full RL+GAN loop has a meaningful gap to close."""

import numpy as np

from exposure_jax.data.provider import DataProvider


def _smooth_field(rng, n, size, channels=3, octaves=3):
    img = np.zeros((n, size, size, channels), dtype=np.float32)
    for o in range(octaves):
        s = max(size >> (octaves - 1 - o), 2)
        noise = rng.rand(n, s, s, channels).astype(np.float32)
        reps = size // s
        up = np.repeat(np.repeat(noise, reps, axis=1), reps, axis=2)
        img += up * (0.5 ** o)
    img /= img.max(axis=(1, 2, 3), keepdims=True) + 1e-6
    return img


def _texture_field(rng, n, size):
    """Zero-mean high-frequency detail with a smooth local-amplitude
    envelope (real surfaces: some regions matte, some detailed).
    Luminance-shared across channels — texture is structure, not
    chroma noise."""
    fine = rng.rand(n, size, size, 1).astype(np.float32) - 0.5
    s2 = max(size // 2, 1)
    block = rng.rand(n, s2, s2, 1).astype(np.float32) - 0.5
    r = size // s2
    block = np.repeat(np.repeat(block, r, axis=1), r, axis=2)
    amp = _smooth_field(rng, n, size, channels=1, octaves=2)
    return (0.6 * fine + 0.4 * block[:, :size, :size]) * \
        (0.3 + 0.7 * amp)


def _soft_clip(x, knee=0.85):
    """Smooth tone compression: identity in the midtones, tanh knees at
    both ends.  Monotone with strictly positive slope, so compressed
    patches KEEP their texture — unlike ``np.clip``, which manufactures
    exactly-flat saturated patches.  Artist-target stand-ins use this
    (real retouchers roll highlights off; they do not clip them)."""
    lo = 1.0 - knee
    top = knee + lo * np.tanh((x - knee) / lo)
    x = np.where(x > knee, top, x)
    bot = lo - lo * np.tanh((lo - x) / lo)
    return np.where(x < lo, bot, x).astype(np.float32)


def _contrast_remap(img, strength):
    """Per-image cosine luminance contrast remap — numpy twin of the Ct
    filter's transform (ops/filters.py ContrastFilter.process, reference
    filters.py:404-425) so widened targets span the exact contrast axis
    the policy can reach.  ``strength`` is [N, 1, 1, 1] in [-1, 1]."""
    lum_w = np.asarray([0.27, 0.67, 0.06], np.float32)
    lum = np.clip((img * lum_w).sum(-1, keepdims=True), 0.0, 1.0)
    contrast_lum = -np.cos(np.pi * lum) * 0.5 + 0.5
    contrast_img = img / (lum + 1e-6) * contrast_lum
    return np.clip(img + strength * (contrast_img - img), 0.0, 1.0)


def make_synthetic_pack(n=256, size=80, style='raw', seed=0, cast=0.0,
                        spread=0.0, texture=0.0):
    """Like a real photo collection, every per-image adjustment is drawn
    from a RANGE, so the set's luminance/contrast/saturation statistics
    form broad distributions — a retouching policy gets partial credit
    on the 32-bin histogram-intersection metric for partial progress
    (near-delta distributions would score 0 until nearly exact).

    ``cast`` > 0 adds a per-image random color cast to the 'raw' style
    (per-channel scales in [1-cast, 1+cast], luminance-renormalized) —
    the diversity ablation knob: the default procedural data is
    color-balanced, which makes the White-Balance filter genuinely
    useless to a trained policy (DIVERSITY.json); casted variants give
    W something to earn reward on (tools/ablate_w_usage.py).

    ``spread`` > 0 widens the 'retouched' targets' contrast/saturation
    distributions (DIVERSITY.md addendum): the default procedural
    targets are narrow enough along the Ct axis that a policy applying
    the aggressive cosine contrast remap to EVERY image is still
    reward-optimal under the WGAN critic — real artist sets are broad
    there, so over-concentrated output distributions get penalized.
    spread=1 draws a per-image Ct-axis strength in [-0.5, 0.9] (the
    same remap the ContrastFilter applies), widens the chroma boost to
    [0.8, 2.3] and the tone gamma to [0.45, 1.1].  RNG draws happen
    AFTER the spread=0 draws, so spread=0 stays bit-identical to the
    historical pack.

    ``texture`` > 0 adds the STRUCTURAL-REALISM pressure the smooth
    fields lack (DIVERSITY.md addendum 2): luminance-correlated
    high-frequency detail (multiplicative, ±15%·texture) on both
    styles, and 'retouched' targets switch from hard ``np.clip`` to a
    soft tanh-knee tone compressor — so NO target patch is ever
    clipped flat.  A policy that applies the aggressive cosine
    contrast remap uniformly then produces blown-flat highlight /
    blocked-flat shadow patches that appear in no target patch,
    giving the convolutional WGAN critic the per-patch (not merely
    distributional) separating signal real artist sets provide.
    Texture draws use an independent RNG stream, so texture=0 stays
    bit-identical to the historical pack."""
    rng = np.random.RandomState(seed)
    img = _smooth_field(rng, n, size)
    if texture > 0:
        trng = np.random.RandomState((seed + 1) * 7919)
        tex = _texture_field(trng, n, size)
        img = np.clip(img * (1.0 + 0.3 * texture * tex), 0.0, 1.0)
    clip = _soft_clip if texture > 0 else \
        (lambda x: np.clip(x, 0.0, 1.0))
    if style == 'raw':
        # dark, washed out, like an un-toned linear RAW
        img = img ** 2.2 * rng.uniform(0.15, 0.45, (n, 1, 1, 1))
        gray = img.mean(axis=3, keepdims=True)
        desat = rng.uniform(0.5, 0.85, (n, 1, 1, 1)).astype(np.float32)
        img = desat * gray + (1 - desat) * img
        if cast > 0:
            scale = rng.uniform(1 - cast, 1 + cast,
                                (n, 1, 1, 3)).astype(np.float32)
            # keep luminance roughly constant so the cast is a pure
            # color shift (same 0.27/0.67/0.06 weights as the filters)
            lum_w = np.asarray([0.27, 0.67, 0.06], np.float32)
            scale /= (scale[..., :] * lum_w).sum(-1, keepdims=True)
            img = img * scale
    elif style == 'retouched':
        # bright, contrasty, saturated — with artist-like variation
        img = clip(img * rng.uniform(1.0, 1.4, (n, 1, 1, 1))) \
            ** rng.uniform(0.55, 1.0, (n, 1, 1, 1))
        gray = img.mean(axis=3, keepdims=True)
        boost = rng.uniform(1.1, 2.0, (n, 1, 1, 1)).astype(np.float32)
        img = clip(gray + boost * (img - gray))
        if spread > 0:
            # widen tone: extra per-image gamma, effective range
            # ~[0.45, 1.18] at spread=1 (base draw is [0.55, 1.0])
            g2 = rng.uniform(1 - 0.18 * spread, 1 + 0.18 * spread,
                             (n, 1, 1, 1)).astype(np.float32)
            img = img ** g2
            # widen chroma: effective boost ~[0.8, 2.3] at spread=1
            b2 = rng.uniform(1 - 0.27 * spread, 1 + 0.15 * spread,
                             (n, 1, 1, 1)).astype(np.float32)
            gray = img.mean(axis=3, keepdims=True)
            img = np.clip(gray + b2 * (img - gray), 0, 1)
            # span the policy's own contrast axis: per-image cosine
            # remap strength in [-0.5*spread, 0.9*spread]
            t = rng.uniform(-0.5 * spread, 0.9 * spread,
                            (n, 1, 1, 1)).astype(np.float32)
            img = _contrast_remap(img, t)
    else:
        raise ValueError(style)
    return img.astype(np.float32)


class SyntheticDataProvider(DataProvider):

    def __init__(self, n=256, size=80, style='raw', seed=0, cast=0.0,
                 spread=0.0, texture=0.0, *args, **kwargs):
        data = make_synthetic_pack(n, size, style, seed, cast=cast,
                                   spread=spread, texture=texture)
        super().__init__(data, *args, **kwargs)


def make_paired_synthetic_pack(n=256, size=80, seed=0):
    """(input, ground-truth) pairs: the target is a bright/contrasty field
    and the input is its pixel-aligned 'un-retouched' degradation —
    supervised-mode training data."""
    rng = np.random.RandomState(seed)
    target = make_synthetic_pack(n, size, 'retouched', seed)
    exposure = rng.uniform(0.2, 0.5, (n, 1, 1, 1)).astype(np.float32)
    inp = (target ** 1.8) * exposure
    return np.stack([inp, target], axis=1)  # [N, 2, H, W, C]


class PairedSyntheticDataProvider(DataProvider):
    """Provider over [N, 2, H, W, C] pairs (supervised mode).  Host
    batches come back as [B, 2, h, w, C]; the device pack lays pairs out
    as extra channels so on-device crop/flip stays consistent
    (see data/device_sampler.py paired_to_channels)."""

    def __init__(self, n=256, size=80, seed=0, output_size=64,
                 augmentation=0.3, *args, **kwargs):
        pairs = make_paired_synthetic_pack(n, size, seed)
        nn, two, h, w, c = pairs.shape
        # store pair in channels for uniform augmentation
        data = pairs.transpose(0, 2, 3, 1, 4).reshape(nn, h, w, two * c)
        kwargs.pop('bnw', None)
        super().__init__(data, output_size=output_size,
                         augmentation=augmentation, *args, **kwargs)
        self.pair_channels = c

    def get_next_batch(self, batch_size):
        batch, feats = super().get_next_batch(batch_size)
        b, h, w, c2 = batch.shape
        c = self.pair_channels
        pairs = batch.reshape(b, h, w, 2, c).transpose(0, 3, 1, 2, 4)
        return pairs, feats
