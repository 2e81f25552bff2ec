"""Fused filter-chain replay: one Pallas kernel, compiled through Triton.

The reference replays a trajectory on a full-resolution image as K
sequential graph ops with a host round trip per step (net.py:796-821) —
K reads and K writes of the whole image.  Filter math is pure per-pixel
arithmetic, so the chain fuses: this kernel reads each pixel once,
applies all K steps with real control flow, and writes once.  The jnp
chain (``ops/chain.py``) is the reference it is tested against; it
evaluates every filter at every step and blends them with a one-hot, so
it does about ``len(filters)`` times the filter math and keeps an f32
full-resolution carry per step.

Grid and layout: the grid is ``(cdiv(H*W, BLOCK), B)`` — one block of
``BLOCK`` pixels of one image per program.  The image is read and
written in place as NHWC through a flat ``[B, H*W*3]`` view, with three
stride-3 loads and stores masked at the tail, so no transpose or padding
surrounds the call.  Each program loads its own image's filter ids and
parameters from global memory as scalars; the id is uniform across the
block, so ``lax.switch`` lowers to real ``scf.if`` branches and only the
selected filter's math runs.  r, g and b stay in registers through the
K steps.  uint8 images are dequantized after the load and quantized at
the store (one byte read and one written per channel).

Scope: the 9 pointwise filters (E, G, W, S+, T, Ct, BW, C, Le) plus an
identity id (``len(filters)``) used for inactive trajectory steps; with
``cfg.masking`` on, the 6-param spatial masks (and the vignette's
elliptical mask) are computed in-kernel from the flat pixel index.
Forward only: training differentiates through ``ops/filters.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from exposure_jax.ops.chain import replay_filter_chain

# pixels per program (a power of two, as Triton requires for every
# loaded block) and warps per program: the fastest of BLOCK 512-4096 x
# 4/8 warps on a trained action mix at 512x512, batch 512 (PERF.md)
BLOCK = 1024
NUM_WARPS = 8

# ---------------------------------------------------------------------------
# Per-channel filter math: (r, g, b, p) -> (r, g, b), where p[j] is the
# j-th packed parameter of the step (a scalar).  Each matches the NHWC
# implementation in ops/filters.py, which carries the reference parity;
# params are already regressed values.
# ---------------------------------------------------------------------------


def _exposure(r, g, b, p):
    m = jnp.exp(p[0] * math.log(2.0))
    return r * m, g * m, b * m


def _gamma(r, g, b, p):
    # jnp.power, as the jnp chain: exp2(g * log2(x)) is faster on the
    # card but a few ulp off, which an S+ step at a near-gray pixel
    # amplifies past the float32 tolerance (PERF.md)
    gm = p[0]
    return (jnp.power(jnp.maximum(r, 0.001), gm),
            jnp.power(jnp.maximum(g, 0.001), gm),
            jnp.power(jnp.maximum(b, 0.001), gm))


def _white_balance(r, g, b, p):
    return r * p[0], g * p[1], b * p[2]


def _curve_apply(x, p, offset, steps):
    total = x * 0
    psum = 1e-30
    for i in range(steps):
        psum = psum + p[offset + i]
    for i in range(steps):
        total = total + jnp.clip(x - i / steps, 0.0, 1.0 / steps) * \
            p[offset + i]
    return total * (steps / psum)


def _tone(steps):
    def fn(r, g, b, p):
        return (_curve_apply(r, p, 0, steps), _curve_apply(g, p, 0, steps),
                _curve_apply(b, p, 0, steps))
    return fn


def _color(steps):
    def fn(r, g, b, p):
        return (_curve_apply(r, p, 0 * steps, steps),
                _curve_apply(g, p, 1 * steps, steps),
                _curve_apply(b, p, 2 * steps, steps))
    return fn


def _contrast(r, g, b, p):
    lum = jnp.clip(0.27 * r + 0.67 * g + 0.06 * b, 0.0, 1.0)
    clum = -jnp.cos(math.pi * lum) * 0.5 + 0.5
    scale = clum / (lum + 1e-6)
    t = p[0]
    return (r + (r * scale - r) * t, g + (g * scale - g) * t,
            b + (b * scale - b) * t)


def _bw(r, g, b, p):
    lum = 0.27 * r + 0.67 * g + 0.06 * b
    t = p[0]
    return (r + (lum - r) * t, g + (lum - g) * t, b + (lum - b) * t)


def _level(r, g, b, p):
    lo = p[0]
    hi = p[1] + 1.0
    inv = 1.0 / (hi - lo + 1e-6)
    return (jnp.clip((r - lo) * inv, 0.0, 1.0),
            jnp.clip((g - lo) * inv, 0.0, 1.0),
            jnp.clip((b - lo) * inv, 0.0, 1.0))


def _saturation(r, g, b, p):
    # HSV round trip expressed channel-wise: with value v and saturation s,
    # every RGB channel is v*(1 - s*w); boosting s to s2 maps
    # c -> v - (v-c)*(s2/s).  Gray pixels (range==0) take the explicit
    # hue-0 path of hsv_to_rgb (r=v, g=b=v*(1-s2)), matching
    # ops/color_space.py and reference tf.image semantics.
    #
    # With k the saturation boost weight and s2 = s + (1-s)*k, the
    # s = rng/v divide cancels:
    #   s2*v = (1-k)*rng + k*v        (v > 0; rng_pos handles v <= 0)
    #   vg = v*(1-s2) = (1-k)*(v - rng_pos)
    # so only the final ratio = s2*v/rng divide remains.
    r1 = jnp.minimum(r, 1.0)
    g1 = jnp.minimum(g, 1.0)
    b1 = jnp.minimum(b, 1.0)
    v = jnp.maximum(jnp.maximum(r1, g1), b1)
    mn = jnp.minimum(jnp.minimum(r1, g1), b1)
    rng = v - mn
    k = (0.5 - jnp.abs(0.5 - v)) * 0.8
    one_m_k = 1.0 - k
    vpos = v > 0
    safe_v = jnp.where(vpos, v, 1.0)
    rng_pos = jnp.where(vpos, rng, 0.0)
    gray = rng <= 0
    ratio = (one_m_k * rng_pos + k * safe_v) / \
        jnp.where(gray, 1.0, rng)

    def enhance(c, gray_val):
        full = jnp.where(gray, gray_val, v - (v - c) * ratio)
        t = p[0]
        return c * (1.0 - t) + full * t

    vg = one_m_k * (v - rng_pos)
    return enhance(r1, v), enhance(g1, vg), enhance(b1, vg)


_CHANNEL_IMPL = {
    'ExposureFilter': lambda cfg: _exposure,
    'GammaFilter': lambda cfg: _gamma,
    'ImprovedWhiteBalanceFilter': lambda cfg: _white_balance,
    'SaturationPlusFilter': lambda cfg: _saturation,
    'ToneFilter': lambda cfg: _tone(cfg.curve_steps),
    'ContrastFilter': lambda cfg: _contrast,
    'WNBFilter': lambda cfg: _bw,
    'ColorFilter': lambda cfg: _color(cfg.curve_steps),
    'LevelFilter': lambda cfg: _level,
}


def _with_mask(fn, mask_offset, cfg):
    """Wrap a filter with the 6-param spatial mask blend
    (filters.py:110-148): mask params are packed at ``mask_offset`` in
    the parameter row; gx/gy are the normalized centered pixel grids."""
    fir = 5.0  # filter_input_range

    def run(r, g, b, p, gx, gy):
        r2, g2, b2 = fn(r, g, b, p)
        # tanh_range(-5, 5, initial=0)(x) == tanh(x) * 5
        mp = [jnp.tanh(p[mask_offset + j]) * fir for j in range(6)]
        lum = 0.27 * r + 0.67 * g + 0.06 * b
        inp = (gx * mp[0] + gy * mp[1] + mp[2] * (lum - 0.5) + mp[3] * 2)
        inp = inp * (cfg.maximum_sharpness * mp[4] / fir)
        mask = jax.nn.sigmoid(inp)
        mask = mask * (mp[5] / fir * 0.5 + 0.5) * \
            (1 - cfg.minimum_strength) + cfg.minimum_strength
        return (r + (r2 - r) * mask, g + (g2 - g) * mask,
                b + (b2 - b) * mask)

    return run


def _vignet_masked(cfg, mask_offset):
    """Vignette: elliptical 5-param mask blending toward black
    (filters.py:341-401)."""
    fir = 5.0

    def run(r, g, b, p, gx, gy):
        # filter param p[0] (sigmoid) is unused by process (returns 0 img)
        mp = [jnp.tanh(p[mask_offset + j]) * fir for j in range(5)]
        inp = ((gx * mp[0]) ** 2 + (gy * mp[1]) ** 2 + mp[2] - fir)
        inp = inp * (cfg.maximum_sharpness * mp[3] / fir)
        mask = jax.nn.sigmoid(inp) * (mp[4] / fir * 0.5 + 0.5)
        inv = 1.0 - mask
        return r * inv, g * inv, b * inv

    return run


def channel_branches(filters, mask_offset=None):
    """Branch list for the kernel's switch: one per filter + identity last.

    Each branch consumes (r, g, b, p, gx, gy) where p packs
    [filter_params (padded) | mask_params] and gx/gy are the spatial
    grids (ignored by unmasked branches).  ``mask_offset`` is where the
    mask parameters start in the packed row (required when any filter
    has masking enabled).
    """
    branches = []
    for f in filters:
        name = type(f).__name__
        if name not in _CHANNEL_IMPL and name != 'VignetFilter':
            raise NotImplementedError(
                'the replay kernel does not support %s; use the jnp chain'
                % name)
        if f.use_masking():
            assert mask_offset is not None, (
                'mask_params must be provided for masked filters')
            if name == 'VignetFilter':
                branches.append(_vignet_masked(f.cfg, mask_offset))
            else:
                base = _CHANNEL_IMPL[name](f.cfg)
                branches.append(_with_mask(base, mask_offset, f.cfg))
        else:
            if name == 'VignetFilter':
                raise NotImplementedError(
                    'VignetFilter without masking zeroes the image '
                    '(dormant); use the jnp chain')
            base = _CHANNEL_IMPL[name](f.cfg)
            branches.append(
                lambda r, g, b, p, gx, gy, fn=base: fn(r, g, b, p))
    branches.append(lambda r, g, b, p, gx, gy: (r, g, b))  # identity
    return branches


class _ParamRow:
    """``p[j]`` reads packed parameter j of one (image, step) as a scalar
    load from global memory.  Branches index it inside their own
    ``scf.if`` region, so each step loads only the selected filter's
    parameters; repeated reads within a branch reuse the first load."""

    def __init__(self, params_ref, bi, k):
        self._ref, self._bi, self._k = params_ref, bi, k
        self._cache = {}

    def __getitem__(self, j):
        if j not in self._cache:
            self._cache[j] = self._ref[self._bi, self._k, j]
        return self._cache[j]


def _chain_kernel(ids_ref, params_ref, img_ref, out_ref, *, branches,
                  num_steps, block, n_pix, grid_dims):
    blk = pl.program_id(0)
    bi = pl.program_id(1)
    pix = blk * block + jnp.arange(block, dtype=jnp.int32)
    valid = pix < n_pix
    quantized = img_ref.dtype == jnp.uint8

    # element offsets of channel 0 of the block's pixels in the flat
    # NHWC row (an index vector rather than a strided slice: interpret
    # mode supports only the former, and both lower to the same pointer
    # arithmetic)
    offs = pix * 3

    def channel(ref, c):
        return ref.at[bi, offs + c]

    def load(c):
        x = plgpu.load(channel(img_ref, c), mask=valid, other=0)
        if quantized:
            return x.astype(jnp.int32).astype(jnp.float32) * (1.0 / 255.0)
        return x.astype(jnp.float32)

    def store(c, x):
        if quantized:
            # round half up (ops/chain.py quantize_u8): Triton has no
            # round-to-nearest-even op
            x = jnp.floor(jnp.clip(x, 0.0, 1.0) * 255.0 + 0.5)
            x = x.astype(jnp.int32).astype(jnp.uint8)
        else:
            x = x.astype(out_ref.dtype)
        plgpu.store(channel(out_ref, c), x, mask=valid)

    if grid_dims is not None:
        # normalized centered (x, y) grids for the spatial masks
        # (filters.py:123-133), from the flat pixel index
        h, w = grid_dims
        shorter = float(min(h, w))
        rows = (pix // w).astype(jnp.float32)
        cols = (pix % w).astype(jnp.float32)
        gx = (rows + (shorter - h) / 2.0) / shorter - 0.5
        gy = (cols + (shorter - w) / 2.0) / shorter - 0.5
    else:
        gx = gy = None

    r, g, b = load(0), load(1), load(2)
    for k in range(num_steps):
        def make_case(fn, k=k):
            def case(rr, gg, bb):
                return fn(rr, gg, bb, _ParamRow(params_ref, bi, k), gx, gy)
            return case

        # lax.switch clamps the index: the identity id len(filters)
        # lands on the last (pass-through) branch
        r, g, b = jax.lax.switch(ids_ref[bi, k],
                                 [make_case(fn) for fn in branches],
                                 r, g, b)
    store(0, r)
    store(1, g)
    store(2, b)


def pallas_apply_filter_chain(img, filter_ids, packed_params, filters,
                              active_steps=None, mask_params=None,
                              interpret=False):
    """Fused chain replay.

    Args:
      img: [B, H, W, 3] float32 (linear domain) or uint8 (fixed-point
        [0, 1]) NHWC image.
      filter_ids: [K, B] int per-step choices (rollout layout).
      packed_params: [K, B, max_p] float32 packed regressed parameters.
      filters: instantiated filter list.
      active_steps: optional [K, B] 0/1; inactive steps become identity.
      mask_params: [K, B, max_mask] raw mask-head outputs — REQUIRED when
        any filter has masking enabled.
      interpret: run the kernel in Pallas interpret mode (CPU tests).

    Returns: [B, H, W, 3] of img's dtype.
    """
    masking = any(f.use_masking() for f in filters)
    max_p = packed_params.shape[-1]
    branches = channel_branches(
        filters, mask_offset=max_p if masking else None)
    identity_id = len(branches) - 1

    ids = jnp.transpose(filter_ids, (1, 0)).astype(jnp.int32)  # [B, K]
    params = jnp.transpose(packed_params, (1, 0, 2)).astype(jnp.float32)
    if masking:
        assert mask_params is not None, (
            'masking filters require mask_params')
        params = jnp.concatenate(
            [params, jnp.transpose(mask_params, (1, 0, 2))
             .astype(jnp.float32)], axis=-1)
    if active_steps is not None:
        act = jnp.transpose(active_steps, (1, 0))
        ids = jnp.where(act > 0, ids, identity_id)

    b, h, w, c = img.shape
    assert c == 3
    n_pix = h * w
    flat = img.reshape(b, n_pix * 3)
    kernel = functools.partial(
        _chain_kernel, branches=branches, num_steps=ids.shape[1],
        block=BLOCK, n_pix=n_pix, grid_dims=(h, w) if masking else None)
    out = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n_pix, BLOCK), b),
        out_shape=jax.ShapeDtypeStruct(flat.shape, flat.dtype),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend='triton',
        interpret=interpret,
        name='filter_chain_replay',
    )(ids, params, flat)
    return out.reshape(img.shape)


def select_chain_replay(interpret=False):
    """The chain replay for the platform JAX runs on: this module's
    kernel on the GPU, the jnp chain (``ops/chain.py``) on the CPU; any
    other platform raises.  ``interpret=True`` asks for the kernel in
    Pallas interpret mode (CPU tests); it is never chosen otherwise.
    Both returned functions share ``pallas_apply_filter_chain``'s
    contract."""
    if interpret:
        return functools.partial(pallas_apply_filter_chain, interpret=True)
    platform = jax.default_backend()
    if platform == 'gpu':
        return pallas_apply_filter_chain
    if platform == 'cpu':
        return replay_filter_chain
    raise NotImplementedError('no filter-chain replay for platform %r'
                              % platform)
