"""The differentiable filter bank.

JAX re-design of the reference filter framework
(reference filters.py:9-507).  Differences from the reference architecture:

- Filters here are *pure math*: parameter regression (a bounded activation
  of raw head outputs) and pixel processing.  The fully-connected heads that
  produce the raw parameters live in the policy network
  (``exposure_jax.models.networks``), keeping all learnable state in one
  pytree.
- Every ``process`` is a pure jnp function with static shapes, so a K-step
  chain jits into one fused XLA computation; the inference fast path
  additionally has a fused Pallas kernel (``exposure_jax.ops.pallas_chain``)
  that applies a whole chain in a single pass over the image.
- Regressed parameters are kept *flat* ([B, n_params]) so trajectories can
  be recorded as fixed-shape (filter_id, packed_params) pairs and replayed
  at any resolution (the reference's "white-box" property,
  filters.py:62-99).

Filter math parity map (reference file:line):
  ExposureFilter               filters.py:170-191
  GammaFilter                  filters.py:194-212
  ImprovedWhiteBalanceFilter   filters.py:215-244
  ColorFilter                  filters.py:247-295
  ToneFilter                   filters.py:298-338
  VignetFilter                 filters.py:341-401 (dormant in configs)
  ContrastFilter               filters.py:404-425
  WNBFilter                    filters.py:428-446
  LevelFilter                  filters.py:449-471 (dormant in configs)
  SaturationPlusFilter         filters.py:474-507
"""

import math

import jax
import jax.numpy as jnp

from exposure_jax.ops.color_space import hsv_to_rgb, rgb_to_hsv
from exposure_jax.utils.ops import lerp, rgb2lum, tanh_range


class Filter:
    """Base class: bounded parameter regression + pixel-wise processing.

    Mirrors the reference ``Filter`` contract (filters.py:9-148) minus the
    TF-variable heads.  ``apply`` runs the low-res proxy and, with the same
    parameters, an optional high-res image — the resolution-independence
    that makes white-box replay possible (filters.py:89-98).
    """

    short_name = None
    num_filter_parameters = None

    def __init__(self, cfg):
        self.cfg = cfg

    def get_short_name(self):
        assert self.short_name
        return self.short_name

    def get_num_filter_parameters(self):
        assert self.num_filter_parameters
        return self.num_filter_parameters

    def get_num_mask_parameters(self):
        return 6

    def filter_param_regressor(self, features):
        """[B, n_raw] head outputs -> [B, n_params] bounded parameters."""
        raise NotImplementedError

    def process(self, img, param):
        """[B, H, W, C] x [B, n_params] -> [B, H, W, C]."""
        raise NotImplementedError

    def no_high_res(self):
        return False

    def use_masking(self):
        return self.cfg.masking

    def get_mask(self, img, mask_parameters):
        """Linear-in-(x, y, lum) sigmoid mask (filters.py:110-148).

        Returns ones when masking is disabled (the shipped configs set
        ``cfg.masking = False``, config_example.py:36).
        """
        if not self.use_masking():
            return jnp.ones((1, 1, 1, 1), dtype=img.dtype)
        filter_input_range = 5.0
        p = tanh_range(-filter_input_range, filter_input_range, initial=0)(
            mask_parameters)
        grid_x, grid_y = _mask_grid(img.shape[1], img.shape[2], img.dtype)
        inp = (grid_x * p[:, None, None, 0, None] +
               grid_y * p[:, None, None, 1, None] +
               p[:, None, None, 2, None] * (rgb2lum(img) - 0.5) +
               p[:, None, None, 3, None] * 2)
        inp = inp * (self.cfg.maximum_sharpness * p[:, None, None, 4, None] /
                     filter_input_range)
        mask = jax.nn.sigmoid(inp)
        mask = mask * (p[:, None, None, 5, None] / filter_input_range * 0.5 +
                       0.5) * (1 - self.cfg.minimum_strength) + \
            self.cfg.minimum_strength
        return mask

    def apply(self, img, raw_parameters=None, specified_parameter=None,
              mask_parameters=None, high_res=None):
        """Run the filter; returns (low_res_out, high_res_out, params).

        ``raw_parameters`` are un-regressed head outputs; alternatively a
        ``specified_parameter`` (already regressed, e.g. replayed from a
        recorded trajectory) can be given (filters.py:62-99).
        """
        assert (raw_parameters is None) ^ (specified_parameter is None)
        if raw_parameters is not None:
            filter_parameters = self.filter_param_regressor(raw_parameters)
        else:
            # replayed trajectory: regressed parameters given directly;
            # with masking on, the recorded raw mask parameters must
            # accompany them
            assert not self.use_masking() or mask_parameters is not None
            filter_parameters = specified_parameter
        if mask_parameters is None:
            mask_parameters = jnp.zeros(
                (img.shape[0], self.get_num_mask_parameters()), img.dtype)
        mask = self.get_mask(img, mask_parameters)
        low_res_output = lerp(img, self.process(img, filter_parameters), mask)
        if high_res is not None:
            if self.no_high_res():
                high_res_output = high_res
            else:
                hi_mask = self.get_mask(high_res, mask_parameters)
                high_res_output = lerp(
                    high_res, self.process(high_res, filter_parameters),
                    hi_mask)
        else:
            high_res_output = None
        return low_res_output, high_res_output, filter_parameters


def _mask_grid(h, w, dtype):
    """Normalized centered (x, y) grids used by spatial masks
    (filters.py:123-133), built with iota instead of Python loops."""
    shorter = min(h, w)
    ii = jnp.arange(h, dtype=dtype)
    jj = jnp.arange(w, dtype=dtype)
    gx = (ii + (shorter - h) / 2.0) / shorter - 0.5
    gy = (jj + (shorter - w) / 2.0) / shorter - 0.5
    grid_x = jnp.broadcast_to(gx[None, :, None, None], (1, h, w, 1))
    grid_y = jnp.broadcast_to(gy[None, None, :, None], (1, h, w, 1))
    return grid_x, grid_y


class ExposureFilter(Filter):
    """img * 2**p, p in tanh_range(+-exposure_range) (filters.py:170-191)."""

    short_name = 'E'
    num_filter_parameters = 1

    def filter_param_regressor(self, features):
        return tanh_range(-self.cfg.exposure_range, self.cfg.exposure_range,
                          initial=0)(features)

    def process(self, img, param):
        return img * jnp.exp(param[:, None, None, :] * math.log(2))


class GammaFilter(Filter):
    """max(img, 1e-3) ** g, g = exp(tanh_range(+-ln gamma_range))
    (filters.py:194-212)."""

    short_name = 'G'
    num_filter_parameters = 1

    def filter_param_regressor(self, features):
        log_gamma_range = math.log(self.cfg.gamma_range)
        return jnp.exp(tanh_range(-log_gamma_range, log_gamma_range)(features))

    def process(self, img, param):
        return jnp.power(jnp.maximum(img, 0.001), param[:, None, None, :])


class ImprovedWhiteBalanceFilter(Filter):
    """Per-channel scales, red channel pinned pre-activation, normalized by
    luminance so overall brightness is preserved (filters.py:215-244)."""

    short_name = 'W'
    num_filter_parameters = 3

    def filter_param_regressor(self, features):
        log_wb_range = 0.5
        mask = jnp.array([[0.0, 1.0, 1.0]], dtype=features.dtype)
        features = features * mask
        scaling = jnp.exp(tanh_range(-log_wb_range, log_wb_range)(features))
        lum = (1e-5 + 0.27 * scaling[:, 0] + 0.67 * scaling[:, 1] +
               0.06 * scaling[:, 2])
        return scaling * (1.0 / lum)[:, None]

    def process(self, img, param):
        return img * param[:, None, None, :]


class ColorFilter(Filter):
    """Independent monotone piecewise-linear curve per RGB channel; params
    are flat [B, 3 * curve_steps] (filters.py:247-295)."""

    short_name = 'C'

    def __init__(self, cfg):
        super().__init__(cfg)
        self.curve_steps = cfg.curve_steps
        self.channels = 3
        self.num_filter_parameters = self.channels * cfg.curve_steps

    def filter_param_regressor(self, features):
        curve = tanh_range(*self.cfg.color_curve_range, initial=1)(features)
        return curve

    def process(self, img, param):
        steps = self.curve_steps
        # [B, C, steps] broadcast against [B, H, W, C]
        curve = param.reshape(-1, self.channels, steps)
        curve_sum = jnp.sum(curve, axis=2) + 1e-30
        total = img * 0
        for i in range(steps):
            total = total + jnp.clip(img - 1.0 * i / steps, 0.0, 1.0 / steps) \
                * curve[:, None, None, :, i]
        total = total * (steps / curve_sum)[:, None, None, :]
        return total


class ToneFilter(Filter):
    """Global monotone tone curve shared by all channels
    (filters.py:298-338)."""

    short_name = 'T'

    def __init__(self, cfg):
        super().__init__(cfg)
        self.curve_steps = cfg.curve_steps
        self.num_filter_parameters = cfg.curve_steps

    def filter_param_regressor(self, features):
        return tanh_range(*self.cfg.tone_curve_range)(features)

    def process(self, img, param):
        steps = self.curve_steps
        curve_sum = jnp.sum(param, axis=1) + 1e-30  # [B]
        total = img * 0
        for i in range(steps):
            total = total + jnp.clip(img - 1.0 * i / steps, 0.0, 1.0 / steps) \
                * param[:, i, None, None, None]
        total = total * (steps / curve_sum)[:, None, None, None]
        return total


class VignetFilter(Filter):
    """Elliptical vignette; the reference's ``process`` zeroes the image and
    lets the mask blend it back (filters.py:341-401).  Dormant in the
    shipped configs."""

    short_name = 'V'
    num_filter_parameters = 1

    def filter_param_regressor(self, features):
        return jax.nn.sigmoid(features)

    def process(self, img, param):
        return img * 0

    def get_num_mask_parameters(self):
        return 5

    def get_mask(self, img, mask_parameters):
        filter_input_range = 5.0
        p = tanh_range(-filter_input_range, filter_input_range, initial=0)(
            mask_parameters)
        grid_x, grid_y = _mask_grid(img.shape[1], img.shape[2], img.dtype)
        inp = ((grid_x * p[:, None, None, 0, None]) ** 2 +
               (grid_y * p[:, None, None, 1, None]) ** 2 +
               p[:, None, None, 2, None] - filter_input_range)
        inp = inp * (self.cfg.maximum_sharpness * p[:, None, None, 3, None] /
                     filter_input_range)
        mask = jax.nn.sigmoid(inp)
        mask = mask * (p[:, None, None, 4, None] / filter_input_range * 0.5 +
                       0.5)
        if not self.use_masking():
            mask = mask * 0 + 1
        return mask


class ContrastFilter(Filter):
    """Cosine luminance remap blended by a tanh-bounded strength
    (filters.py:404-425)."""

    short_name = 'Ct'
    num_filter_parameters = 1

    def filter_param_regressor(self, features):
        return jnp.tanh(features)

    def process(self, img, param):
        luminance = jnp.clip(rgb2lum(img), 0.0, 1.0)
        contrast_lum = -jnp.cos(math.pi * luminance) * 0.5 + 0.5
        contrast_image = img / (luminance + 1e-6) * contrast_lum
        return lerp(img, contrast_image, param[:, :, None, None])


class WNBFilter(Filter):
    """Blend toward luminance (black & white) (filters.py:428-446)."""

    short_name = 'BW'
    num_filter_parameters = 1

    def filter_param_regressor(self, features):
        return jax.nn.sigmoid(features)

    def process(self, img, param):
        luminance = rgb2lum(img)
        return lerp(img, luminance, param[:, :, None, None])


class LevelFilter(Filter):
    """Levels: clip((x - lo) / (hi - lo)); dormant in configs
    (filters.py:449-471)."""

    short_name = 'Le'
    num_filter_parameters = 2

    def filter_param_regressor(self, features):
        return jax.nn.sigmoid(features)

    def process(self, img, param):
        lower = param[:, 0][:, None, None, None]
        upper = (param[:, 1] + 1)[:, None, None, None]
        return jnp.clip((img - lower) / (upper - lower + 1e-6), 0.0, 1.0)


class SaturationPlusFilter(Filter):
    """Value-aware saturation boost via HSV round trip
    (filters.py:474-507)."""

    short_name = 'S+'
    num_filter_parameters = 1

    def filter_param_regressor(self, features):
        return jax.nn.sigmoid(features)

    def process(self, img, param):
        img = jnp.minimum(img, 1.0)
        hsv = rgb_to_hsv(img)
        s = hsv[..., 1:2]
        v = hsv[..., 2:3]
        enhanced_s = s + (1 - s) * (0.5 - jnp.abs(0.5 - v)) * 0.8
        hsv1 = jnp.concatenate([hsv[..., 0:1], enhanced_s, hsv[..., 2:]],
                               axis=-1)
        full_color = hsv_to_rgb(hsv1)
        p = param[:, :, None, None]
        return img * (1.0 - p) + full_color * p


def max_filter_parameters(filters):
    """Largest parameter count across instantiated filters — the packed
    trajectory parameter width used by the replay kernels."""
    return max(f.get_num_filter_parameters() for f in filters)
