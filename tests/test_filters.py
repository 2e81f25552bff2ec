"""Golden-value and gradient tests for the differentiable filter bank.

Oracles are independent numpy implementations of the filter math as
specified in SURVEY.md §2 #18-27 (closed forms), NOT ports of the code
under test."""

import colorsys
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exposure_jax.ops import (
    ColorFilter,
    ContrastFilter,
    ExposureFilter,
    GammaFilter,
    ImprovedWhiteBalanceFilter,
    LevelFilter,
    SaturationPlusFilter,
    ToneFilter,
    WNBFilter,
    hsv_to_rgb,
    rgb_to_hsv,
)
from exposure_jax.utils import Dict, rgb2lum, tanh_range


def make_cfg():
    return Dict(
        masking=False,
        minimum_strength=0.3,
        maximum_sharpness=1.0,
        curve_steps=8,
        gamma_range=3,
        exposure_range=3.5,
        color_curve_range=(0.90, 1.10),
        tone_curve_range=(0.5, 2),
    )


def rand_img(rng, b=2, h=8, w=8):
    return rng.rand(b, h, w, 3).astype(np.float32)


def np_lum(img):
    return (0.27 * img[..., 0] + 0.67 * img[..., 1] +
            0.06 * img[..., 2])[..., None]


class TestTanhRange:
    def test_midpoint_and_limits(self):
        act = tanh_range(-3.5, 3.5, initial=0)
        assert float(act(jnp.zeros(1))[0]) == pytest.approx(0.0, abs=1e-6)
        assert float(act(jnp.full((1,), 100.0))[0]) == pytest.approx(3.5,
                                                                     abs=1e-3)
        assert float(act(jnp.full((1,), -100.0))[0]) == pytest.approx(-3.5,
                                                                      abs=1e-3)

    def test_formula(self):
        act = tanh_range(0.5, 2.0)
        x = 0.3
        expected = (math.tanh(x) * 0.5 + 0.5) * 1.5 + 0.5
        assert float(act(jnp.array([x]))[0]) == pytest.approx(expected,
                                                              rel=1e-5)


class TestHSV:
    def test_against_colorsys(self, rng):
        pix = rng.rand(50, 3).astype(np.float32)
        got = np.asarray(rgb_to_hsv(jnp.asarray(pix)))
        for k in range(50):
            h, s, v = colorsys.rgb_to_hsv(*pix[k])
            assert got[k, 0] == pytest.approx(h, abs=1e-5)
            assert got[k, 1] == pytest.approx(s, abs=1e-5)
            assert got[k, 2] == pytest.approx(v, abs=1e-5)

    def test_roundtrip(self, rng):
        pix = rng.rand(4, 8, 8, 3).astype(np.float32)
        back = np.asarray(hsv_to_rgb(rgb_to_hsv(jnp.asarray(pix))))
        np.testing.assert_allclose(back, pix, atol=1e-5)

    def test_gray_pixels(self):
        gray = jnp.full((1, 2, 2, 3), 0.4)
        hsv = rgb_to_hsv(gray)
        np.testing.assert_allclose(np.asarray(hsv[..., 0]), 0.0)
        np.testing.assert_allclose(np.asarray(hsv[..., 1]), 0.0)


class TestExposure:
    def test_golden(self, rng):
        f = ExposureFilter(make_cfg())
        img = rand_img(rng)
        p = np.array([[1.5], [-2.0]], dtype=np.float32)
        out, _, _ = f.apply(jnp.asarray(img), specified_parameter=jnp.asarray(p))
        expected = img * (2.0 ** p)[:, None, None, :]
        np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-5)

    def test_regressor_range(self):
        f = ExposureFilter(make_cfg())
        big = f.filter_param_regressor(jnp.full((1, 1), 1e3))
        assert float(big[0, 0]) == pytest.approx(3.5, abs=1e-3)


class TestGamma:
    def test_golden(self, rng):
        f = GammaFilter(make_cfg())
        img = rand_img(rng)
        g = np.array([[0.5], [2.2]], dtype=np.float32)
        out = f.process(jnp.asarray(img), jnp.asarray(g))
        expected = np.maximum(img, 0.001) ** g[:, None, None, :]
        np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-5)

    def test_regressor_is_exp_of_bounded(self):
        f = GammaFilter(make_cfg())
        v = f.filter_param_regressor(jnp.full((1, 1), 1e3))
        assert float(v[0, 0]) == pytest.approx(3.0, rel=1e-3)


class TestWhiteBalance:
    def test_red_channel_pinned(self, rng):
        f = ImprovedWhiteBalanceFilter(make_cfg())
        feats = rng.randn(2, 3).astype(np.float32)
        p1 = f.filter_param_regressor(jnp.asarray(feats))
        feats2 = feats.copy()
        feats2[:, 0] = 99.0  # red feature must be ignored
        p2 = f.filter_param_regressor(jnp.asarray(feats2))
        np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), rtol=1e-6)

    def test_luminance_normalized(self, rng):
        f = ImprovedWhiteBalanceFilter(make_cfg())
        p = np.asarray(f.filter_param_regressor(
            jnp.asarray(rng.randn(4, 3).astype(np.float32))))
        lum = 0.27 * p[:, 0] + 0.67 * p[:, 1] + 0.06 * p[:, 2]
        np.testing.assert_allclose(lum, 1.0, atol=1e-3)

    def test_process_scales(self, rng):
        f = ImprovedWhiteBalanceFilter(make_cfg())
        img = rand_img(rng)
        scale = np.array([[1.1, 0.9, 1.3], [0.8, 1.2, 1.0]], dtype=np.float32)
        out = f.process(jnp.asarray(img), jnp.asarray(scale))
        np.testing.assert_allclose(
            np.asarray(out), img * scale[:, None, None, :], rtol=1e-6)


class TestToneAndColorCurves:
    def test_tone_uniform_curve_is_identity(self, rng):
        f = ToneFilter(make_cfg())
        img = np.clip(rand_img(rng), 0, 1)
        t = np.full((2, 8), 1.3, dtype=np.float32)
        out = f.process(jnp.asarray(img), jnp.asarray(t))
        np.testing.assert_allclose(np.asarray(out), img, atol=1e-5)

    def test_tone_closed_form(self, rng):
        f = ToneFilter(make_cfg())
        img = np.clip(rand_img(rng), 0, 1)
        t = rng.uniform(0.5, 2.0, (2, 8)).astype(np.float32)
        out = f.process(jnp.asarray(img), jnp.asarray(t))
        expected = np.zeros_like(img)
        for i in range(8):
            expected += np.clip(img - i / 8.0, 0, 1 / 8.0) * \
                t[:, i][:, None, None, None]
        expected *= (8.0 / (t.sum(1) + 1e-30))[:, None, None, None]
        np.testing.assert_allclose(np.asarray(out), expected, rtol=2e-4,
                                   atol=1e-6)

    def test_color_closed_form(self, rng):
        f = ColorFilter(make_cfg())
        img = np.clip(rand_img(rng), 0, 1)
        c = rng.uniform(0.9, 1.1, (2, 24)).astype(np.float32)
        out = f.process(jnp.asarray(img), jnp.asarray(c))
        curve = c.reshape(2, 3, 8)
        expected = np.zeros_like(img)
        for i in range(8):
            expected += np.clip(img - i / 8.0, 0, 1 / 8.0) * \
                curve[:, None, None, :, i]
        expected *= (8.0 / (curve.sum(2) + 1e-30))[:, None, None, :]
        np.testing.assert_allclose(np.asarray(out), expected, rtol=2e-4,
                                   atol=1e-6)

    def test_color_monotone(self, rng):
        f = ColorFilter(make_cfg())
        ramp = np.linspace(0, 1, 64, dtype=np.float32)
        img = np.broadcast_to(ramp[None, :, None, None],
                              (1, 64, 1, 3)).copy()
        c = rng.uniform(0.9, 1.1, (1, 24)).astype(np.float32)
        out = np.asarray(f.process(jnp.asarray(img), jnp.asarray(c)))
        diffs = np.diff(out[0, :, 0, 0])
        assert (diffs >= -1e-6).all()


class TestContrast:
    def test_zero_param_identity(self, rng):
        f = ContrastFilter(make_cfg())
        img = rand_img(rng)
        out = f.process(jnp.asarray(img),
                        jnp.zeros((2, 1), dtype=jnp.float32))
        np.testing.assert_allclose(np.asarray(out), img, atol=1e-6)

    def test_full_strength_closed_form(self, rng):
        f = ContrastFilter(make_cfg())
        img = np.clip(rand_img(rng), 0, 1)
        out = f.process(jnp.asarray(img),
                        jnp.ones((2, 1), dtype=jnp.float32))
        lum = np.clip(np_lum(img), 0, 1)
        clum = -np.cos(math.pi * lum) * 0.5 + 0.5
        expected = img / (lum + 1e-6) * clum
        np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-4,
                                   atol=1e-6)


class TestBW:
    def test_full_strength_is_luminance(self, rng):
        f = WNBFilter(make_cfg())
        img = rand_img(rng)
        out = f.process(jnp.asarray(img), jnp.ones((2, 1), jnp.float32))
        np.testing.assert_allclose(
            np.asarray(out), np.broadcast_to(np_lum(img), img.shape),
            rtol=1e-5)


class TestLevel:
    def test_closed_form(self, rng):
        f = LevelFilter(make_cfg())
        img = rand_img(rng)
        p = np.array([[0.2, 0.3], [0.0, 0.5]], dtype=np.float32)
        out = f.process(jnp.asarray(img), jnp.asarray(p))
        lower = p[:, 0][:, None, None, None]
        upper = (p[:, 1] + 1)[:, None, None, None]
        expected = np.clip((img - lower) / (upper - lower + 1e-6), 0, 1)
        np.testing.assert_allclose(np.asarray(out), expected, atol=1e-6)


class TestSaturation:
    def test_zero_param_identity(self, rng):
        f = SaturationPlusFilter(make_cfg())
        img = np.clip(rand_img(rng), 0, 1)
        out = f.process(jnp.asarray(img), jnp.zeros((2, 1), jnp.float32))
        np.testing.assert_allclose(np.asarray(out), np.minimum(img, 1.0),
                                   atol=1e-6)

    def test_gray_tints_toward_hue_zero(self):
        # Reference semantics: a gray pixel has s=0 and h=0, and the
        # enhanced saturation (1-s)*(0.5-|0.5-v|)*0.8 > 0 re-saturates it
        # toward hue 0 (red) — see filters.py:484-498.
        f = SaturationPlusFilter(make_cfg())
        img = np.full((1, 4, 4, 3), 0.3, dtype=np.float32)
        out = np.asarray(
            f.process(jnp.asarray(img), jnp.ones((1, 1), jnp.float32)))
        v = 0.3
        s2 = (0.5 - abs(0.5 - v)) * 0.8
        expected_rgb = np.array(colorsys.hsv_to_rgb(0.0, s2, v))
        np.testing.assert_allclose(out[0, 0, 0], expected_rgb, atol=1e-5)

    def test_oracle_colorsys(self, rng):
        f = SaturationPlusFilter(make_cfg())
        img = np.clip(rand_img(rng, b=1, h=4, w=4), 0, 1)
        strength = 0.7
        out = np.asarray(f.process(
            jnp.asarray(img), jnp.full((1, 1), strength, jnp.float32)))
        for i in range(4):
            for j in range(4):
                r, g, b = img[0, i, j]
                h, s, v = colorsys.rgb_to_hsv(r, g, b)
                s2 = s + (1 - s) * (0.5 - abs(0.5 - v)) * 0.8
                full = np.array(colorsys.hsv_to_rgb(h, s2, v))
                expected = img[0, i, j] * (1 - strength) + full * strength
                np.testing.assert_allclose(out[0, i, j], expected, atol=1e-4)


class TestGradients:
    @pytest.mark.parametrize("cls,nparam", [
        (ExposureFilter, 1), (GammaFilter, 1),
        (ImprovedWhiteBalanceFilter, 3), (SaturationPlusFilter, 1),
        (ToneFilter, 8), (ContrastFilter, 1), (WNBFilter, 1),
        (ColorFilter, 24),
    ])
    def test_grads_finite(self, rng, cls, nparam):
        cfg = make_cfg()
        f = cls(cfg)
        img = jnp.asarray(np.clip(rand_img(rng, b=1, h=4, w=4), 0.01, 0.99))

        def loss(raw, x):
            out, _, _ = f.apply(x, raw_parameters=raw)
            return jnp.sum(out ** 2)

        raw = jnp.asarray(rng.randn(1, nparam).astype(np.float32)) * 0.1
        graw, gimg = jax.grad(loss, argnums=(0, 1))(raw, img)
        assert np.isfinite(np.asarray(graw)).all()
        assert np.isfinite(np.asarray(gimg)).all()
        assert float(jnp.abs(graw).sum()) > 0


class TestMask:
    def test_disabled_mask_is_ones(self, rng):
        f = ExposureFilter(make_cfg())
        m = f.get_mask(jnp.asarray(rand_img(rng)), None)
        np.testing.assert_allclose(np.asarray(m), 1.0)

    def test_enabled_mask_range(self, rng):
        cfg = make_cfg()
        cfg.masking = True
        f = ExposureFilter(cfg)
        img = jnp.asarray(rand_img(rng))
        mp = jnp.asarray(rng.randn(2, 6).astype(np.float32))
        m = np.asarray(f.get_mask(img, mp))
        assert m.shape == (2, 8, 8, 1)
        assert (m >= cfg.minimum_strength - 1e-6).all()
        assert (m <= 1.0 + 1e-6).all()
