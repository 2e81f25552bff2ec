"""Fused chain replay kernel vs the composed jnp filter chain: bit-near
equality on random trajectories (Pallas interpret mode on the CPU), the
wrapper's shapes and tail masking, its lowering for the GPU, and the
platform choice between kernel and jnp chain.  Tests marked ``gpu`` run
the kernel as compiled for the card and skip without one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exposure_jax.ops import pallas_chain
from exposure_jax.ops.chain import (
    F32_TOL,
    SPREAD_FACTOR,
    apply_filter_chain,
    replay_filter_chain,
    replay_mismatch,
    rounding_spread,
)
from exposure_jax.ops.filters import LevelFilter, max_filter_parameters
from exposure_jax.ops.pallas_chain import (
    pallas_apply_filter_chain,
    select_chain_replay,
)
from exposure_jax.utils import load_config


@pytest.fixture(scope='module')
def cfg():
    return load_config('test')


@pytest.fixture(scope='module')
def filters(cfg):
    return [f(cfg) for f in cfg.filters]


def random_trajectory(rng, filters, k, b):
    """Random (ids, packed regressed params) like a rollout would emit."""
    max_p = max_filter_parameters(filters)
    ids = rng.randint(0, len(filters), (k, b)).astype(np.int32)
    params = np.zeros((k, b, max_p), np.float32)
    for s in range(k):
        for i in range(b):
            f = filters[ids[s, i]]
            n = f.get_num_filter_parameters()
            raw = rng.randn(1, n).astype(np.float32)
            reg = np.asarray(f.filter_param_regressor(jnp.asarray(raw)))
            params[s, i, :n] = reg.reshape(-1)
    return jnp.asarray(ids), jnp.asarray(params)


def assert_u8_close(got, img8, ids, params, filters, **kw):
    """uint8 kernel output within 1 LSB of the f32 jnp chain on the
    dequantized input."""
    assert got.dtype == jnp.uint8
    f32 = jnp.asarray(np.asarray(img8).astype(np.float32) / 255.0)
    expected = apply_filter_chain(f32, ids, params, filters, **kw)
    expected8 = np.floor(np.clip(np.asarray(expected), 0, 1) * 255 + 0.5)
    diff = np.abs(np.asarray(got).astype(np.int32) -
                  expected8.astype(np.int32))
    assert diff.max() <= 1, diff.max()


_FILTER_NAMES = ['ExposureFilter', 'GammaFilter',
                 'ImprovedWhiteBalanceFilter', 'SaturationPlusFilter',
                 'ToneFilter', 'ContrastFilter', 'WNBFilter', 'ColorFilter',
                 'LevelFilter']


@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
@pytest.mark.parametrize('name', _FILTER_NAMES)
def test_single_filter_matches_filters_module(rng, cfg, filters, name,
                                              dtype):
    # one-step chains isolating each filter against ops/filters.py
    bank = filters + [LevelFilter(cfg)]
    fid = [type(f).__name__ for f in bank].index(name)
    f = bank[fid]
    b = 2
    img_f = rng.rand(b, 24, 40, 3).astype(np.float32) * 0.9
    n = f.get_num_filter_parameters()
    raw = jnp.asarray(rng.randn(b, n).astype(np.float32))
    params = np.zeros((1, b, max_filter_parameters(bank)), np.float32)
    params[0, :, :n] = np.asarray(f.filter_param_regressor(raw))
    params = jnp.asarray(params)
    ids = jnp.full((1, b), fid, jnp.int32)
    if dtype == 'uint8':
        img8 = (img_f * 255).astype(np.uint8)
        got = pallas_apply_filter_chain(jnp.asarray(img8), ids, params,
                                        bank, interpret=True)
        assert_u8_close(got, img8, ids, params, bank)
    else:
        expected, _, _ = f.apply(jnp.asarray(img_f),
                                 specified_parameter=params[0, :, :n])
        got = pallas_apply_filter_chain(jnp.asarray(img_f), ids, params,
                                        bank, interpret=True)
        np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                                   atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize('shape', [(2, 64, 64), (1, 33, 45), (3, 7, 5),
                                   (1, 40, 52)])
def test_pallas_matches_jnp_chain(rng, cfg, filters, shape):
    # pixel counts below, at and not a multiple of the block: the tail
    # block's loads and stores are masked
    b, h, w = shape
    img = jnp.asarray(rng.rand(b, h, w, 3).astype(np.float32) * 0.9)
    ids, params = random_trajectory(rng, filters, cfg.test_steps, b)
    expected = apply_filter_chain(img, ids, params, filters)
    got = pallas_apply_filter_chain(img, ids, params, filters,
                                    interpret=True)
    assert got.shape == img.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                               atol=3e-5, rtol=1e-4)


def test_tail_writes_stay_in_bounds(rng, cfg, filters, monkeypatch):
    # a block larger than the image: masked-out lanes must not touch
    # the next image's pixels (each image's output depends on its own
    # trajectory only)
    monkeypatch.setattr(pallas_chain, 'BLOCK', 64)
    img = jnp.asarray(rng.rand(3, 5, 7, 3).astype(np.float32) * 0.9)
    ids, params = random_trajectory(rng, filters, 3, 3)
    got = pallas_apply_filter_chain(img, ids, params, filters,
                                    interpret=True)
    for i in range(3):
        one = apply_filter_chain(img[i:i + 1], ids[:, i:i + 1],
                                 params[:, i:i + 1], filters)
        np.testing.assert_allclose(np.asarray(got[i:i + 1]),
                                   np.asarray(one), atol=3e-5, rtol=1e-4)


def test_pallas_respects_active_mask(rng, cfg, filters):
    img = jnp.asarray(rng.rand(2, 64, 64, 3).astype(np.float32) * 0.9)
    ids, params = random_trajectory(rng, filters, 5, 2)
    active = jnp.asarray(
        np.array([[1, 1], [1, 0], [0, 1], [0, 0], [0, 0]], np.float32))
    expected = apply_filter_chain(img, ids, params, filters,
                                  active_steps=active)
    got = pallas_apply_filter_chain(img, ids, params, filters,
                                    active_steps=active, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                               atol=3e-5, rtol=1e-4)


def test_pallas_all_identity_is_noop(rng, cfg, filters):
    # the identity id and all-inactive steps both pass pixels through
    # exactly (uint8 round-trips through the dequantize/quantize pair)
    img_f = rng.rand(2, 32, 48, 3).astype(np.float32)
    params = jnp.zeros((3, 2, max_filter_parameters(filters)), jnp.float32)
    for img in (img_f, (img_f * 255).astype(np.uint8)):
        img = jnp.asarray(img)
        ids = jnp.full((3, 2), len(filters), jnp.int32)
        got = pallas_apply_filter_chain(img, ids, params, filters,
                                        interpret=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(img))
        got0 = pallas_apply_filter_chain(img, jnp.zeros((3, 2), jnp.int32),
                                         params, filters,
                                         active_steps=jnp.zeros((3, 2)),
                                         interpret=True)
        np.testing.assert_array_equal(np.asarray(got0), np.asarray(img))


def test_uint8_serving_path(rng, cfg, filters):
    # fixed-point [0,1] uint8 I/O must match the f32 chain within 1 LSB
    img8 = (rng.rand(2, 64, 96, 3) * 255).astype(np.uint8)
    ids, params = random_trajectory(rng, filters, cfg.test_steps, 2)
    got = pallas_apply_filter_chain(jnp.asarray(img8), ids, params,
                                    filters, interpret=True)
    assert_u8_close(got, img8, ids, params, filters)


@pytest.mark.parametrize('shape', [(2, 64, 96), (1, 96, 64)])
def test_masked_chain_vignet_level(rng, shape):
    # Vignet and Level with spatial masks: the mask grids come from the
    # flat pixel index (wide and tall images exercise min(H, W)
    # centering)
    mcfg = load_config('masked')
    mfilters = [f(mcfg) for f in mcfg.filters]
    b, h, w = shape
    img = jnp.asarray(rng.rand(b, h, w, 3).astype(np.float32) * 0.9)
    ids, params = random_trajectory(rng, mfilters, 4, b)
    names = [type(f).__name__ for f in mfilters]
    ids = ids.at[0].set(names.index('VignetFilter'))
    ids = ids.at[1].set(names.index('LevelFilter'))
    max_m = max(f.get_num_mask_parameters() for f in mfilters)
    mask = jnp.asarray(rng.randn(4, b, max_m).astype(np.float32))
    expected = apply_filter_chain(img, ids, params, mfilters,
                                  mask_params=mask)
    got = pallas_apply_filter_chain(img, ids, params, mfilters,
                                    mask_params=mask, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected),
                               atol=5e-5, rtol=1e-4)


def test_replay_filter_chain_contract(rng, cfg, filters):
    # the jnp replay used on the CPU shares the kernel's I/O contract
    img8 = jnp.asarray((rng.rand(2, 16, 24, 3) * 255).astype(np.uint8))
    ids, params = random_trajectory(rng, filters, 3, 2)
    out = replay_filter_chain(img8, ids, params, filters)
    assert out.dtype == jnp.uint8 and out.shape == img8.shape
    kern = pallas_apply_filter_chain(img8, ids, params, filters,
                                     interpret=True)
    diff = np.abs(np.asarray(out).astype(np.int32) -
                  np.asarray(kern).astype(np.int32))
    assert diff.max() <= 1
    f32 = img8.astype(jnp.float32) / 255.0
    np.testing.assert_array_equal(
        np.asarray(replay_filter_chain(f32, ids, params, filters)),
        np.asarray(apply_filter_chain(f32, ids, params, filters)))


def _mismatch_case(case):
    """(got, ref, spread) for one ``replay_mismatch`` rule: [1, 4, 4, 3]
    images off at one value; ``spread`` is 1e-5 there, 0 elsewhere."""
    if case.startswith('u8'):
        ref = np.full((1, 4, 4, 3), 100, np.uint8)
        got = ref.copy()
        got[0, 1, 2, 0] += int(case[-1])
        return got, ref, None
    ref = np.full((1, 4, 4, 3), 0.5, np.float32)
    got = ref.copy()
    spread = np.zeros(ref.shape, np.float32)
    spread[0, 1, 2, 0] = 1e-5
    err = {'f32 within': 1.9e-5, 'f32 over': 2.2e-5,
           'spread eases': 5e-5, 'past the spread': 7e-5}.get(case)
    if case == 'f32 nan':
        got[0, 0, 0, 1] = np.nan
    elif case == 'f32 inf ref':
        ref[0, 0, 0, 1] = np.inf
    else:
        got[0, 1, 2, 0] += err
    return got, ref, None if case == 'f32 over' else spread


@pytest.mark.parametrize('case,bad,eased', [
    ('u8 off by 1', 0, 0),
    ('u8 off by 2', 1, 0),
    ('f32 within', 0, 0),
    ('f32 over', 1, 0),
    ('f32 nan', 1, 0),
    ('f32 inf ref', 1, 0),
    ('spread eases', 0, 1),
    ('past the spread', 1, 0),
])
def test_replay_mismatch_rules(monkeypatch, case, bad, eased):
    # the replay tolerance: 1 LSB, 2e-5 absolute, non-finite values fail,
    # and a float32 value may use SPREAD_FACTOR x the chain's own spread
    from exposure_jax.ops import chain
    monkeypatch.setattr(chain, 'SPREAD_FRAC', 0.1)
    got, ref, spread = _mismatch_case(case)
    worst, n_bad, n_eased = replay_mismatch(got, ref, spread)
    assert (n_bad, n_eased) == (bad, eased)
    if 'nan' in case or 'inf' in case:
        assert worst == np.inf


def test_replay_mismatch_spread_fraction():
    # more pixels needing the allowance than SPREAD_FRAC of the image
    # (here one of 16) lose it: all of them count as bad
    got, ref, spread = _mismatch_case('spread eases')
    assert replay_mismatch(got, ref, spread)[1:] == (1, 0)


def _two_step(filters, pixel, first='ExposureFilter'):
    """A [first (no-op parameters), S+ at full strength] chain on one
    pixel: (img, ids, params)."""
    names = [type(f).__name__ for f in filters]
    ids = jnp.asarray([[names.index(first)],
                       [names.index('SaturationPlusFilter')]], jnp.int32)
    params = np.zeros((2, 1, max_filter_parameters(filters)), np.float32)
    params[1] = 1.0  # S+ strength 1; exposure 0 stops is the identity
    img = jnp.asarray(np.array(pixel, np.float32).reshape(1, 1, 1, 3))
    return img, ids, jnp.asarray(params)


@pytest.mark.parametrize('pixel,ill', [
    ((0.5, 0.5001, 0.4999), True),    # range 0.04% of the value
    ((0.5, 0.6, 0.3), False),
])
def test_rounding_spread(filters, pixel, ill):
    # the chain's own spread is large where an S+ step sees a near-gray
    # pixel and about PERTURB x the value elsewhere; inactive steps add
    # none
    img, ids, params = _two_step(filters, pixel)
    spread = float(rounding_spread(img, ids, params, filters).max())
    assert (spread > F32_TOL) == ill, spread
    assert spread < (1e-3 if ill else 1e-6)
    off = rounding_spread(img, ids, params, filters,
                          active_steps=jnp.zeros((2, 1)))
    assert not np.asarray(off).any()


def test_saturation_amplifies_near_gray_differences(filters):
    # why the allowance exists: at a near-gray pixel the jnp chain's own
    # S+ output moves by more than F32_TOL when one input channel moves
    # by one float32 step, and the chain's spread covers that move
    img, ids, params = _two_step(filters, (0.5, 0.5001, 0.4999))
    nudged = np.asarray(img).copy()
    nudged[..., 0] = np.nextafter(nudged[..., 0], np.float32(1))
    out = [np.asarray(apply_filter_chain(x, ids, params, filters))
           for x in (img, jnp.asarray(nudged))]
    move = np.abs(out[0] - out[1]).max()
    spread = float(rounding_spread(img, ids, params, filters).max())
    assert F32_TOL < move <= F32_TOL + SPREAD_FACTOR * spread, (move,
                                                                 spread)


@pytest.mark.parametrize('platform,expected', [
    ('cpu', replay_filter_chain),
    ('gpu', pallas_apply_filter_chain),
    ('rocm', NotImplementedError),
])
def test_select_chain_replay(monkeypatch, platform, expected):
    monkeypatch.setattr(jax, 'default_backend', lambda: platform)
    if expected is NotImplementedError:
        with pytest.raises(NotImplementedError, match=platform):
            select_chain_replay()
    else:
        assert select_chain_replay() is expected
    # interpret mode only when asked for, on any platform
    fn = select_chain_replay(interpret=True)
    assert fn.func is pallas_apply_filter_chain
    assert fn.keywords == {'interpret': True}


@pytest.mark.parametrize('dtype,masked', [(jnp.uint8, False),
                                          (jnp.float32, False),
                                          (jnp.uint8, True)])
def test_kernel_lowers_for_gpu(rng, dtype, masked):
    # the kernel lowers to Triton IR for CUDA without a card: every
    # primitive has a Triton lowering and every block is a power of two
    cfg = load_config('masked' if masked else 'test')
    fs = [f(cfg) for f in cfg.filters]
    img = jnp.zeros((2, 40, 52, 3), dtype)
    ids = jnp.asarray(rng.randint(0, len(fs) + 1, (5, 2)).astype(np.int32))
    params = jnp.zeros((5, 2, max_filter_parameters(fs)), jnp.float32)
    mask = jnp.zeros((5, 2, 6), jnp.float32) if masked else None
    fn = jax.jit(lambda im, i, p, m: pallas_apply_filter_chain(
        im, i, p, fs, mask_params=m))
    text = fn.trace(img, ids, params, mask).lower(
        lowering_platforms=('cuda',)).as_text()
    assert 'xla.gpu.triton' in text


@pytest.fixture
def gpu():
    """Skips the test unless JAX runs on a GPU (decided at run time, so
    every worker collects the same tests)."""
    if jax.default_backend() != 'gpu':
        pytest.skip('needs a GPU: the kernel compiles only for the card')


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_kernel_on_card_matches_jnp_chain(gpu, rng, filters, dtype):
    b, h, w = 3, 257, 383
    img = rng.rand(b, h, w, 3).astype(np.float32) * 0.9
    if dtype == 'uint8':
        img = (img * 255).astype(np.uint8)
    img = jnp.asarray(img)
    ids, params = random_trajectory(rng, filters, 5, b)
    got = jax.jit(lambda *a: pallas_apply_filter_chain(*a, filters))(
        img, ids, params)
    ref = jax.jit(lambda *a: replay_filter_chain(*a, filters))(
        img, ids, params)
    spread = None if dtype == 'uint8' else jax.jit(
        lambda *a: rounding_spread(*a, filters))(img, ids, params)
    worst, n_bad, _ = replay_mismatch(got, ref, spread)
    assert n_bad == 0, worst
