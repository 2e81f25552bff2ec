"""Native hostloader tests: builds the C++ library if needed, verifies
crop correctness, determinism, flip coverage and the provider wrapper."""

import os
import subprocess
import sys

import numpy as np
import pytest

from exposure_jax.native import _LIB_PATH, library_available


@pytest.fixture(scope='module', autouse=True)
def built_library():
    if not library_available():
        subprocess.check_call(
            [sys.executable, '-m', 'exposure_jax.native.build'])
    assert library_available()


@pytest.fixture(scope='module')
def pack_file(tmp_path_factory):
    rng = np.random.RandomState(0)
    pack = rng.rand(20, 80, 80, 3).astype(np.float32)
    path = str(tmp_path_factory.mktemp('packs') / 'pack.npy')
    np.save(path, pack)
    return path, pack


def test_open_and_info(pack_file):
    from exposure_jax.native import NativePack
    path, pack = pack_file
    np_pack = NativePack(path)
    assert np_pack.shape == (20, 80, 80, 3)
    np_pack.close()


def test_crops_are_true_subwindows(pack_file):
    from exposure_jax.native import NativePack
    path, pack = pack_file
    np_pack = NativePack(path)
    batch = np_pack.sample(16, 64, augment=True, seed=7)
    assert batch.shape == (16, 64, 64, 3)
    for i in range(4):
        crop = batch[i]
        ok = False
        for n in range(20):
            for sx in range(17):
                for sy in range(17):
                    win = pack[n, sx:sx + 64, sy:sy + 64]
                    if np.array_equal(win, crop) or \
                            np.array_equal(win[:, ::-1], crop):
                        ok = True
                        break
                if ok:
                    break
            if ok:
                break
        assert ok, 'crop %d is not a pack subwindow' % i
    np_pack.close()


def test_deterministic_by_seed(pack_file):
    from exposure_jax.native import NativePack
    path, _ = pack_file
    np_pack = NativePack(path)
    a = np_pack.sample(32, 64, seed=5)
    b = np_pack.sample(32, 64, seed=5)
    c = np_pack.sample(32, 64, seed=6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np_pack.close()


def test_flips_occur(pack_file):
    from exposure_jax.native import NativePack
    path, pack = pack_file
    # asymmetric pack: gradient along width
    grad = np.tile(np.linspace(0, 1, 80, dtype=np.float32)[None, :, None],
                   (80, 1, 3))
    gpack = np.stack([grad] * 4)
    gpath = path + '.grad.npy'
    np.save(gpath, gpack)
    np_pack = NativePack(gpath)
    batch = np_pack.sample(64, 64, seed=3)
    rising = (batch[:, 0, -1, 0] > batch[:, 0, 0, 0])
    assert rising.any() and (~rising).any()  # both orientations present
    np_pack.close()
    os.remove(gpath)


def test_resize_when_not_augmenting(pack_file):
    # Python-provider parity: the non-augmented path bilinear-resizes the
    # whole image to output_size (data/provider.py:89-101, cv2.resize
    # INTER_LINEAR), NOT a center crop.
    cv2 = pytest.importorskip('cv2')
    from exposure_jax.native import NativePack
    path, pack = pack_file
    np_pack = NativePack(path)
    batch = np_pack.sample(8, 64, augment=False, seed=1)
    refs = np.stack([cv2.resize(im, (64, 64)) for im in pack])
    for crop in batch:
        diffs = np.abs(refs - crop[None]).reshape(len(pack), -1).max(axis=1)
        assert diffs.min() < 1e-6, 'non-augmented sample is not a bilinear' \
            ' resize of any pack image'
    np_pack.close()


def test_same_size_passthrough_when_not_augmenting(pack_file):
    from exposure_jax.native import NativePack
    path, pack = pack_file
    np_pack = NativePack(path)
    batch = np_pack.sample(8, 80, augment=False, seed=2)
    for crop in batch:
        assert any(np.array_equal(crop, im) for im in pack)
    np_pack.close()


def test_provider_wrapper(pack_file):
    from exposure_jax.data.native_provider import NativePackProvider
    path, _ = pack_file
    dp = NativePackProvider(path, output_size=64, augmentation=0.3)
    b1, feats = dp.get_next_batch(8)
    b2, _ = dp.get_next_batch(8)
    assert b1.shape == (8, 64, 64, 3)
    assert feats.shape == (8,)
    assert not np.array_equal(b1, b2)  # advancing seed
    dp.close()


def test_rejects_wrong_dtype(tmp_path):
    from exposure_jax.native import NativePack
    bad = str(tmp_path / 'bad.npy')
    np.save(bad, np.zeros((2, 8, 8, 3), np.float64))
    with pytest.raises(IOError):
        NativePack(bad)


def test_sample_into_matches_sample(pack_file):
    """The zero-restack bundle path (one native call into a caller view)
    is bit-identical to sample() at the same seed, validates layout, and
    the provider wrapper applies scaling in place."""
    from exposure_jax.data.native_provider import NativePackProvider
    from exposure_jax.native import NativePack
    path, _ = pack_file
    np_pack = NativePack(path)
    ref = np_pack.sample(12, 64, augment=True, seed=99)
    bundle = np.empty((3, 4, 64, 64, 3), np.float32)
    np_pack.sample_into(bundle.reshape(12, 64, 64, 3), augment=True,
                        seed=99)
    np.testing.assert_array_equal(bundle.reshape(12, 64, 64, 3), ref)

    with pytest.raises(ValueError):
        np_pack.sample_into(np.empty((4, 64, 64, 3), np.float64))
    with pytest.raises(ValueError):  # non-contiguous view
        np_pack.sample_into(
            np.empty((4, 64, 128, 3), np.float32)[:, :, ::2])
    np_pack.close()

    dp = NativePackProvider(path, output_size=64, augmentation=0.3,
                            image_scaling=2.0, seed=5)
    dp2 = NativePackProvider(path, output_size=64, augmentation=0.3,
                             image_scaling=2.0, seed=5)
    dest = np.empty((8, 64, 64, 3), np.float32)
    dp.sample_into(dest)
    batch, _ = dp2.get_next_batch(8)
    np.testing.assert_array_equal(dest, batch)
    dp.close()
    dp2.close()


def test_sample_u8_quantizes_same_crops(pack_file):
    # the u8 variant must follow the SAME RNG stream (identical crop/
    # flip selection) and write round(clamp(x,0,1)*255) of the f32
    # pixels — both on the augmented-crop path and the bilinear-resize
    # path (hostloader.cpp sample_crops_impl<unsigned char>)
    from exposure_jax.native import NativePack
    path, _ = pack_file
    np_pack = NativePack(path)
    for augment, out_size in ((True, 64), (False, 48)):
        f32 = np.empty((12, out_size, out_size, 3), np.float32)
        u8 = np.empty((12, out_size, out_size, 3), np.uint8)
        np_pack.sample_into(f32, augment=augment, seed=123)
        np_pack.sample_into(u8, augment=augment, seed=123)
        expect = (np.clip(f32, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(u8, expect)
        assert u8.std() > 0  # non-degenerate content
    np_pack.close()


def test_provider_u8_rejects_scaling(pack_file):
    from exposure_jax.data.native_provider import NativePackProvider
    path, _ = pack_file
    dp = NativePackProvider(path, output_size=64, augmentation=0.3,
                            image_scaling=2.0, seed=5)
    with pytest.raises(ValueError):
        dp.sample_into(np.empty((4, 64, 64, 3), np.uint8))
    dp.close()
