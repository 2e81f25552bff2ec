"""Data-layer tests: host providers (epoch semantics, augmentation) and
the on-device sampler (crop/flip distribution, resize path)."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from exposure_jax.data import DataProvider, SyntheticDataProvider
from exposure_jax.data.device_sampler import DevicePack, sample_batch
from exposure_jax.data.folds import read_set


class TestHostProvider:
    def test_epoch_covers_all_images(self, rng):
        data = rng.rand(10, 64, 64, 3).astype(np.float32)
        # stamp index into pixel 0 so batches are identifiable
        for i in range(10):
            data[i, 0, 0, 0] = i / 10.0
        dp = DataProvider(data, output_size=64, augmentation=0)
        seen = set()
        for _ in range(2):
            batch, feats = dp.get_next_batch(5)
            assert feats.shape == (5,)
            seen.update(np.round(batch[:, 0, 0, 0] * 10).astype(int)
                        .tolist())
        assert seen == set(range(10))

    def test_augmentation_crops_to_output_size(self, rng):
        data = rng.rand(4, 80, 80, 3).astype(np.float32)
        dp = DataProvider(data, output_size=64, augmentation=0.3)
        batch, _ = dp.get_next_batch(8)
        assert batch.shape == (8, 64, 64, 3)

    def test_resize_path(self, rng):
        data = rng.rand(4, 80, 80, 3).astype(np.float32)
        dp = DataProvider(data, output_size=64, augmentation=0)
        batch, _ = dp.get_next_batch(4)
        assert batch.shape == (4, 64, 64, 3)

    def test_bnw_collapses_channels(self, rng):
        data = rng.rand(4, 64, 64, 3).astype(np.float32)
        dp = DataProvider(data, output_size=64, bnw=True)
        batch, _ = dp.get_next_batch(2)
        assert batch.shape == (2, 64, 64, 1)
        lum = (0.27 * data[..., 0] + 0.67 * data[..., 1] +
               0.06 * data[..., 2])
        assert abs(batch.mean() - lum.mean()) < 0.2

    def test_device_pack_metadata(self, rng):
        dp = SyntheticDataProvider(n=8, size=80, output_size=64,
                                   augmentation=0.3)
        pack = dp.device_pack()
        assert pack.images.shape == (8, 80, 80, 3)
        assert pack.output_size == 64
        assert pack.augment


class TestDeviceSampler:
    def test_crop_shapes_and_source(self, rng):
        imgs = jnp.asarray(rng.rand(16, 80, 80, 3).astype(np.float32))
        pack = DevicePack(imgs, 64, True)
        batch = sample_batch(pack, jax.random.PRNGKey(0), 32)
        assert batch.shape == (32, 64, 64, 3)
        # every crop's pixels exist in the source value range
        assert float(batch.min()) >= float(imgs.min()) - 1e-6
        assert float(batch.max()) <= float(imgs.max()) + 1e-6

    def test_resize_when_not_augmenting(self, rng):
        imgs = jnp.asarray(rng.rand(4, 80, 80, 3).astype(np.float32))
        pack = DevicePack(imgs, 64, False)
        batch = sample_batch(pack, jax.random.PRNGKey(0), 8)
        assert batch.shape == (8, 64, 64, 3)

    def test_flip_happens(self, rng):
        # asymmetric image: left half 0, right half 1
        img = np.zeros((1, 64, 64, 3), np.float32)
        img[:, :, 32:] = 1.0
        pack = DevicePack(jnp.asarray(img), 64, True)
        lefts = []
        for seed in range(20):
            b = sample_batch(pack, jax.random.PRNGKey(seed), 4)
            lefts.extend(np.asarray(b[:, 0, 0, 0]).tolist())
        # with p=0.5 flips, both orientations must appear
        assert 0.0 in lefts and 1.0 in lefts

    def test_crop_offsets_vary(self, rng):
        base = np.arange(80, dtype=np.float32)
        img = np.broadcast_to(base[None, :, None, None],
                              (1, 80, 80, 3)).copy()
        pack = DevicePack(jnp.asarray(img), 64, True)
        firsts = set()
        for seed in range(30):
            b = sample_batch(pack, jax.random.PRNGKey(seed), 2)
            firsts.update(np.asarray(b[:, 0, 40, 0]).astype(int).tolist())
        assert len(firsts) > 3  # multiple distinct crop offsets drawn


class TestFolds:
    def test_read_set_5k(self):
        ids = read_set('5k')
        assert ids == list(range(1, 5001))

    def test_read_set_from_file(self, tmp_path):
        fold_dir = tmp_path / 'data' / 'folds'
        os.makedirs(fold_dir)
        (fold_dir / 'FiveK_train_first2k.txt').write_text(
            '# comment\n1\n5\n42\n')
        ids = read_set('2k_train', data_root=str(tmp_path))
        assert ids == [1, 5, 42]

    def test_unknown_fold_raises(self):
        import pytest
        with pytest.raises(ValueError):
            read_set('nope')


class TestSyntheticSpread:
    """`spread` widens the retouched targets' contrast/saturation
    distributions along the policy-reachable axes (DIVERSITY.md
    addendum); spread=0 must stay bit-identical to the historical
    pack so existing runs/configs remain reproducible."""

    def test_spread_zero_is_bit_identical(self):
        from exposure_jax.data.synthetic import make_synthetic_pack
        a = make_synthetic_pack(64, 48, 'retouched', seed=2)
        b = make_synthetic_pack(64, 48, 'retouched', seed=2, spread=0.0)
        assert np.array_equal(a, b)

    def test_spread_widens_contrast_and_saturation(self):
        from exposure_jax.data.synthetic import make_synthetic_pack
        lum_w = np.asarray([0.27, 0.67, 0.06], np.float32)

        def contrast_std(pack):
            lum = (pack * lum_w).sum(-1)
            return (2 * lum.std(axis=(1, 2))).std()

        base = make_synthetic_pack(512, 48, 'retouched', seed=2)
        wide = make_synthetic_pack(512, 48, 'retouched', seed=2,
                                   spread=1.0)
        assert contrast_std(wide) > 1.2 * contrast_std(base)
        assert wide.min() >= 0.0 and wide.max() <= 1.0

    def test_wide_config_loads(self):
        from exposure_jax.utils.config import load_config
        cfg = load_config('synthetic_wide')
        pack = cfg.real_data_provider().data
        assert pack.shape[1:] == (64, 64, 3)


class TestSyntheticTexture:
    """`texture` adds the structural-realism pressure smooth fields
    lack (DIVERSITY.md addendum 2): high-frequency detail plus
    soft-knee (never-flat) target tone compression.  texture=0 must
    stay bit-identical to the historical pack."""

    def test_texture_zero_is_bit_identical(self):
        from exposure_jax.data.synthetic import make_synthetic_pack
        for style in ('raw', 'retouched'):
            a = make_synthetic_pack(32, 48, style, seed=2)
            b = make_synthetic_pack(32, 48, style, seed=2, texture=0.0)
            assert np.array_equal(a, b)

    def test_textured_targets_never_clip_flat(self):
        from exposure_jax.data.synthetic import make_synthetic_pack
        t = make_synthetic_pack(64, 80, 'retouched', seed=2,
                                texture=1.0)
        # the soft tanh knee never saturates...
        assert t.min() > 0.0 and t.max() < 1.0
        # ...and every bright 4x4 patch keeps texture (hard-clip packs
        # would manufacture exactly-flat saturated patches)
        lum_w = np.asarray([0.27, 0.67, 0.06], np.float32)
        lum = (t * lum_w).sum(-1)
        p = lum.reshape(64, 20, 4, 20, 4).transpose(
            0, 1, 3, 2, 4).reshape(-1, 16)
        hi = p.mean(-1) > 0.8
        assert hi.any()
        assert p.std(-1)[hi].min() > 5e-4

    def test_texture_is_bounded_multiplicative_detail(self):
        # base RNG streams are untouched, so the raw packs are aligned
        # image-for-image and the knob shows up as a bounded
        # multiplicative perturbation (±15% pre-gamma)
        from exposure_jax.data.synthetic import make_synthetic_pack
        base = make_synthetic_pack(32, 48, 'raw', seed=0)
        tex = make_synthetic_pack(32, 48, 'raw', seed=0, texture=1.0)
        ratio = tex / np.maximum(base, 1e-4)
        assert 0.5 < ratio.min() and ratio.max() < 1.6
        # it genuinely adds per-image detail, not a global rescale
        assert ratio.std(axis=(1, 2, 3)).min() > 0.01

    def test_tex_config_loads(self):
        from exposure_jax.utils.config import load_config
        cfg = load_config('synthetic_tex')
        pack = cfg.real_data_provider().data
        assert pack.shape[1:] == (64, 64, 3)
        assert pack.max() < 1.0
