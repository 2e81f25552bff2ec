"""Exercise the REAL FiveK data path end to end on generated artifacts.

The genuine MIT-Adobe FiveK download needs network egress; these tests
build a layout-faithful miniature of the dataset tree on disk — 16-bit
Lightroom-style TIFF exports, the preprocessed 80x80 RAW pack, fold id
files, and artist JPEGs — and run the exact production code path over it:
``preprocess_raw_aug`` -> ``image_raw.npy``/``meta_raw.pkl`` ->
``FiveKDataProvider`` (fold filtering) and ``ArtistDataProvider``
(2k_target selection), up to the flagship ``config_example`` provider
lambdas.  The only thing left untested is the download itself
(tools/fetch_fivek.py URLs)."""

import os
import pickle

import imageio.v2 as imageio
import numpy as np
import pytest

from exposure_jax.data.fivek import (
    AUGMENTATION_FACTOR,
    FiveKDataProvider,
    preprocess_raw_aug,
)

N_IMAGES = 6


@pytest.fixture(scope='module')
def fivek_tree(tmp_path_factory):
    """A miniature FiveK dataset tree with the real on-disk layout."""
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp('fivek_root')

    src = root / 'data' / 'fivek_dataset' / \
        'FiveK_Lightroom_Export_InputDayLight'
    src.mkdir(parents=True)
    for i in range(N_IMAGES):
        img16 = (rng.rand(100, 120, 3) * 65535).astype(np.uint16)
        imageio.imwrite(str(src / ('a%04d.tif' % (i + 1))), img16)

    folds = root / 'data' / 'folds'
    folds.mkdir(parents=True)
    (folds / 'FiveK_train_first2k.txt').write_text('1\n2\n3\n')
    (folds / 'FiveK_test.txt').write_text('4\n')
    (folds / 'FiveK_train_second2k.txt').write_text('5\n6\n')
    (folds / 'FiveK_test_AMT.txt').write_text('4\n')

    artists = root / 'data' / 'artists' / 'FiveK_C'
    artists.mkdir(parents=True)
    for i in range(N_IMAGES):
        img8 = (rng.rand(90, 110, 3) * 255).astype(np.uint8)
        imageio.imwrite(str(artists / ('a%04d.jpg' % (i + 1))), img8)

    return root


@pytest.fixture(scope='module')
def built_pack(fivek_tree):
    src = str(fivek_tree / 'data' / 'fivek_dataset' /
              'FiveK_Lightroom_Export_InputDayLight')
    out = str(fivek_tree / 'data' / 'fivek_dataset' /
              'sup_batched80aug_daylight')
    images = preprocess_raw_aug(source_dir=src, batched_dir=out)
    return out, images


def test_preprocess_builds_reference_layout(built_pack):
    out, images = built_pack
    assert images.shape == (N_IMAGES * AUGMENTATION_FACTOR, 80, 80, 3)
    assert images.dtype == np.float32
    assert np.isfinite(images).all() and images.min() >= 0
    pack = np.load(os.path.join(out, 'image_raw.npy'))
    assert pack.shape == images.shape
    with open(os.path.join(out, 'meta_raw.pkl'), 'rb') as f:
        meta = pickle.load(f)
    assert len(meta['filenames']) == N_IMAGES


def test_fivek_provider_full_path(fivek_tree, built_pack):
    # the production constructor: pack load + fold filter + provider
    FiveKDataProvider._raw_image_pack = None  # reset the class cache
    try:
        dp = FiveKDataProvider(set_name='2k_train',
                               data_root=str(fivek_tree),
                               output_size=64, augmentation=0.3,
                               default_batch_size=8)
        # 3 fold ids x 4 crops
        assert dp.num_images == 3 * AUGMENTATION_FACTOR
        batch, feats = dp.get_next_batch(8)
        assert batch.shape == (8, 64, 64, 3)
        assert np.isfinite(batch).all()
        pack = dp.device_pack()
        assert pack.images.shape[1:] == (80, 80, 3)

        dp_test = FiveKDataProvider(set_name='u_test',
                                    data_root=str(fivek_tree),
                                    output_size=64, augmentation=0.0,
                                    default_batch_size=4)
        assert dp_test.num_images == 1 * AUGMENTATION_FACTOR
    finally:
        FiveKDataProvider._raw_image_pack = None


def test_artist_provider_full_path(fivek_tree):
    from exposure_jax.data.artist import ArtistDataProvider
    dp = ArtistDataProvider(set_name='2k_target',
                            data_root=str(fivek_tree),
                            output_size=64, augmentation=1.0,
                            default_batch_size=8)
    # 2 fold files x augmentation_factor 4 crops
    assert dp.num_images == 2 * 4
    batch, _ = dp.get_next_batch(8)
    assert batch.shape == (8, 64, 64, 3)


def test_flagship_config_provider_lambdas(fivek_tree, built_pack,
                                          monkeypatch):
    # the exact provider wiring of config_example, against the miniature
    # tree (the reference workflow's first step, net.py train path)
    from exposure_jax.utils.config import load_config
    FiveKDataProvider._raw_image_pack = None
    monkeypatch.chdir(str(fivek_tree))
    try:
        cfg = load_config('example')
        fake = cfg.fake_data_provider()
        real = cfg.real_data_provider()
        test = cfg.fake_data_provider_test()
        b, _ = fake.get_next_batch(cfg.batch_size)
        assert b.shape == (cfg.batch_size, 64, 64, 3)
        r, _ = real.get_next_batch(16)
        assert r.shape == (16, 64, 64, 3)
        t, _ = test.get_next_batch(4)
        assert t.shape == (4, 64, 64, 3)
    finally:
        FiveKDataProvider._raw_image_pack = None


def test_import_validator(fivek_tree, built_pack):
    """validate_pack flags size mismatches vs the real-pack spec but
    correctly checks structure/dtype/range on a dropped tree; a
    spec-shaped pack passes clean (the one-command import contract,
    tools/import_reference_data.py)."""
    from exposure_jax.tools.import_reference_data import (
        PACK_REL, validate_pack)
    ok, findings = validate_pack(str(fivek_tree))
    # miniature tree: pack/fold/artist SIZES differ from the real spec,
    # structural checks pass (everything present, readable, sane dtype)
    assert not ok
    assert all('MISSING' not in f and 'unreadable' not in f
               and 'non-finite' not in f for f in findings), findings

    # a spec-shaped pack + folds + artist set passes clean (the pack is
    # a SPARSE memmap — only the validator's strided sample pages are
    # materialized, so the test does not write 1.5 GB)
    import numpy as np
    root = fivek_tree / 'spec_root'
    pack_path = root / PACK_REL
    pack_path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.lib.format.open_memmap(
        str(pack_path), mode='w+', dtype=np.float32,
        shape=(20000, 80, 80, 3))
    stride = max(arr.shape[0] // 64, 1)  # the validator's sample stride
    arr[::stride] = 0.25
    arr.flush()
    del arr
    folds = root / 'data' / 'folds'
    folds.mkdir(parents=True, exist_ok=True)
    for fn, n in (('FiveK_train_first2k.txt', 2000),
                  ('FiveK_train_second2k.txt', 2000),
                  ('FiveK_test.txt', 1000),
                  ('FiveK_test_AMT.txt', 100)):
        (folds / fn).write_text(
            ''.join('%d\n' % i for i in range(1, n + 1)))
    artists = root / 'data' / 'artists' / 'FiveK_C'
    artists.mkdir(parents=True, exist_ok=True)
    for i in range(4000):
        (artists / ('a%04d.jpg' % i)).write_bytes(b'\xff\xd8\xff\xd9')
    # strict (default): synthetic folds have the right line counts but
    # NOT the canonical release checksums -> every fold flagged
    ok2s, findings2s = validate_pack(str(root))
    assert not ok2s
    assert sum('sha256' in f for f in findings2s) == 4, findings2s
    # non-strict accepts them (line counts still enforced)
    ok2, findings2 = validate_pack(str(root), strict_folds=False)
    assert ok2, findings2

    # a fold whose digest MATCHES the canonical table passes strict:
    # point the table at the synthetic file's own digest
    from exposure_jax.tools import import_reference_data as ird
    rel = 'data/folds/FiveK_test_AMT.txt'
    saved = ird.FOLD_SHA256[rel]
    try:
        ird.FOLD_SHA256[rel] = ird._sha256_file(str(root / rel))
        _, findings_m = validate_pack(str(root))
        assert not any(rel in f and 'sha256' in f for f in findings_m)
    finally:
        ird.FOLD_SHA256[rel] = saved

    # corrupt the pack -> flagged
    arr = np.lib.format.open_memmap(str(pack_path), mode='r+')
    arr[0, 0, 0, 0] = np.nan
    arr.flush()
    del arr
    ok3, findings3 = validate_pack(str(root), strict_folds=False)
    assert not ok3 and any('non-finite' in f for f in findings3)
