"""Quantitative eval: histogram intersection between output and target
image-statistics distributions.

Parity with reference histogram_intersection.py:11-72: per image, 16
random 64x64 crops (4 square crops resized to 80, 4 sub-crops each);
statistics = [luminance mean, 2 x luminance std (contrast), mean HLS
saturation]; 32-bin histograms over [0, 1]; intersection = sum(min).

Usage: python -m exposure_jax.tools.histogram_intersection <output_dir>
<target_dir> [--set FOLD]
"""

import argparse
import os
import random

import numpy as np

HIST_BINS = 32


def hist_intersection(a, b):
    return np.minimum(a, b).sum()


def _rgb_to_hls_saturation(img):
    """Mean HLS saturation of a float RGB image (cv2-free fallback)."""
    try:
        import cv2
        hls = cv2.cvtColor(img, cv2.COLOR_RGB2HLS)
        return hls[:, :, 2].mean()
    except ImportError:
        mx = img.max(axis=2)
        mn = img.min(axis=2)
        l = (mx + mn) / 2
        denom = np.where(l <= 0.5, mx + mn, 2.0 - mx - mn)
        s = np.where(mx > mn, (mx - mn) / (denom + 1e-9), 0.0)
        return s.mean()


def get_statistics(img):
    img = np.clip(img, 0.0, 1.0)
    lum = img[:, :, 0] * 0.27 + img[:, :, 1] * 0.67 + img[:, :, 2] * 0.06
    sat = _rgb_to_hls_saturation(img)
    return [lum.mean(), lum.std() * 2, sat]


def calc_hist(arr, nbins=HIST_BINS, xrange=(0.0, 1.0)):
    h, _ = np.histogram(a=arr, bins=nbins, range=xrange, density=False)
    return h / float(len(arr))


def get_histograms(images):
    statistics = np.array(list(zip(*map(get_statistics, images))))
    hists = [calc_hist(x) for x in statistics]
    return hists, statistics


def read_images(src, tag=None, fold=None, data_root='.', seed=None):
    from exposure_jax.utils.image_io import read_image
    if seed is not None:
        random.seed(seed)
    fold_ids = None
    if fold is not None:
        from exposure_jax.data.folds import read_set
        fold_ids = set(read_set(fold, data_root))
    try:
        import cv2
    except ImportError:
        cv2 = None
    images = []
    for f in sorted(os.listdir(src)):
        if tag and tag not in f:
            continue
        if fold_ids is not None:
            try:
                if int(f.split('.')[0]) not in fold_ids:
                    continue
            except ValueError:
                continue
        image = read_image(os.path.join(src, f))
        longer_edge = min(image.shape[0], image.shape[1])
        for _ in range(4):
            sx = random.randrange(0, image.shape[0] - longer_edge + 1)
            sy = random.randrange(0, image.shape[1] - longer_edge + 1)
            square = image[sx:sx + longer_edge, sy:sy + longer_edge]
            if cv2 is not None:
                patch = cv2.resize(square, (80, 80),
                                   interpolation=cv2.INTER_AREA)
            else:
                step = max(longer_edge // 80, 1)
                patch = square[::step, ::step][:80, :80]
            for _ in range(4):
                target = 64
                ssx = random.randrange(0, patch.shape[0] - target)
                ssy = random.randrange(0, patch.shape[1] - target)
                images.append(patch[ssx:ssx + target, ssy:ssy + target])
    return images


def compare_image_sets(images_a, images_b):
    """Histogram intersections between two in-memory image lists/arrays
    ([N, H, W, 3] float in [0, 1]); returns the 3 per-statistic values."""
    hists_a, _ = get_histograms(list(np.asarray(images_a)))
    hists_b, _ = get_histograms(list(np.asarray(images_b)))
    return [hist_intersection(a, b) for a, b in zip(hists_a, hists_b)]


def compare_dirs(output_src, target_src, fold=None, seed=None):
    output_imgs = read_images(output_src, seed=seed)
    target_imgs = read_images(target_src, fold=fold, seed=seed)
    output_hists, _ = get_histograms(output_imgs)
    target_hists, _ = get_histograms(target_imgs)
    ints = [hist_intersection(a, b)
            for a, b in zip(output_hists, target_hists)]
    return ints


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('output_src')
    parser.add_argument('target_src')
    parser.add_argument('--set', dest='fold', default=None)
    args = parser.parse_args()
    ints = compare_dirs(args.output_src, args.target_src, fold=args.fold)
    print('Hist. Inter.: %.2f%% %.2f%% %.2f%%' %
          (ints[0] * 100, ints[1] * 100, ints[2] * 100))
    print('         Avg: %.2f%%' % (sum(ints) / len(ints) * 100))


if __name__ == '__main__':
    main()
