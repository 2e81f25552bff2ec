"""Target (artist-retouched) set provider.

Loads ``data/artists/<name>/*.jpg`` (expert-retouched renditions),
center-crops, resizes to ``main_size`` and pre-builds ``augmentation_factor``
random 64x64 crops with flips in memory — parity with reference
artist.py:16-71, including the 2k_target fold selection by filename index
(artist.py:39-49)."""

import os
import random

import numpy as np

from exposure_jax.data.folds import read_set
from exposure_jax.data.provider import DataProvider
from exposure_jax.utils.image_io import get_image_center, read_image

SOURCE_DIR = 'data/artists'


def _load_crops(folder, files, main_size, crop_size, augmentation_factor):
    try:
        import cv2
    except ImportError:
        cv2 = None
    data = []
    for f in files:
        image = read_image(os.path.join(folder, f))
        image = get_image_center(image)
        if cv2 is not None:
            image = cv2.resize(image, (main_size, main_size),
                               interpolation=cv2.INTER_AREA)
        else:
            h = image.shape[0]
            step = max(h // main_size, 1)
            image = image[::step, ::step][:main_size, :main_size]
        for _ in range(augmentation_factor):
            new_image = image
            if random.random() < 0.5:
                new_image = new_image[:, ::-1, :]
            sx = random.randrange(main_size - crop_size + 1)
            sy = random.randrange(main_size - crop_size + 1)
            data.append(new_image[sx:sx + crop_size, sy:sy + crop_size])
    return np.stack(data, axis=0)


class ArtistDataProvider(DataProvider):

    def __init__(self,
                 read_limit=-1,
                 name='FiveK_C',
                 main_size=80,
                 crop_size=64,
                 augmentation_factor=4,
                 set_name=None,
                 data_root='.',
                 *args,
                 **kwargs):
        folder = os.path.join(data_root, SOURCE_DIR, name)
        files = sorted(os.listdir(folder))
        if isinstance(set_name, str) and set_name.endswith('.txt'):
            idx = [int(x) for x in open(set_name).readlines()]
            files = list(np.array(files)[np.array(idx)])
        elif set_name == '2k_target':
            idx = read_set('2k_target', data_root)
            files = list(np.array(files)[np.array(idx) - 1])
        if read_limit != -1:
            files = files[:read_limit]
        files.sort()
        data = _load_crops(folder, files, main_size, crop_size,
                           augmentation_factor)
        super().__init__(data, *args, **kwargs)
