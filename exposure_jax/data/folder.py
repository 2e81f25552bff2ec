"""Custom-dataset provider: any folder of images (parity with reference
folder_data_provider.py:8-45; used by the sintel config)."""

import os

from exposure_jax.data.artist import _load_crops
from exposure_jax.data.provider import DataProvider


class FolderDataProvider(DataProvider):

    def __init__(self,
                 folder,
                 read_limit=-1,
                 main_size=80,
                 crop_size=64,
                 augmentation_factor=4,
                 *args,
                 **kwargs):
        files = sorted(os.listdir(folder))
        if read_limit != -1:
            files = files[:read_limit]
        data = _load_crops(folder, files, main_size, crop_size,
                           augmentation_factor)
        kwargs.pop('bnw', None)
        kwargs.pop('augmentation', None)
        kwargs.pop('output_size', None)
        super().__init__(data, *args, bnw=False, augmentation=1.0,
                         output_size=crop_size, **kwargs)
