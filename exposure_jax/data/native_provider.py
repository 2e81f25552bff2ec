"""Provider backed by the native hostloader (C++/mmap/OpenMP).

For image packs too large to hold in device memory (or even host RAM), this
provider streams augmented batches straight off the memory-mapped .npy
pack with native parallel crop/flip sampling — the scale-out alternative
to the default device-resident pipeline.  API-compatible with
``DataProvider.get_next_batch``."""

import numpy as np

from exposure_jax.native import NativePack, library_available


class NativePackProvider:

    def __init__(self, pack_path, output_size=64, augmentation=0.3,
                 default_batch_size=64, image_scaling=1.0, seed=0):
        if not library_available():
            raise RuntimeError('native hostloader not built; run '
                               'python -m exposure_jax.native.build')
        self.pack = NativePack(pack_path)
        self.output_size = (output_size, output_size)
        self.augmentation = augmentation
        self.default_batch_size = default_batch_size
        self.image_scaling = image_scaling
        self._seed = np.uint64(seed * 2654435761 + 1)
        self.num_images = self.pack.shape[0]

    def get_next_batch(self, batch_size):
        self._seed = np.uint64(self._seed + 0x9e3779b9)
        batch = self.pack.sample(batch_size, self.output_size[0],
                                 augment=self.augmentation > 0,
                                 seed=int(self._seed))
        if self.image_scaling != 1.0:
            batch = batch * self.image_scaling
        return batch, np.zeros((batch_size,), np.float32)

    def sample_into(self, dest):
        """Fill a C-contiguous [n, S, S, C] float32 OR uint8 view in ONE
        native call (streaming bundle assembly: no Python batch loop, no
        restack copy).  Advances the same seed stream as
        ``get_next_batch``; a uint8 dest gets the quantized pixels of
        the float32 bundle the same seed would produce (4x smaller
        host->device upload; dequantized inside the jitted step)."""
        self._seed = np.uint64(self._seed + 0x9e3779b9)
        if dest.dtype == np.uint8 and self.image_scaling != 1.0:
            raise ValueError('uint8 bundles cannot carry image_scaling '
                             '(%g); fold it into the device-side dequant '
                             'instead' % self.image_scaling)
        self.pack.sample_into(dest, augment=self.augmentation > 0,
                              seed=int(self._seed))
        if self.image_scaling != 1.0:
            dest *= self.image_scaling
        return dest

    def close(self):
        self.pack.close()
