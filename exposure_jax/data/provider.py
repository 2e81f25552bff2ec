"""Host-side data providers.

Parity with the reference ``DataProvider`` (data_provider.py:10-140): an
in-RAM float32 image array, epoch-shuffled indices, random-crop +
horizontal-flip augmentation, and ``get_next_batch(bs) -> (images,
features)``.

Design difference: the hot training path does NOT stream batches from
the host.  Providers expose :meth:`device_pack` — the full augmented-source
array plus sampling metadata — which the trainer ``jax.device_put``s into
device memory once; random crop/flip sampling then happens *inside* the jitted train
step (``exposure_jax.data.device_sampler``), so the input pipeline costs
zero host round-trips.  ``get_next_batch`` is kept for host-side tooling
(visualization, metrics) and API parity.
"""

import random

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from exposure_jax.data.device_sampler import DevicePack


class DataProvider:

    def __init__(self,
                 data,
                 output_size=-1,
                 limit=-1,
                 augmentation=0,
                 bnw=False,
                 default_batch_size=64,
                 image_scaling=1.0,
                 synchronous=True,
                 *args,
                 **kwargs):
        if limit == -1:
            limit = data.shape[0]
        elif isinstance(limit, float):
            limit = int(data.shape[0] * limit)
        self.image_scaling = image_scaling
        self.data = np.asarray(data[:limit], dtype=np.float32)
        self.bnw = bnw
        if self.bnw:
            lum = (0.27 * self.data[..., 0] + 0.67 * self.data[..., 1] +
                   0.06 * self.data[..., 2])
            self.data = lum[..., None]
        self.num_images = len(self.data)
        self.default_batch_size = default_batch_size
        self.image_size = self.data.shape[1:3]
        self.augmentation = augmentation
        self.indices = list(range(self.num_images))
        random.shuffle(self.indices)
        if output_size == -1:
            self.output_size = self.data.shape[1:3]
        else:
            self.output_size = (output_size, output_size)

    # ------------------------------------------------------------------
    # Device-resident path
    # ------------------------------------------------------------------
    def device_pack(self):
        """Full source array + sampling metadata for on-device sampling."""
        return DevicePack(
            images=self.data * self.image_scaling,
            output_size=self.output_size[0],
            augment=self.augmentation > 0,
        )

    # ------------------------------------------------------------------
    # Host-side path (parity with reference data_provider.py:59-118)
    # ------------------------------------------------------------------
    def augment_one(self, img):
        s = self.output_size[0]
        sx = random.randrange(0, img.shape[0] - s + 1)
        sy = random.randrange(0, img.shape[1] - s + 1)
        img = img[sx:sx + s, sy:sy + s]
        if random.random() < 0.5:
            img = img[:, ::-1]
        if img.ndim < 3:
            img = img[:, :, None]
        return img

    def _resize(self, img):
        if img.shape[:2] == tuple(self.output_size):
            return img
        if cv2 is not None:
            out = cv2.resize(img, self.output_size)
            if out.ndim < 3:
                out = out[:, :, None]
            return out
        # crude fallback: nearest-neighbor index resize
        h, w = img.shape[:2]
        ys = (np.arange(self.output_size[0]) * h // self.output_size[0])
        xs = (np.arange(self.output_size[1]) * w // self.output_size[1])
        return img[ys][:, xs]

    def get_next_batch(self, batch_size):
        batch = []
        while len(batch) < batch_size:
            s = min(len(self.indices), batch_size - len(batch))
            batch += self.indices[:s]
            self.indices = self.indices[s:]
            if not self.indices:
                self.indices = list(range(self.num_images))
                random.shuffle(self.indices)
        out = np.empty((batch_size,) + tuple(self.output_size) +
                       self.data.shape[3:], dtype=self.data.dtype)
        for i, idx in enumerate(batch):
            if self.augmentation > 0:
                out[i] = self.augment_one(self.data[idx])
            else:
                out[i] = self._resize(self.data[idx])
        return out * self.image_scaling, np.zeros((batch_size,),
                                                  dtype=np.float32)

    def get_random_batch(self, batch_size):
        indices = list(range(self.num_images))
        random.shuffle(indices)
        indices = indices[:batch_size]
        return self.data[indices], np.zeros((len(indices),), dtype=np.float32)
