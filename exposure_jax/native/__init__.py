"""Native host-side runtime components (C++, ctypes-bound).

``hostloader``: a memory-mapped .npy pack reader with OpenMP-parallel
random-crop/flip batch sampling — the native IO path for image packs too
large for device-memory residency (the default on-device pipeline,
data/device_sampler.py, is preferred whenever the pack fits).

Build: ``python -m exposure_jax.native.build`` (g++, no external deps).
Falls back transparently to the numpy provider when the shared library
is absent.
"""

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'libhostloader.so')
_lib = None


def library_available():
    return os.path.exists(_LIB_PATH)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.hl_open_pack.restype = ctypes.c_void_p
        lib.hl_open_pack.argtypes = [ctypes.c_char_p]
        lib.hl_pack_info.restype = ctypes.c_int
        lib.hl_pack_info.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_long)] * 4
        lib.hl_sample_crops.restype = ctypes.c_int
        lib.hl_sample_crops.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.c_ulonglong,
            np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS'),
        ]
        lib.hl_sample_crops_u8.restype = ctypes.c_int
        lib.hl_sample_crops_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.c_ulonglong,
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
        ]
        lib.hl_close_pack.restype = None
        lib.hl_close_pack.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativePack:
    """mmap'ed float32 .npy image pack with native batch sampling."""

    def __init__(self, path):
        if not library_available():
            raise RuntimeError(
                'libhostloader.so not built - run '
                'python -m exposure_jax.native.build')
        self._lib = _load()
        self._handle = self._lib.hl_open_pack(
            os.fsencode(os.path.abspath(path)))
        if not self._handle:
            raise IOError('hostloader could not open %s (needs a C-order '
                          'little-endian float32 4-D .npy)' % path)
        dims = [ctypes.c_long() for _ in range(4)]
        self._lib.hl_pack_info(self._handle, *[ctypes.byref(d)
                                               for d in dims])
        self.shape = tuple(d.value for d in dims)

    def sample(self, batch_size, out_size, augment=True, seed=0):
        """Draw a [batch, out, out, C] float32 crop batch."""
        n, h, w, c = self.shape
        out = np.empty((batch_size, out_size, out_size, c), np.float32)
        self.sample_into(out, augment=augment, seed=seed)
        return out

    def sample_into(self, out, augment=True, seed=0):
        """Fill a caller-owned C-contiguous [batch, S, S, C] buffer in
        ONE native call — the zero-restack path streaming training uses
        to assemble a whole multi-iteration bundle directly into its
        final layout (no per-iteration Python loop, no intermediate
        copy).  dtype float32 (exact pack values) or uint8 (pixels
        quantized round(clamp(x,0,1)*255) at write — 4x smaller bundle
        uploads; same RNG stream, so identical crops/flips)."""
        if (out.ndim != 4 or out.dtype not in (np.float32, np.uint8)
                or not out.flags.c_contiguous
                or out.shape[1] != out.shape[2]
                or out.shape[3] != self.shape[3]):
            raise ValueError('need C-contiguous [n, S, S, %d] float32 or '
                             'uint8, got %s %s' % (self.shape[3],
                                                   out.shape, out.dtype))
        fn = (self._lib.hl_sample_crops if out.dtype == np.float32
              else self._lib.hl_sample_crops_u8)
        rc = fn(
            self._handle, out.shape[0], out.shape[1], int(bool(augment)),
            np.uint64(seed) or 1, out)
        if rc != 0:
            raise ValueError('hl_sample_crops failed (%d); out_size %d vs '
                             'pack %s' % (rc, out.shape[1], self.shape))
        return out

    def close(self):
        if getattr(self, '_handle', None):
            self._lib.hl_close_pack(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
