"""Build the native hostloader: ``python -m exposure_jax.native.build``.

Uses g++ directly (no pybind11/cmake dependency; the ABI is plain C
consumed via ctypes)."""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def build(verbose=True):
    src = os.path.join(HERE, 'hostloader.cpp')
    out = os.path.join(HERE, 'libhostloader.so')
    cmd = [
        'g++', '-O3', '-march=native', '-fopenmp', '-fPIC', '-shared',
        '-std=c++17', '-Wall', src, '-o', out,
    ]
    if verbose:
        print(' '.join(cmd))
    subprocess.check_call(cmd)
    if verbose:
        print('built', out)
    return out


if __name__ == '__main__':
    sys.exit(0 if build() else 1)
