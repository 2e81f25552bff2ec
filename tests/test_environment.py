"""What the program needs from its environment: where the compile cache
goes, and which packages the main paths import."""

import os
import subprocess
import sys

import pytest

import exposure_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('environ,expected', [
    ({}, os.path.join(ROOT, '.jax_cache')),
    ({'JAX_COMPILATION_CACHE_DIR': '/elsewhere'}, None),
    ({'JAX_COMPILATION_CACHE_DIR': ''}, os.path.join(ROOT, '.jax_cache')),
], ids=['unset', 'set', 'empty'])
def test_compile_cache_dir_rule(environ, expected):
    assert exposure_jax.compile_cache_dir(environ) == expected


_CACHE_PROBE = '''
import os, jax, jax.numpy as jnp
import exposure_jax
jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)
jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.arange(7.0)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
'''


@pytest.mark.parametrize('set_var', [True, False])
def test_compile_cache_receives_entries(tmp_path, set_var):
    # with the variable set, JAX's own reading of it decides; unset, the
    # checkout's .jax_cache does
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop('JAX_COMPILATION_CACHE_DIR', None)
    if set_var:
        env['JAX_COMPILATION_CACHE_DIR'] = str(tmp_path / 'cache')
    out = subprocess.run([sys.executable, '-c', _CACHE_PROBE], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    used = out.stdout.strip().splitlines()[-1]
    expected = str(tmp_path / 'cache') if set_var else \
        os.path.join(ROOT, '.jax_cache')
    assert used == expected
    assert os.listdir(expected)


_BLOCKED = ('flax', 'msgpack', 'imageio', 'cv2')


@pytest.mark.parametrize('module', ['train', 'exposure_jax.core.serving',
                                    'chip_smoke'])
def test_main_paths_import_without_optional_packages(module):
    # the machine with the card may lack these; training, serving and
    # the smoke test must not need them
    code = ('import sys\n'
            'for m in %r:\n'
            '    sys.modules[m] = None\n'
            'import %s\n'
            'import exposure_jax.core.trainer\n' % (_BLOCKED, module))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
