"""Config loading: "config is Python".

Parity with the reference (util.py:326-329): a config is a Python module
defining a module-level ``cfg`` attribute-Dict whose knobs carry the same
names as the reference's ``config_example.py``.  ``load_config('example')``
resolves, in order:

1. ``config_<name>.py`` in the current directory (reference behavior —
   this is what makes ``evaluate.py``'s config-snapshot reload work),
2. ``configs/config_<name>.py`` under the current directory,
3. ``configs/config_<name>.py`` shipped with the repo.
"""

import importlib.util
import os
import sys

_REPO_CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), 'configs')


def load_config_file(path):
    spec = importlib.util.spec_from_file_location(
        'exposure_jax_config_' + os.path.basename(path).replace('.', '_'),
        path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module.cfg


def load_config(config_name):
    candidates = [
        os.path.join(os.getcwd(), 'config_%s.py' % config_name),
        os.path.join(os.getcwd(), 'configs', 'config_%s.py' % config_name),
        os.path.join(_REPO_CONFIGS, 'config_%s.py' % config_name),
    ]
    for path in candidates:
        if os.path.exists(path):
            return load_config_file(path)
    raise FileNotFoundError(
        'config_%s.py not found in: %s' % (config_name, candidates))
