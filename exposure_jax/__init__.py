"""exposure_jax: a JAX (XLA/Pallas) white-box photo post-processing
framework with the capabilities of yuanming-hu/exposure (SIGGRAPH 2018).

Subpackages
-----------
- ``exposure_jax.ops``      differentiable filter bank, categorical sampling,
  the fused Pallas filter-chain replay kernel.
- ``exposure_jax.models``   policy (agent), critic and value networks.
- ``exposure_jax.core``     losses, device-resident replay pool, train state,
  trainer, evaluator, serving, checkpointing.
- ``exposure_jax.data``     MIT-Adobe FiveK / artist / folder data providers.
- ``exposure_jax.parallel`` mesh + sharding helpers (data parallelism).
- ``exposure_jax.utils``    config Dict, color science, image IO, logging.
"""

import os as _os

import jax as _jax

__version__ = "0.1.0"

CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ):
    """Where this package puts JAX's persistent compilation cache: None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads the
    variable itself), otherwise ``<checkout>/.jax_cache`` — a fixed
    path, since the path is part of the cache's key."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(CHECKOUT, ".jax_cache")


# The big jitted programs (the fused outer train step, the serving
# program) compile once per machine instead of once per process.
if compile_cache_dir(_os.environ) is not None:
    _jax.config.update("jax_compilation_cache_dir",
                       compile_cache_dir(_os.environ))
