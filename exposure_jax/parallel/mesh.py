"""Device mesh + sharding helpers.

The reference has no distributed story at all (one process, one GPU,
net.py:21-24; SURVEY.md §2/§5).  The replacement is a 1-D
``jax.sharding.Mesh`` over every visible device with pure data
parallelism — the only strategy this workload (10^7-parameter CNNs,
64x64 images) needs, and a 1-D mesh because the cards of one host reach
each other all to all:

- replay pool, dataset packs and every batch axis are sharded over the
  ``data`` axis (each device runs an independent slice of the replay
  cycle);
- parameters and optimizer state are replicated;
- gradient/metric reduction is an explicit ``lax.pmean`` inside
  ``shard_map`` (an all-reduce that XLA hands to NCCL on GPUs).

TP/PP/EP/CP have no counterpart in this workload and are explicitly out
of scope (documented parity statement, SURVEY.md §5)."""

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = 'data'


def data_parallel_mesh(num_devices=None, devices=None):
    """Build a 1-D data-parallel mesh over the first ``num_devices``."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def local_batch_size(global_batch, mesh):
    n = mesh.shape[DATA_AXIS]
    assert global_batch % n == 0, (
        'global batch %d not divisible by %d devices' % (global_batch, n))
    return global_batch // n
