"""Durable serving artifacts: compact, git-committable policy exports.

Full train-state checkpoints (``models/<config>/<run>/model.ckpt-*``,
core/checkpoint.py) hold three parameter trees plus three Adam states
(~100 MB) and live OUTSIDE version control — a fresh checkout has no
trained policy, so everything downstream of a trained run (the serving
benchmark, evaluate.py demos) would silently regress to fresh-init
weights.  The reference ships its trained models as a git submodule for
exactly this reason (reference .gitmodules:1-3 pins a pretrained-models
repo).

A *serving artifact* is the minimal durable equivalent: the GENERATOR
parameters only, as a compressed ``.npz`` keyed by each leaf's path
(``params/shared_extractor/Conv_0/kernel``, core/checkpoint.py
``flatten_tree``) — ~22 MB at the default float32 (bit-exact restore),
~11 MB at float16 (which flips ~3% of near-tie argmax decisions), small
enough to track in git under ``artifacts/serving/``.  Critic/value/
optimizer states are deliberately dropped: artifacts restore INFERENCE,
not training resume (checkpoints remain the resume mechanism).

``restore_for_serving`` is the one entry point serving-side callers use:
it prefers a real checkpoint (exact f32 params) and falls back to the
artifact when the checkpoint directory is gone.
"""

import os

import jax
import numpy as np

from exposure_jax.core.checkpoint import flatten_tree, unflatten_like

ARTIFACT_ROOT = 'artifacts/serving'
_PARAMS = 'gen_params/'


def artifact_path(run, root=ARTIFACT_ROOT):
    """Canonical artifact location for ``<config>/<run>`` (the '/' is
    flattened so the artifact dir stays a single level)."""
    return os.path.join(root, run.replace('/', '--') + '.npz')


def export_serving_artifact(run, state, step, path=None,
                            dtype=np.float32):
    """Write the gen_params-only artifact for a trained state.

    Default float32: restores are bit-exact, so artifact-served
    decisions match checkpoint-served ones exactly.  float16 halves the
    size at the cost of flipping ~3% of near-tie argmax filter
    decisions (measured by tools/export_serving.py --verify)."""
    path = path or artifact_path(run)
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    dtype = np.dtype(dtype)
    arrays = {_PARAMS + k: v.astype(dtype)
              for k, v in flatten_tree(state.gen_params).items()}
    arrays.update(run=np.asarray(run), step=np.asarray(int(step)),
                  dtype=np.asarray(dtype.name))
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)
    return path


def restore_serving_artifact(path, template_state):
    """Restore gen_params from an artifact into ``template_state``.

    Returns (state-with-restored-gen-params, step).  Params come back
    as float32 (upcast if stored narrower) and device-committed — the
    same device-residency contract as restore_checkpoint.  A template
    whose gen_params tree differs from the artifact's raises ValueError.
    """
    with np.load(path) as data:
        step = int(data['step'])
        stored = {k[len(_PARAMS):]: data[k].astype(np.float32)
                  for k in data.files if k.startswith(_PARAMS)}
    gen = unflatten_like(template_state.gen_params, stored)
    state = template_state.replace(gen_params=jax.device_put(gen))
    return state, step


def restore_for_serving(run, template_state, model_root='models'):
    """Checkpoint if present, artifact otherwise.

    Returns (state, step, source) where source is 'checkpoint' or
    'artifact'; raises FileNotFoundError when neither exists.
    """
    from exposure_jax.core.checkpoint import (
        latest_checkpoint_step,
        restore_checkpoint,
    )
    ckpt_dir = os.path.join(model_root, run)
    if latest_checkpoint_step(ckpt_dir) is not None:
        state, step = restore_checkpoint(ckpt_dir, template_state)
        return state, step, 'checkpoint'
    path = artifact_path(run)
    if os.path.exists(path):
        state, step = restore_serving_artifact(path, template_state)
        return state, step, 'artifact'
    raise FileNotFoundError('no checkpoint under %s and no artifact at %s'
                            % (ckpt_dir, path))


def has_trained_params(run, model_root='models'):
    """True when either a checkpoint or a serving artifact exists."""
    from exposure_jax.core.checkpoint import latest_checkpoint_step
    return (latest_checkpoint_step(os.path.join(model_root, run))
            is not None) or os.path.exists(artifact_path(run))
