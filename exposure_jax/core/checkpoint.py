"""Checkpoint / resume.

The reference saves a tf Saver checkpoint every 500 iters (max_to_keep=1,
net.py:271-272, 380-384) and never resumes mid-run (restore only for
eval).  We exceed that: the FULL train state (three parameter trees, three
Adam states, EMA, step counter) is written as one ``.npz`` whose entries
are keyed by each leaf's path in the state tree (``flatten_tree``), so
training can resume exactly."""

import os
import re
import zipfile

import jax
import numpy as np

_CKPT_RE = re.compile(r'model\.ckpt-(\d+)\.npz$')


def _leaf_key(path):
    return jax.tree_util.keystr(path, simple=True, separator='/')


def flatten_tree(tree):
    """``{'gen_params/params/Dense_0/kernel': ndarray, ...}`` — every
    leaf of ``tree`` as a host array, keyed by its path."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_leaf_key(path): np.asarray(leaf) for path, leaf in leaves}


def unflatten_like(template, arrays):
    """Inverse of ``flatten_tree``: rebuild ``template``'s structure from
    ``arrays``.  Raises ValueError when the keys or a leaf's shape differ
    from the template's, so a tree mismatch fails here and not inside a
    jitted call."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    keys = [_leaf_key(path) for path, _ in leaves]
    if set(keys) != set(arrays):
        raise ValueError('tree mismatch: missing %s, unexpected %s' % (
            sorted(set(keys) - set(arrays))[:5],
            sorted(set(arrays) - set(keys))[:5]))
    out = []
    for key, (_, leaf) in zip(keys, leaves):
        arr = np.asarray(arrays[key])
        if arr.shape != np.shape(leaf):
            raise ValueError('leaf %s has shape %s, template %s'
                             % (key, arr.shape, np.shape(leaf)))
        out.append(arr)
    return jax.tree_util.tree_unflatten(treedef, out)


def _steps(directory):
    return [int(m.group(1)) for m in map(_CKPT_RE.match,
                                         os.listdir(directory)) if m]


def save_checkpoint(directory, state, step, keep=1):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, 'model.ckpt-%d.npz' % step)
    # crash safety: write to a temp file and atomically rename, so a kill
    # mid-write can never leave a truncated checkpoint in place (and only
    # then prune older ones).
    tmp = path + '.tmp'
    # sweep orphaned temp files from writes a previous process died
    # inside (the rename below never published them)
    for stale in os.listdir(directory):
        if stale.endswith('.npz.tmp') and stale != os.path.basename(tmp):
            try:
                os.remove(os.path.join(directory, stale))
            except OSError:
                pass
    with open(tmp, 'wb') as f:
        np.savez(f, **flatten_tree(state))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    for old in sorted(_steps(directory))[:-keep]:
        os.remove(os.path.join(directory, 'model.ckpt-%d.npz' % old))
    return path


def latest_checkpoint_step(directory):
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory, template_state, step=None):
    """Restore into the structure of ``template_state``; if the newest
    checkpoint is unreadable, fall back to older ones."""
    if step is not None:
        candidates = [step]
    else:
        candidates = sorted(_steps(directory), reverse=True)
        if not candidates:
            raise FileNotFoundError('no checkpoint in %s' % directory)
    last_err = None
    for s in candidates:
        path = os.path.join(directory, 'model.ckpt-%d.npz' % s)
        try:
            with np.load(path) as data:
                restored = unflatten_like(template_state, dict(data))
        except (ValueError, OSError, EOFError, zipfile.BadZipFile) as e:
            last_err = e
            print('# checkpoint %s unreadable (%s), trying older' %
                  (path, e))
            continue

        # COMMIT the restored tree to device: a jitted function
        # re-uploads host numpy arguments on EVERY call.  Each leaf
        # inherits the TEMPLATE leaf's sharding when it has one, so a
        # resume under a device mesh restores replicated-parameter arrays
        # replicated (not committed to device 0, which would force a
        # reshard — or a silent de-shard — on the first sharded step).
        # Exercised by __graft_entry__.dryrun_multichip.
        def _put(t, r):
            if isinstance(t, jax.Array):
                return jax.device_put(r, t.sharding)
            return jax.device_put(r)

        return jax.tree_util.tree_map(_put, template_state, restored), s
    raise last_err
