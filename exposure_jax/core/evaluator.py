"""Inference: retouch full-resolution photos with a trained policy.

Parity with reference ``GAN.eval`` (net.py:711-877), redesigned:

- reference: per step, one sess.run computing the policy AND the full-res
  filter math, with a host round trip between steps (net.py:796-821) and a
  per-resolution reuse graph (net.py:683-709).
- here: the K-step policy trajectory runs entirely on device on the 64x64
  proxy (one jitted lax.scan), producing packed (filter_id, params)
  records; the full-resolution image is then transformed by chain replay —
  the fused kernel that applies the whole chain in one pass over the
  image on the GPU, the jnp chain on the CPU
  (ops/pallas_chain.py ``select_chain_replay``).

Outputs per input file (matching the reference's artifact set,
net.py:822-877): .linear.png, .input_tone_mapped.png, .retouched.png,
optional .intermediateNN.png, .steps.png strip, and <fn>_debug.pkl with
the per-step decisions."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np

from exposure_jax.core.checkpoint import restore_checkpoint
from exposure_jax.core.rollout import rollout
from exposure_jax.core.trainer import build_models, init_train_state
from exposure_jax.ops.chain import apply_filter_step
from exposure_jax.ops.pallas_chain import select_chain_replay
from exposure_jax.utils.image_io import (
    get_image_center,
    linearize_prophoto_rgb,
    read_image,
    read_tiff16,
    write_image,
)
from exposure_jax.utils.ops import STATE_STOPPED_DIM


def load_linear_image(fn):
    """Read + linearize an input photo (reference net.py:730-747)."""
    if fn.endswith('.tif') or fn.endswith('.tiff'):
        image = read_tiff16(fn)
        return linearize_prophoto_rgb(image).astype(np.float32)
    image = read_image(fn)
    image = np.power(image, 2.2)          # linearize sRGB
    image /= 2 * image.max() + 1e-9       # mimic RAW exposure
    return image.astype(np.float32)


def downsample_to_proxy(image, size=64):
    """Center crop + resize to the policy proxy resolution
    (reference net.py:779)."""
    center = get_image_center(image)
    try:
        import cv2
        return cv2.resize(center, (size, size))
    except ImportError:
        return np.asarray(jax.image.resize(jnp.asarray(center),
                                           (size, size, 3), 'linear'))


class Evaluator:

    def __init__(self, cfg, model_root='models', ckpt=None, state=None):
        self.cfg = cfg
        self.dir = os.path.join(model_root, cfg.name)
        self.filters, self.policy, self.critic, self.value = build_models(cfg)
        if state is None:
            state, _ = init_train_state(cfg, self.policy, self.critic,
                                        self.value, cfg.get('seed', 0))
            if ckpt is not None:
                state, step = restore_checkpoint(self.dir, state, ckpt)
                src = 'checkpoint'
            else:
                # fall back to the git-tracked serving artifact when the
                # (untracked) checkpoint directory is gone — evaluation
                # only needs gen_params (core/artifacts.py)
                from exposure_jax.core.artifacts import restore_for_serving
                state, step, src = restore_for_serving(
                    cfg.name, state, model_root=model_root)
            print('# restored %s at step %d (%s)' % (self.dir, step, src))
        self.state = state
        self._rollout = jax.jit(
            lambda params, imgs, key: rollout(
                self.policy, params, imgs, key, cfg=cfg,
                filters=self.filters, is_train=0))
        self._replay = select_chain_replay()
        self._chain_cache = {}
        self._step_cache = {}

    # ------------------------------------------------------------------
    def _chain_fn(self, shape, dtype=jnp.float32):
        shape = (tuple(shape), jnp.dtype(dtype).name)
        if shape not in self._chain_cache:
            masking = self.cfg.masking
            replay = self._replay
            self._chain_cache[shape] = jax.jit(
                lambda img, ids, params, active, mask: replay(
                    img, ids, params, self.filters, active_steps=active,
                    mask_params=mask if masking else None))
        return self._chain_cache[shape]

    def _step_fn(self, shape):
        if shape not in self._step_cache:
            masking = self.cfg.masking
            self._step_cache[shape] = jax.jit(
                lambda img, fid, params, mask: apply_filter_step(
                    img, fid, params, self.filters,
                    mask_params=mask if masking else None))
        return self._step_cache[shape]

    # ------------------------------------------------------------------
    def plan_trajectory(self, low_res_batch, key=None):
        """Run the policy on [B, 64, 64, 3] proxies; returns the
        trajectory plus the number of applied steps per sample."""
        if key is None:
            key = jax.random.PRNGKey(0)
        traj = self._rollout(self.state.gen_params,
                             jnp.asarray(low_res_batch), key)
        stopped = np.asarray(traj.states[:, :, STATE_STOPPED_DIM])  # [K, B]
        k, b = stopped.shape
        applied = np.full((b,), k, np.int32)
        for i in range(b):
            nz = np.nonzero(stopped[:, i] > 0)[0]
            if len(nz):
                applied[i] = nz[0] + 1
        return traj, applied

    def active_mask(self, traj):
        """[K, B] 0/1 mask of steps to replay (stop after the first
        terminal state, reference net.py:820-821)."""
        stopped = np.asarray(traj.states[:, :, STATE_STOPPED_DIM]) > 0
        k, b = stopped.shape
        active = np.ones((k, b), np.float32)
        for i in range(1, k):
            active[i] = active[i - 1] * (~stopped[i - 1])
        return jnp.asarray(active)

    def retouch(self, high_res_batch, traj):
        """Replay the trajectory on [B, H, W, 3] at full resolution."""
        high = jnp.asarray(high_res_batch)
        fn = self._chain_fn(high.shape)
        return np.asarray(fn(high, traj.filter_ids, traj.params,
                             self.active_mask(traj), traj.mask_params))

    # ------------------------------------------------------------------
    def eval_batched(self, spec_files, output_dir='./outputs', seed=0,
                     show_linear=True, show_input=True, u8=False):
        """Batch-process inputs grouped by resolution: ONE rollout call
        for all proxies and one fused chain replay per resolution group.
        (The reference flags this as an unimplemented TODO,
        evaluate.py:15-18.)

        ``u8=True`` replays in uint8 fixed point (4x less memory
        traffic; filter math stays f32).  The linearized input is
        quantized to 8 bits first, so deep-shadow precision below 1/255
        is traded for speed — within 1 u8 LSB of the f32 path on its own
        quantization grid (tests/test_pallas_chain.py)."""
        os.makedirs(output_dir, exist_ok=True)
        images = [load_linear_image(fn) for fn in spec_files]
        proxies = np.stack([
            downsample_to_proxy(im, self.cfg.source_img_size)
            for im in images])
        traj, applied = self.plan_trajectory(proxies,
                                             jax.random.PRNGKey(seed))
        active = self.active_mask(traj)
        results = []
        by_res = {}
        for i, im in enumerate(images):
            by_res.setdefault(im.shape, []).append(i)
        for shape, idxs in by_res.items():
            stacked = np.stack([images[i] for i in idxs])
            if u8:
                stacked = (np.clip(stacked, 0, 1) * 255.0 +
                           0.5).astype(np.uint8)
            batch = jnp.asarray(stacked)
            sub_traj = traj._replace(
                filter_ids=traj.filter_ids[:, np.asarray(idxs)],
                params=traj.params[:, np.asarray(idxs)],
                mask_params=traj.mask_params[:, np.asarray(idxs)])
            fn = self._chain_fn(batch.shape, batch.dtype)
            outs = np.asarray(fn(batch, sub_traj.filter_ids,
                                 sub_traj.params,
                                 active[:, np.asarray(idxs)],
                                 sub_traj.mask_params))
            if u8:
                outs = outs.astype(np.float32) / 255.0
            for j, i in enumerate(idxs):
                base = os.path.basename(spec_files[i])
                if show_linear:
                    write_image(os.path.join(
                        output_dir, base + '.linear.png'),
                        np.clip(images[i], 0, 1))
                if show_input:
                    tone = (images[i] / images[i].max()) ** (1 / 2.4)
                    write_image(os.path.join(
                        output_dir, base + '.input_tone_mapped.png'),
                        np.clip(tone, 0, 1))
                write_image(os.path.join(
                    output_dir, base + '.retouched.png'),
                    np.clip(outs[j], 0, 1))
                results.append({'file': spec_files[i],
                                'retouched': outs[j],
                                'steps_applied': int(applied[i])})
        return results

    def eval(self, spec_files, output_dir='./outputs', step_by_step=False,
             show_linear=True, show_input=True, seed=0):
        os.makedirs(output_dir, exist_ok=True)
        results = []
        for fn in spec_files:
            print('Processing input {}'.format(fn))
            high_res = load_linear_image(fn)
            low_res = downsample_to_proxy(high_res,
                                          self.cfg.source_img_size)
            traj, applied = self.plan_trajectory(
                low_res[None], jax.random.PRNGKey(seed))
            base = os.path.basename(fn)

            def save(tag, img):
                write_image(os.path.join(output_dir,
                                         base + '.' + tag + '.png'),
                            np.clip(img, 0, 1))

            if step_by_step:
                img = jnp.asarray(high_res[None])
                step_f = self._step_fn(img.shape)
                active = np.asarray(self.active_mask(traj))
                for i in range(int(applied[0])):
                    img = step_f(img, traj.filter_ids[i], traj.params[i],
                                 traj.mask_params[i])
                    if i < int(applied[0]) - 1:
                        save('intermediate%02d' % i, np.asarray(img[0]))
                    if self.cfg.get('vis_step_test', False):
                        # live per-step window (reference net.py:815-818
                        # step visualization); headless-safe
                        from exposure_jax.core.trainer import _show_realtime
                        _show_realtime(np.asarray(img[0]),
                                       'step %d: %s' % (i, base))
                retouched = np.asarray(img[0])
            else:
                retouched = self.retouch(high_res[None], traj)[0]

            if show_linear:
                save('linear', high_res)
            if show_input:
                tone_mapped = (high_res / high_res.max()) ** (1 / 2.4)
                save('input_tone_mapped', tone_mapped)
            save('retouched', retouched)

            # per-step debug dump (reference net.py:841-843)
            debug = []
            for i in range(traj.filter_ids.shape[0]):
                fid = int(traj.filter_ids[i, 0])
                f = self.filters[fid]
                n = f.get_num_filter_parameters()
                debug.append({
                    'step': i,
                    'filter_id': fid,
                    'short_name': f.get_short_name(),
                    'all_short_names': [x.get_short_name()
                                        for x in self.filters],
                    'filter_parameters':
                        np.asarray(traj.params[i, 0, :n]),
                    'mask_parameters': np.asarray(
                        traj.mask_params[i, 0,
                                         :f.get_num_mask_parameters()]),
                    'pdf': np.asarray(traj.pdfs[i, 0]),
                    'applied': i < int(applied[0]),
                })
            with open(os.path.join(output_dir, base + '_debug.pkl'),
                      'wb') as f:
                pickle.dump(debug, f)

            # steps figure: row 0 = input proxy + per-step low-res
            # outputs; row 1 = decision (pdf) panels; row 2 = operation
            # panels; with masking on, row 3 = per-step spatial masks
            # (reference net.py:845-877 layout + filters.py:150-167)
            from exposure_jax.utils.viz import (
                draw_mask_panel,
                draw_step_panels,
            )
            blank = np.ones_like(low_res)
            n_applied = int(applied[0])
            row_imgs = [low_res] + [np.asarray(traj.images[i, 0])
                                    for i in range(n_applied)]
            row_dec, row_op = [blank], [blank]
            row_mask = [blank] if self.cfg.masking else None
            for i in range(n_applied):
                dec, op = draw_step_panels(self.filters, debug[i],
                                           size=low_res.shape[0])
                row_dec.append(dec)
                row_op.append(op)
                if row_mask is not None:
                    step_input = low_res if i == 0 \
                        else np.asarray(traj.images[i - 1, 0])
                    row_mask.append(draw_mask_panel(
                        self.filters[debug[i]['filter_id']], step_input,
                        debug[i]['mask_parameters']))

            def hpad(row):
                return np.hstack([np.pad(r, ((1, 1), (1, 1), (0, 0)),
                                         constant_values=1.0) for r in row])
            strip_rows = [hpad(row_imgs), hpad(row_dec), hpad(row_op)]
            if row_mask is not None:
                strip_rows.append(hpad(row_mask))
            save('steps', np.vstack(strip_rows))
            results.append({'file': fn, 'retouched': retouched,
                            'debug': debug})
        return results
