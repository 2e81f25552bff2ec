"""Serving: a one-object batch retouching pipeline.

The production-facing API the reference never had: load a trained run
once, then ``pipeline(images)`` retouches batches at any (fixed)
resolution.  Each batch is ONE jitted program: proxy downsample, the
K-step policy plan on the 64x64 proxy (``core/rollout.py``
``serve_rollout``, which advances the proxy through the selected filter
only), and the chain replay on the full-resolution images — with the
filter ids never leaving the device.  Accepts uint8 (standard 8-bit
images; 4x less memory traffic than float32) or float32 in the linear
[0, 1] domain.

The replay is chosen by platform (``ops/pallas_chain.py``
``select_chain_replay``): the fused Pallas kernel, compiled through
Triton, on the GPU; the jnp chain on the CPU; any other platform raises.

Options:
- ``bf16=True`` runs the policy plan in bfloat16 (filter replay
  parameters are cast back to f32 so the full-resolution math is
  unchanged).  Serving uses argmax selection, which is robust to the
  reduced pdf precision.
- masking configs are supported: recorded mask parameters ride along and
  the kernel evaluates the spatial masks in-kernel.

>>> pipe = RetouchPipeline.from_run(cfg)          # or (cfg, state)
>>> out_u8 = pipe(np.stack(imgs_u8))              # [B, H, W, 3] uint8
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from exposure_jax.core.checkpoint import restore_checkpoint
from exposure_jax.core.rollout import serve_rollout
from exposure_jax.core.trainer import build_models, init_train_state
from exposure_jax.ops.pallas_chain import select_chain_replay


class RetouchPipeline:

    def __init__(self, cfg, state, bf16=False):
        self.cfg = cfg
        self.filters, self.policy, _, _ = build_models(cfg)
        self.state = state
        self.bf16 = bf16
        # the platform's chain replay; callers may replace it before the
        # first batch (bench.py --no-pallas, interpret-mode tests)
        self.replay = select_chain_replay()
        self._fns = {}

    @classmethod
    def from_run(cls, cfg, model_root='models', ckpt=None, **kwargs):
        filters, policy, critic, value = build_models(cfg)
        state, _ = init_train_state(cfg, policy, critic, value,
                                    cfg.get('seed', 0))
        if ckpt is not None:
            state, step = restore_checkpoint(
                os.path.join(model_root, cfg.name), state, ckpt)
        else:
            # checkpoint when present, git-tracked serving artifact
            # otherwise (core/artifacts.py) — fresh checkouts keep
            # trained serving without the ~100 MB untracked checkpoints
            from exposure_jax.core.artifacts import restore_for_serving
            state, step, _ = restore_for_serving(
                cfg.name, state, model_root=model_root)
        return cls(cfg, state, **kwargs)

    def program(self, shape, dtype):
        """The per-batch program, not jitted: ``fn(gen_params, images,
        key, idx) -> (out, (ids, params, mask_params))`` for a
        [B, H, W, 3] batch of ``shape`` and ``dtype``.  ``idx`` is folded
        into ``key`` inside the program.  ``jax.shard_map`` it to serve
        one batch across devices."""
        cfg = self.cfg
        quantized = dtype == jnp.uint8
        masking = bool(cfg.masking)

        def fn(gen_params, images, key, idx):
            key = jax.random.fold_in(key, idx)
            proxy_src = images.astype(jnp.float32) * (1.0 / 255.0) \
                if quantized else images
            proxy = jax.image.resize(
                proxy_src,
                (images.shape[0], cfg.source_img_size, cfg.source_img_size,
                 3), method='linear')
            if self.bf16:
                proxy = proxy.astype(jnp.bfloat16)
                gen_params = jax.tree_util.tree_map(
                    lambda x: x.astype(jnp.bfloat16), gen_params)
            ids, params, mask = serve_rollout(
                self.policy, gen_params, proxy, key, cfg=cfg,
                filters=self.filters, replay=self.replay)
            params = params.astype(jnp.float32)
            mask = mask.astype(jnp.float32)
            out = self.replay(images, ids, params, self.filters,
                              mask_params=mask if masking else None)
            return out, (ids, params, mask)

        return fn

    def plan_and_replay(self, images, seed=0, idx=0):
        """Run one batch; returns the device arrays ``(out, (ids,
        params, mask_params))`` — the retouched batch and the plan it
        replayed."""
        images = jnp.asarray(images)
        sig = (images.shape, images.dtype)
        if sig not in self._fns:
            self._fns[sig] = jax.jit(self.program(*sig))
        return self._fns[sig](self.state.gen_params, images,
                              jax.random.PRNGKey(seed), idx)

    def __call__(self, images, seed=0, device_out=False):
        """Retouch a [B, H, W, 3] batch (uint8 or float32 linear).

        ``device_out=True`` returns the device array without the host
        fetch (the caller controls when and what to transfer)."""
        out, _ = self.plan_and_replay(images, seed)
        return out if device_out else np.asarray(out)

    def map_batches(self, batches, seed=0, device_out=False):
        """Retouch a stream of equally-shaped batches.

        Each batch is one asynchronous dispatch with no host sync, so
        the device queue is the pipeline; batch ``i`` uses the base key
        of ``seed`` folded with ``i``.  Yields results in order;
        ``device_out=True`` yields device arrays.

        >>> for out in pipe.map_batches(batch_iter()): ...
        """
        for i, imgs in enumerate(batches):
            out, _ = self.plan_and_replay(imgs, seed, idx=i)
            yield out if device_out else np.asarray(out)
