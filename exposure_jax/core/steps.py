"""Jitted, sharded train steps: the entire outer iteration on device.

The reference runs, per outer iteration, one generator+value ``sess.run``
plus ``citers`` critic ``sess.run``s, each with a host-built feed dict
(net.py:307-364) — 6+ host<->device round trips per iteration.  Here one
``outer_step`` call executes a whole phase (giters generator/value
updates, then citers critic WGAN-GP updates, ``lax.scan``-ed on device)
inside a single jitted ``shard_map`` over the data-parallel mesh:

- dataset packs and the replay pool are sharded over devices (each device
  runs an independent slice of the replay cycle, statistically equivalent
  to n smaller pools);
- parameters/optimizer state are replicated; gradients and scalar metrics
  are ``lax.pmean``-ed across devices;
- per-device randomness comes from folding the axis index into the key.

Two data paths:

- **device-resident** (default): the full dataset packs live in HBM and
  fresh crops are sampled inside the step (data/device_sampler.py) —
  zero host traffic in the hot loop.
- **streaming** (``build_streaming_outer_step``): fresh crops arrive as
  per-call arguments assembled on the host (e.g. by the native
  hostloader, exposure_jax/native) — for packs too large for HBM.

The iteration schedule knobs (citers bursts at initialization and every
500 iters; the iter-0 warmup at lr 0 that only populates the pool with
terminated records, net.py:312-328) are composed by the Trainer from a
generator-phase program and a critic-phase program.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from exposure_jax.core.losses import critic_loss, generator_value_loss
from exposure_jax.core.replay import (
    reinsert,
    sample_terminated,
    select_generator_batch,
)
from exposure_jax.core.train_state import apply_lr_update, clip_tree
from exposure_jax.data.device_sampler import (
    DevicePack,
    channels_to_paired,
    sample_batch,
)
from exposure_jax.parallel.mesh import DATA_AXIS

pmean = functools.partial(jax.lax.pmean, axis_name=DATA_AXIS)


class StepMetrics(NamedTuple):
    g_loss: jnp.ndarray
    v_loss: jnp.ndarray
    emd: jnp.ndarray
    critic_gradient_norm: jnp.ndarray
    reward: jnp.ndarray
    pool_avg_trajectory: jnp.ndarray
    pool_terminated_frac: jnp.ndarray


def _make_phase_bodies(cfg, policy, critic_mod, value_mod, filters, tx,
                       local_batch):
    """Shared generator-phase / critic-phase update cores."""

    def g_update(st, pl, fresh_triplet, keys, lr_g, progress):
        (fresh_batch, fresh_gt), (fresh2, fresh2_gt), \
            (fresh_pool, fresh_pool_gt) = fresh_triplet
        k_sel, k_step, k_keep = keys
        sel_idx, b_img, b_states, dropped, b_gt = \
            select_generator_batch(pl, k_sel, local_batch, fresh_batch,
                                   fresh_gt)

        params = {'gen': st.gen_params, 'val': st.val_params}
        (_, aux), grads = jax.value_and_grad(
            generator_value_loss, has_aux=True)(
                params, st.crit_params, policy, critic_mod, value_mod,
                b_img, b_states, k_step, jnp.int32(1), progress, cfg,
                filters, ground_truth=b_gt)
        grads = pmean(grads)
        g_loss = pmean(aux.g_loss)
        v_loss = pmean(aux.v_loss)
        reward = pmean(jnp.mean(aux.reward))

        gen_params, opt_g = apply_lr_update(
            tx, grads['gen'], st.opt_g, st.gen_params, lr_g)
        val_params, opt_v = apply_lr_update(
            tx, grads['val'], st.opt_v, st.val_params,
            lr_g * cfg.value_lr_mul)
        st = st.replace(gen_params=gen_params, val_params=val_params,
                        opt_g=opt_g, opt_v=opt_v)

        pl = reinsert(pl, k_keep, sel_idx, aux.new_images,
                      aux.new_states, dropped, fresh2, fresh_pool,
                      cfg.maximum_trajectory_length,
                      cfg.over_length_keep_prob,
                      batch_gt=b_gt, fresh_gt_for_batch=fresh2_gt,
                      fresh_gt_for_pool=fresh_pool_gt)
        return st, pl, (g_loss, v_loss, reward)

    def c_update(st, pool, real_batch, keys, lr_c):
        k_fake, k_gp = keys
        fake_batch, _ = sample_terminated(pool, k_fake, local_batch)
        (_, aux), grads = jax.value_and_grad(
            critic_loss, has_aux=True)(
                st.crit_params, critic_mod, real_batch, fake_batch,
                k_gp, cfg)
        grads = pmean(grads)
        emd = pmean(aux.emd)
        cgn = pmean(aux.critic_gradient_norm)
        c_avg = pmean(aux.c_average)
        crit_params, opt_c = apply_lr_update(
            tx, grads, st.opt_c, st.crit_params, lr_c)
        if cfg.gan == 'w' and cfg.gradient_penalty_lambda <= 0:
            # weight-clipping fallback when GP is off (net.py:253-266)
            crit_params = clip_tree(crit_params, cfg.clamp_critic)
        st = st.replace(crit_params=crit_params, opt_c=opt_c,
                        ema=st.ema.update(c_avg))
        return st, (emd, cgn)

    return g_update, c_update


def _finalize(state, pool, g_outs, c_outs, citers):
    g_losses, v_losses, rewards = g_outs
    if citers > 0:
        emds, cgns = c_outs
        emd = jnp.mean(emds)
        cgn = cgns[-1]
    else:
        emd = jnp.zeros(())
        cgn = jnp.zeros(())
    # NOTE: state.step is the OUTER iteration counter and is advanced by
    # the Trainer once per iteration (an iteration may be composed of
    # several compiled calls).
    terminated_frac = pmean(jnp.mean(
        pool.terminated_mask().astype(jnp.float32)))
    avg_traj = pmean(pool.average_trajectory())
    metrics = StepMetrics(
        g_loss=jnp.mean(g_losses),
        v_loss=jnp.mean(v_losses),
        emd=emd,
        critic_gradient_norm=cgn,
        reward=jnp.mean(rewards),
        pool_avg_trajectory=avg_traj,
        pool_terminated_frac=terminated_frac,
    )
    return state, pool, metrics


def _check_divisibility(cfg, mesh):
    n_dev = mesh.shape[DATA_AXIS]
    assert cfg.batch_size % n_dev == 0, (cfg.batch_size, n_dev)
    assert cfg.replay_memory_size % n_dev == 0
    return n_dev


def build_outer_step(cfg, policy, critic_mod, value_mod, filters, tx, mesh,
                     fake_meta, real_meta, giters, citers):
    """Compile the device-resident train step for fixed (giters, citers).

    Args:
      fake_meta/real_meta: (output_size, augment) static sampling metadata
        of the dataset packs (their image arrays are passed at call time,
        sharded over the mesh).
    """
    n_dev = _check_divisibility(cfg, mesh)
    local_batch = cfg.batch_size // n_dev
    supervised = bool(cfg.get('supervised', False))
    if supervised:
        assert citers == 0, 'supervised mode has no critic updates'

    fake_size, fake_augment = fake_meta
    real_size, real_augment = real_meta
    img_channels = cfg.get('real_img_channels', 3)
    g_update, c_update = _make_phase_bodies(
        cfg, policy, critic_mod, value_mod, filters, tx, local_batch)

    def sharded_step(state, pool, fake_images, real_images, key, lr_g, lr_c,
                     progress):
        axis = jax.lax.axis_index(DATA_AXIS)
        key = jax.random.fold_in(key, axis)
        local_pool = pool.size

        def sample_fake(k, n):
            """Fresh RAW sample; in supervised mode the pack carries
            (input, gt) pairs as stacked channels — returns (img, gt)."""
            batch = sample_batch(
                DevicePack(fake_images, fake_size, fake_augment), k, n)
            if supervised:
                return channels_to_paired(batch, img_channels)
            return batch, None

        def g_body(carry, k):
            st, pl = carry
            k_sel, k_f1, k_f2, k_f3, k_step, k_keep = jax.random.split(k, 6)
            triplet = (sample_fake(k_f1, local_batch),
                       sample_fake(k_f2, local_batch),
                       sample_fake(k_f3, local_pool))
            st, pl, outs = g_update(st, pl, triplet,
                                    (k_sel, k_step, k_keep), lr_g,
                                    progress)
            return (st, pl), outs

        g_keys = jax.random.split(jax.random.fold_in(key, 1), giters)
        (state, pool), g_outs = jax.lax.scan(g_body, (state, pool), g_keys)

        def c_body(st, k):
            k_real, k_fake, k_gp = jax.random.split(k, 3)
            real_batch = sample_batch(
                DevicePack(real_images, real_size, real_augment), k_real,
                local_batch)
            return c_update(st, pool, real_batch, (k_fake, k_gp), lr_c)

        c_outs = None
        if citers > 0:
            c_keys = jax.random.split(jax.random.fold_in(key, 2), citers)
            state, c_outs = jax.lax.scan(c_body, state, c_keys)

        return _finalize(state, pool, g_outs, c_outs, citers)

    mapped = jax.shard_map(
        sharded_step,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(), P(),
                  P(), P()),
        out_specs=(P(), P(DATA_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def build_fused_iterations_step(cfg, policy, critic_mod, value_mod,
                                filters, tx, mesh, fake_meta, real_meta,
                                giters, citers, n_iters):
    """Compile N plain outer iterations into ONE dispatch.

    Per-dispatch host latency matters when the device-side iteration is
    ~ms; `lax.scan`-ing the whole iteration amortizes it N-fold.

    RNG parity: each scanned iteration folds keys exactly like the
    Trainer's per-iteration dispatch pair — g-phase key
    ``fold_in(fold_in(base, it), 0)``, c-phase key
    ``fold_in(fold_in(base, it), 1)``, each axis-folded inside the
    shard — so a fused chunk is BIT-IDENTICAL to the same iterations
    dispatched one by one (tests/test_train_step.py::
    test_fused_iterations_match_sequential).

    Call signature:
      step(state, pool, fake_images, real_images, base_key,
           iter_idx [N] int32, lr_gs [N], lr_cs [N], progresses [N])
    Returns (state, pool, metrics) where every StepMetrics field is
    stacked per iteration (shape [N]) — one device->host fetch yields
    the full logging cadence for the whole chunk, so chunks can span
    many logging boundaries without losing observability.
    """
    n_dev = _check_divisibility(cfg, mesh)
    local_batch = cfg.batch_size // n_dev
    supervised = bool(cfg.get('supervised', False))
    if supervised:
        assert citers == 0, 'supervised mode has no critic updates'
    fake_size, fake_augment = fake_meta
    real_size, real_augment = real_meta
    img_channels = cfg.get('real_img_channels', 3)
    g_update, c_update = _make_phase_bodies(
        cfg, policy, critic_mod, value_mod, filters, tx, local_batch)

    def sharded_step(state, pool, fake_images, real_images, base_key,
                     iter_idx, lr_gs, lr_cs, progresses):
        axis = jax.lax.axis_index(DATA_AXIS)
        local_pool = pool.size

        def sample_fake(k, n):
            batch = sample_batch(
                DevicePack(fake_images, fake_size, fake_augment), k, n)
            if supervised:
                return channels_to_paired(batch, img_channels)
            return batch, None

        def one_iteration(st, pl, it, lr_g, lr_c, progress):
            it_key = jax.random.fold_in(base_key, it)
            # --- g phase: identical folding to a (giters, 0) dispatch
            gk = jax.random.fold_in(jax.random.fold_in(it_key, 0), axis)

            def g_body(carry, k):
                st_, pl_ = carry
                k_sel, k_f1, k_f2, k_f3, k_step, k_keep = \
                    jax.random.split(k, 6)
                triplet = (sample_fake(k_f1, local_batch),
                           sample_fake(k_f2, local_batch),
                           sample_fake(k_f3, local_pool))
                st_, pl_, outs = g_update(st_, pl_, triplet,
                                          (k_sel, k_step, k_keep), lr_g,
                                          progress)
                return (st_, pl_), outs

            g_keys = jax.random.split(jax.random.fold_in(gk, 1), giters)
            (st, pl), g_outs = jax.lax.scan(g_body, (st, pl), g_keys)

            c_outs = None
            if citers > 0:
                # --- c phase: identical folding to a (0, citers) dispatch
                ck = jax.random.fold_in(
                    jax.random.fold_in(it_key, 1), axis)

                def c_body(st_, k):
                    k_real, k_fake, k_gp = jax.random.split(k, 3)
                    real_b = sample_batch(
                        DevicePack(real_images, real_size, real_augment),
                        k_real, local_batch)
                    return c_update(st_, pl, real_b, (k_fake, k_gp), lr_c)

                c_keys = jax.random.split(jax.random.fold_in(ck, 2),
                                          citers)
                st, c_outs = jax.lax.scan(c_body, st, c_keys)
            return _finalize(st, pl, g_outs, c_outs, citers)

        def body(carry, xs):
            st, pl = carry
            it, lr_g, lr_c, prog = xs
            st, pl, metrics = one_iteration(st, pl, it, lr_g, lr_c, prog)
            return (st, pl), metrics

        (state, pool), all_metrics = jax.lax.scan(
            body, (state, pool), (iter_idx, lr_gs, lr_cs, progresses))
        return state, pool, all_metrics

    mapped = jax.shard_map(
        sharded_step,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(), P(),
                  P(), P(), P()),
        out_specs=(P(), P(DATA_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def _dequant_stream(x):
    """Dequantize a uint8 streaming bundle inside the jit (u8 bundles
    cut the host->device upload 4x — the binding resource for streaming
    training; native loader quantizes round(clamp(v,0,1)*255) at
    assembly, hostloader.cpp hl_sample_crops_u8).  float32 bundles pass
    through untouched, so the same builder serves both dtypes (jit
    specializes per input dtype)."""
    if x.dtype == jnp.uint8:
        return x.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    return x


def build_streaming_fused_step(cfg, policy, critic_mod, value_mod, filters,
                               tx, mesh, giters, citers, n_iters):
    """Compile N streaming outer iterations into ONE dispatch.

    The streaming path (fresh host data per call) previously dispatched
    every outer iteration separately — paying the per-dispatch host
    latency the device-resident path already amortizes via
    ``build_fused_iterations_step``.  This builder scans N iterations
    over a stacked data bundle instead.

    RNG parity: each scanned iteration folds keys exactly like the
    Trainer's per-iteration streaming dispatch pair — the g-phase
    dispatch key is ``fold_in(fold_in(base, it), 0)`` and the c-phase
    key ``fold_in(fold_in(base, it), 1)`` (trainer.py ``run()``), each
    axis-folded and sub-folded inside the shard exactly like
    ``build_streaming_outer_step`` — so a fused chunk is BIT-IDENTICAL
    to the same iterations dispatched one by one on the same data
    (tests/test_train_step.py::test_streaming_fused_match_sequential).

    Call signature:
      step(state, pool, g_fresh [N, giters, 2B+P, S, S, C],
           real_batches [N, citers, B, S, S, C], base_key,
           iter_idx [N] int32, lr_gs [N], lr_cs [N], progresses [N])
    Returns (state, pool, metrics) with every StepMetrics field stacked
    per iteration (shape [N]).
    """
    n_dev = _check_divisibility(cfg, mesh)
    local_batch = cfg.batch_size // n_dev
    supervised = bool(cfg.get('supervised', False))
    if supervised:
        assert citers == 0, 'supervised mode has no critic updates'
    img_channels = cfg.get('real_img_channels', 3)
    g_update, c_update = _make_phase_bodies(
        cfg, policy, critic_mod, value_mod, filters, tx, local_batch)

    def sharded_step(state, pool, g_fresh, real_batches, base_key,
                     iter_idx, lr_gs, lr_cs, progresses):
        g_fresh = _dequant_stream(g_fresh)
        real_batches = _dequant_stream(real_batches)
        axis = jax.lax.axis_index(DATA_AXIS)
        local_pool = pool.size
        b = local_batch

        def pair(x):
            if supervised:
                return x[..., :img_channels], x[..., img_channels:]
            return x, None

        def one_iteration(st, pl, it, g_data, c_data, lr_g, lr_c,
                          progress):
            it_key = jax.random.fold_in(base_key, it)
            # --- g phase: identical folding to a streaming (giters, 0)
            # dispatch with key fold_in(it_key, 0)
            gk = jax.random.fold_in(jax.random.fold_in(it_key, 0), axis)

            def g_body(carry, xs):
                st_, pl_ = carry
                k, fresh = xs
                k_sel, k_step, k_keep = jax.random.split(k, 3)
                triplet = (pair(fresh[:b]), pair(fresh[b:2 * b]),
                           pair(fresh[2 * b:2 * b + local_pool]))
                st_, pl_, outs = g_update(st_, pl_, triplet,
                                          (k_sel, k_step, k_keep), lr_g,
                                          progress)
                return (st_, pl_), outs

            g_keys = jax.random.split(jax.random.fold_in(gk, 1), giters)
            (st, pl), g_outs = jax.lax.scan(g_body, (st, pl),
                                            (g_keys, g_data))

            c_outs = None
            if citers > 0:
                # --- c phase: identical to a streaming (0, citers)
                # dispatch with key fold_in(it_key, 1)
                ck = jax.random.fold_in(
                    jax.random.fold_in(it_key, 1), axis)

                def c_body(st_, xs):
                    k, real_b = xs
                    k_fake, k_gp = jax.random.split(k, 2)
                    return c_update(st_, pl, real_b, (k_fake, k_gp),
                                    lr_c)

                c_keys = jax.random.split(jax.random.fold_in(ck, 2),
                                          citers)
                st, c_outs = jax.lax.scan(c_body, st, (c_keys, c_data))
            return _finalize(st, pl, g_outs, c_outs, citers)

        def body(carry, xs):
            st, pl = carry
            it, g_data, c_data, lr_g, lr_c, prog = xs
            st, pl, metrics = one_iteration(st, pl, it, g_data, c_data,
                                            lr_g, lr_c, prog)
            return (st, pl), metrics

        (state, pool), all_metrics = jax.lax.scan(
            body, (state, pool),
            (iter_idx, g_fresh, real_batches, lr_gs, lr_cs, progresses))
        return state, pool, all_metrics

    mapped = jax.shard_map(
        sharded_step,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(None, None, DATA_AXIS),
                  P(None, None, DATA_AXIS), P(), P(), P(), P(), P()),
        out_specs=(P(), P(DATA_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(mapped)


def build_streaming_outer_step(cfg, policy, critic_mod, value_mod, filters,
                               tx, mesh, giters, citers):
    """Compile the streaming train step: fresh data arrives per call.

    Call signature of the returned function:
      step(state, pool, g_fresh, real_batches, key, lr_g, lr_c, progress)
    where
      g_fresh:      [giters, 2*batch + pool, S, S, C] fresh RAW crops
                    (per g-iter: batch for selection backfill, batch for
                    over-length replacement, pool for dropped slots); in
                    supervised mode the last C channels carry the paired
                    ground truth ([..., 2C] channel-stacked);
      real_batches: [citers, batch, S, S, C] target crops.
    """
    n_dev = _check_divisibility(cfg, mesh)
    local_batch = cfg.batch_size // n_dev
    supervised = bool(cfg.get('supervised', False))
    if supervised:
        assert citers == 0, 'supervised mode has no critic updates'
    img_channels = cfg.get('real_img_channels', 3)
    g_update, c_update = _make_phase_bodies(
        cfg, policy, critic_mod, value_mod, filters, tx, local_batch)

    def sharded_step(state, pool, g_fresh, real_batches, key, lr_g, lr_c,
                     progress):
        g_fresh = _dequant_stream(g_fresh)
        real_batches = _dequant_stream(real_batches)
        axis = jax.lax.axis_index(DATA_AXIS)
        key = jax.random.fold_in(key, axis)
        local_pool = pool.size
        b = local_batch

        def pair(x):
            if supervised:
                return x[..., :img_channels], x[..., img_channels:]
            return x, None

        def g_body(carry, xs):
            st, pl = carry
            k, fresh = xs
            k_sel, k_step, k_keep = jax.random.split(k, 3)
            triplet = (pair(fresh[:b]), pair(fresh[b:2 * b]),
                       pair(fresh[2 * b:2 * b + local_pool]))
            st, pl, outs = g_update(st, pl, triplet,
                                    (k_sel, k_step, k_keep), lr_g,
                                    progress)
            return (st, pl), outs

        g_keys = jax.random.split(jax.random.fold_in(key, 1), giters)
        (state, pool), g_outs = jax.lax.scan(g_body, (state, pool),
                                             (g_keys, g_fresh))

        def c_body(st, xs):
            k, real_batch = xs
            k_fake, k_gp = jax.random.split(k, 2)
            return c_update(st, pool, real_batch, (k_fake, k_gp), lr_c)

        c_outs = None
        if citers > 0:
            c_keys = jax.random.split(jax.random.fold_in(key, 2), citers)
            state, c_outs = jax.lax.scan(c_body, state,
                                         (c_keys, real_batches))

        return _finalize(state, pool, g_outs, c_outs, citers)

    mapped = jax.shard_map(
        sharded_step,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(None, DATA_AXIS),
                  P(None, DATA_AXIS), P(), P(), P(), P()),
        out_specs=(P(), P(DATA_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(mapped)
