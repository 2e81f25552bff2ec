"""On-device trajectory rollout: K policy steps under one lax.scan.

The reference unrolls the trajectory on the HOST, one sess.run per step
with feed-dict round trips (net.py:441-448 for training viz, net.py:796-821
for eval).  Here the whole K-step rollout is a single jitted scan over the
agent step — the policy runs K times on the 64x64 proxy with no host sync,
emitting the packed (filter_id, params) trajectory that the chain replay
(ops/chain.py, or the fused kernel of ops/pallas_chain.py on the GPU)
applies at full resolution."""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from exposure_jax.models.agent import agent_step, initial_states
from exposure_jax.ops.chain import replay_filter_chain


class Trajectory(NamedTuple):
    images: jnp.ndarray        # [K, B, S, S, C] per-step outputs
    states: jnp.ndarray        # [K, B, D]
    filter_ids: jnp.ndarray    # [K, B]
    params: jnp.ndarray        # [K, B, max_p]
    mask_params: jnp.ndarray   # [K, B, max_mask] raw mask-head outputs
    pdfs: jnp.ndarray          # [K, B, num_filters]
    surrogates: jnp.ndarray    # [K, B, 1]
    final_image: jnp.ndarray   # [B, S, S, C]
    final_state: jnp.ndarray   # [B, D]


def rollout(policy, gen_params, images, key, *, cfg, filters, is_train=0,
            num_steps=None, progress=1.0):
    """Run ``num_steps`` (default cfg.test_steps) agent steps on device."""
    if num_steps is None:
        num_steps = cfg.test_steps
    batch = images.shape[0]
    states0 = initial_states(batch, cfg.num_state_dim, images.dtype)

    def body(carry, k):
        img, st = carry
        out = agent_step(policy, gen_params, img, st, key=k,
                         is_train=is_train, progress=progress, cfg=cfg,
                         filters=filters)
        ys = (out.image, out.new_states, out.selected_filter_id,
              out.selected_params, out.selected_mask_params, out.pdf,
              out.surrogate)
        return (out.image, out.new_states), ys

    keys = jax.random.split(key, num_steps)
    (final_img, final_st), ys = jax.lax.scan(body, (images, states0), keys)
    imgs, sts, ids, params, mask_params, pdfs, surs = ys
    return Trajectory(images=imgs, states=sts, filter_ids=ids, params=params,
                      mask_params=mask_params, pdfs=pdfs, surrogates=surs,
                      final_image=final_img, final_state=final_st)


def serve_rollout(policy, gen_params, images, key, *, cfg, filters,
                  replay=None, num_steps=None):
    """Serving-only rollout: advance the proxy through the SELECTED
    branch only.

    ``rollout`` (the training path) applies ALL K filters per step and
    blends by the one-hot selection — the differentiable formulation the
    pathwise gradient needs (reference agent.py:58-77,124-125).  At
    serving time nothing differentiates: this variant regresses the
    parameter HEADS for every filter (cheap vector math), picks the
    argmax action, and advances the 64px proxy with ``replay`` — a chain
    replay with ``ops/pallas_chain.py::pallas_apply_filter_chain``'s
    contract, default the jnp chain — on just the selected step, so
    proxy and full-resolution replay can share one filter
    implementation.

    RNG parity: the per-step key split (dropout, selection-noise)
    matches ``agent_step``, and pdf/epsilon-mix/argmax reproduce
    agent.py:100-116 exactly — step-1 actions are bit-identical to
    ``rollout(is_train=0)``; later steps may flip only where the
    policy's top-2 pdf margin is within the replay-vs-jnp proxy
    tolerance (~1e-5; tests/test_serve_rollout.py).

    Returns ``(filter_ids [K, B], params [K, B, max_p],
    mask_params [K, B, max_m])`` — the plan triple serving consumes.
    """
    from exposure_jax.models.agent import (action_distribution,
                                           advance_states,
                                           enrich_image_input,
                                           pack_param_rows)

    if replay is None:
        replay = replay_filter_chain
    if num_steps is None:
        num_steps = cfg.test_steps
    batch = images.shape[0]
    num_filters = len(filters)
    states0 = initial_states(batch, cfg.num_state_dim, images.dtype)
    masking = any(f.use_masking() for f in filters)

    def body(carry, k):
        img, st = carry
        k_drop, _k_noise = jax.random.split(k)  # same split as agent_step
        enriched = enrich_image_input(cfg, img, st)
        raw_list, logits = policy.apply(gen_params, enriched,
                                        rngs={'dropout': k_drop})

        params_list, raw_masks = [], []
        for f, raw in zip(filters, raw_list):
            n = f.get_num_filter_parameters()
            params_list.append(f.filter_param_regressor(raw[:, :n]))
            raw_masks.append(raw[:, n:] if f.use_masking() else None)
        packed, packed_mask = pack_param_rows(
            filters, params_list, raw_masks, batch, img.dtype)

        # action distribution + epsilon mix (agent.py:100-110); serving
        # is argmax (is_train=0), so the uniform selection draw that
        # agent_step makes is unused and skipped here
        pdf = action_distribution(logits, cfg, num_filters)
        selected_id = jnp.argmax(pdf, axis=1).astype(jnp.int32)

        one_hot = jax.nn.one_hot(selected_id, num_filters, dtype=img.dtype)
        sel_params = jnp.sum(packed * one_hot[:, :, None], axis=1)
        sel_mask = jnp.sum(packed_mask * one_hot[:, :, None], axis=1)

        out = replay(
            img.astype(jnp.float32), selected_id[None],
            sel_params.astype(jnp.float32)[None], filters,
            mask_params=(sel_mask.astype(jnp.float32)[None]
                         if masking else None)).astype(img.dtype)
        if cfg.clamp:
            # agent_step clamps the blended proxy the same way
            out = jnp.clip(out, 0.0, 5.0)

        # state machine (agent.py:208-239 / agent_step)
        new_st, _is_last, _usage_pen = advance_states(
            st, one_hot, cfg, img.dtype)
        return (out, new_st), (selected_id, sel_params, sel_mask)

    keys = jax.random.split(key, num_steps)
    _, (ids, params, mask) = jax.lax.scan(body, (images, states0), keys)
    return ids, params, mask
