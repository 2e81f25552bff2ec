"""The agent step: one filter application chosen by the policy.

This is the functional heart of the framework — the JAX equivalent
of the reference ``agent_generator`` (reference agent.py:41-260).  One call:

1. runs the policy CNN on the (state-enriched) low-res proxy image,
2. applies ALL K filters to produce candidate images (differentiable
   pathwise branch),
3. samples/argmaxes a filter from the softmax pdf (score-function branch,
   with epsilon exploration mixing, reference agent.py:104-116),
4. blends candidates by the one-hot selection, updates the trajectory
   state vector (reference agent.py:208-239), and
5. computes the penalty terms (overflow, entropy, filter reuse,
   early-stop; reference agent.py:228-252).

Because it is a pure function of (params, image, state, rng) it can be
``lax.scan``-ned over trajectory steps entirely on device — the reference
instead round-trips through the host per step (net.py:441-448, 796-821).

It also emits the *packed trajectory record* (selected filter id +
parameter vector) that the fused Pallas chain kernel replays at full
resolution (the white-box property, reference filters.py:89-98).
"""

import math
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from exposure_jax.ops.filters import max_filter_parameters
from exposure_jax.ops.sampling import pdf_sample
from exposure_jax.utils.ops import (
    STATE_DROPOUT_BEGIN,
    STATE_STEP_DIM,
)


def enrich_image_input(cfg, img, states):
    """Broadcast the state vector as constant channels onto the image
    (reference util.py:31-36), gated by ``cfg.img_include_states``."""
    if cfg.img_include_states:
        bcast = states[:, None, None, :] + img[:, :, :, 0:1] * 0
        img = jnp.concatenate([img, bcast], axis=3)
    return img


def initial_states(batch_size, num_state_dim, dtype=jnp.float32):
    """Fresh trajectory state: all-zero (reference replay_memory.py:53-62)."""
    return jnp.zeros((batch_size, num_state_dim), dtype=dtype)


class AgentStepOutput(NamedTuple):
    image: jnp.ndarray            # [B, H, W, C] selected filtered image
    new_states: jnp.ndarray       # [B, state_dim]
    surrogate: jnp.ndarray        # [B, 1] log pi(selected)
    penalty: jnp.ndarray          # [B, 1]
    selected_filter_id: jnp.ndarray  # [B] int32
    selected_params: jnp.ndarray  # [B, max_params] packed regressed params
    selected_mask_params: jnp.ndarray  # [B, max_mask] raw mask params
    pdf: jnp.ndarray              # [B, K] post-mixing action distribution
    entropy: jnp.ndarray          # [B, 1]
    all_params: Any               # list of per-filter regressed params
    high_res_output: Optional[jnp.ndarray]  # [B, Hh, Wh, C] or None


def pack_param_rows(filters, params_list, raw_mask_list, batch, dtype):
    """Pack per-filter regressed params + raw mask heads into the
    fixed-width trajectory layout the replay kernels consume:
    ``(packed [B, K, max_p], packed_mask [B, K, max_m])``.  Shared by
    the training step and ``core/rollout.py::serve_rollout`` so the
    layout cannot drift between them."""
    max_p = max_filter_parameters(filters)
    max_m = max(f.get_num_mask_parameters() for f in filters)
    packed, packed_mask = [], []
    for f, p, raw_m in zip(filters, params_list, raw_mask_list):
        flat = p.reshape(p.shape[0], -1)
        packed.append(jnp.pad(flat, ((0, 0), (0, max_p - flat.shape[1]))))
        if raw_m is not None:
            packed_mask.append(jnp.pad(
                raw_m, ((0, 0), (0, max_m - raw_m.shape[1]))))
        else:
            packed_mask.append(jnp.zeros((batch, max_m), dtype))
    return jnp.stack(packed, axis=1), jnp.stack(packed_mask, axis=1)


def action_distribution(logits, cfg, num_filters):
    """Softmax + epsilon exploration mix (reference agent.py:100-110).
    Shared by agent_step and serve_rollout."""
    pdf = jax.nn.softmax(logits) + 1e-37
    pdf = pdf * (1 - cfg.exploration) + cfg.exploration / num_filters
    return pdf / (jnp.sum(pdf, axis=1, keepdims=True) + 1e-30)


def advance_states(states, one_hot, cfg, dtype):
    """State-machine step (reference agent.py:208-239): returns
    ``(new_states, is_last_step, usage_penalty)``.  Shared by
    agent_step and serve_rollout."""
    step = states[:, STATE_STEP_DIM:STATE_STEP_DIM + 1]
    is_last_step = (jnp.abs(step + 1 - cfg.test_steps) < 1e-4).astype(
        dtype)
    usage = states[:, STATE_DROPOUT_BEGIN:]
    usage_penalty = jnp.sum(usage * one_hot, axis=1, keepdims=True)
    new_usage = jnp.maximum(usage, one_hot)
    new_states = jnp.concatenate(
        [is_last_step, is_last_step, step + 1, new_usage], axis=1)
    return new_states, is_last_step, usage_penalty


def agent_step(policy, variables, img, states, *, key, is_train, progress,
               cfg, filters, high_res=None, selection_noise=None):
    """Run one policy + filter step.

    Args:
      policy: the ``PolicyNet`` module.
      variables: its parameter pytree.
      img: [B, H, W, C] low-res proxy in [0, 1].
      states: [B, state_dim] trajectory state.
      key: PRNG key (split for dropout and action noise).
      is_train: int32 scalar; 1 -> sample the action, 0 -> argmax
        (reference agent.py:113-116 blends arithmetically; we do the same).
      progress: float scalar in [0, 1]; decays the entropy penalty.
      cfg: config Dict.
      filters: instantiated filter list (same order as policy heads).
      high_res: optional [B, Hh, Ww, C] image transformed with the same
        parameters (resolution-independent replay).
      selection_noise: optional [B, 1] uniform noise overriding the
        internally drawn sample (parity with the reference's z feed,
        agent.py:47).
    """
    k_drop, k_noise = jax.random.split(key)
    num_filters = len(filters)
    enriched = enrich_image_input(cfg, img, states)
    raw_list, logits = policy.apply(variables, enriched,
                                    rngs={'dropout': k_drop})

    candidates = []
    hi_candidates = []
    all_params = []
    raw_masks = []
    for f, raw in zip(filters, raw_list):
        n = f.get_num_filter_parameters()
        raw_f = raw[:, :n]
        raw_m = raw[:, n:] if f.use_masking() else None
        low, hi, params = f.apply(img, raw_parameters=raw_f,
                                  mask_parameters=raw_m, high_res=high_res)
        candidates.append(low)
        hi_candidates.append(hi)
        all_params.append(params)
        raw_masks.append(raw_m)
    candidates = jnp.stack(candidates, axis=1)  # [B, K, H, W, C]
    # [B, K, max_p] / [B, K, max_m]
    packed, packed_mask = pack_param_rows(filters, all_params, raw_masks,
                                          img.shape[0], img.dtype)

    # Action distribution with epsilon exploration (agent.py:100-110).
    pdf = action_distribution(logits, cfg, num_filters)
    entropy = jnp.sum(-pdf * jnp.log(pdf), axis=1)[:, None]

    if selection_noise is None:
        selection_noise = jax.random.uniform(k_noise, (img.shape[0], 1))
    sampled_id = pdf_sample(pdf, selection_noise)
    greedy_id = jnp.argmax(pdf, axis=1).astype(jnp.int32)
    is_train = jnp.asarray(is_train, jnp.int32)
    selected_id = is_train * sampled_id + (1 - is_train) * greedy_id

    # Replay-pool off-policy injection (round 4; DIVERSITY.md addendum 3
    # remedy): with per-record probability ``replay_inject_prob`` the
    # action is FORCED to a uniform-random filter, so the replay pool
    # keeps receiving trajectories from outside the policy's locked-in
    # family.  The forced records are strictly off-policy: their
    # score-function surrogate is zeroed below (no REINFORCE pull toward
    # random actions); the pathwise branch stays live, so the forced
    # filter's parameter head still trains at the visited state.  Train
    # mode only; Python-gated so the default (0.0) trace — and its RNG
    # stream — is bit-identical to the reference-parity step.
    inject_p = float(cfg.get('replay_inject_prob', 0.0) or 0.0)
    if inject_p > 0.0:
        k_inj, k_fid = jax.random.split(jax.random.fold_in(k_noise, 17))
        in_window = (progress <
                     cfg.get('replay_inject_until', 1.0))
        injected = jnp.logical_and(
            jax.random.bernoulli(k_inj, inject_p, (img.shape[0],)),
            jnp.logical_and(is_train > 0, in_window))
        # TARGETED forcing (round 5; VERDICT r4 #2): uniform injection
        # measurably never revives dead filters — a W draw lands with
        # prob 1/K and the resulting state is outvoted in the pool by
        # the locked-in family.  'anti' mode draws the forced filter
        # from q ~ 1/(pdf + c): the LESS the policy picks a filter, the
        # MORE it gets forced (a ~10x tilt toward dead heads at the
        # epsilon floor), so neglected-filter states flow into the
        # replay pool at a rate the lock-in cannot starve.  Same
        # off-policy contract as uniform (surrogate zeroed below).
        inject_mode = str(cfg.get('replay_inject_mode', 'uniform'))
        if inject_mode == 'anti':
            q = 1.0 / (pdf + 0.02)
            q = q / jnp.sum(q, axis=1, keepdims=True)
            forced_id = pdf_sample(
                q, jax.random.uniform(k_fid, (img.shape[0], 1)))
        else:
            forced_id = jax.random.randint(k_fid, (img.shape[0],), 0,
                                           num_filters)
        selected_id = jnp.where(injected, forced_id, selected_id)
    else:
        injected = None

    one_hot = jax.nn.one_hot(selected_id, num_filters, dtype=img.dtype)
    surrogate = jnp.sum(one_hot * jnp.log(pdf + 1e-10), axis=1,
                        keepdims=True)
    if injected is not None:
        surrogate = jnp.where(injected[:, None],
                              jnp.zeros_like(surrogate), surrogate)

    out = jnp.sum(candidates * one_hot[:, :, None, None, None], axis=1)
    if high_res is not None:
        hi_stack = jnp.stack(hi_candidates, axis=1)
        high_res_output = jnp.sum(hi_stack * one_hot[:, :, None, None, None],
                                  axis=1)
    else:
        high_res_output = None
    selected_params = jnp.sum(packed * one_hot[:, :, None], axis=1)
    selected_mask_params = jnp.sum(packed_mask * one_hot[:, :, None],
                                   axis=1)

    # State machine (agent.py:208-239): this release terminates exactly at
    # cfg.test_steps — there is no learned submit action.
    new_states, is_last_step, usage_penalty = advance_states(
        states, one_hot, cfg, img.dtype)
    submitted = is_last_step

    if cfg.clamp:
        out = jnp.clip(out, 0.0, 5.0)

    early_stop_penalty = (1 - is_last_step) * submitted * \
        cfg.early_stop_penalty
    # Entropy-bonus decay (reference agent.py:242-244 is linear 1-t/T).
    # ``entropy_respike`` (round 4) adds a triangular mid-training bump
    # to the decay coefficient — a brief second exploration phase after
    # the pool has a first converged family in it, the other remedy for
    # the exploration lock-in of DIVERSITY.md addendum 3.  Python-gated:
    # the default (0.0) trace is identical to the linear reference decay.
    decay = 1.0 - progress
    respike = float(cfg.get('entropy_respike', 0.0) or 0.0)
    if respike > 0.0:
        center = cfg.get('entropy_respike_center', 0.5)
        width = cfg.get('entropy_respike_width', 0.15)
        decay = decay + respike * jnp.maximum(
            0.0, 1.0 - jnp.abs(progress - center) / width)
    entropy_penalty = decay * cfg.exploration_penalty * (
        -entropy + math.log(num_filters))
    overflow = jnp.mean(jnp.maximum(out - 1, 0) ** 2, axis=(1, 2, 3))[:, None]
    penalty = (overflow + entropy_penalty +
               usage_penalty * cfg.filter_usage_penalty + early_stop_penalty)

    return AgentStepOutput(
        image=out,
        new_states=new_states,
        surrogate=surrogate,
        penalty=penalty,
        selected_filter_id=selected_id,
        selected_params=selected_params,
        selected_mask_params=selected_mask_params,
        pdf=pdf,
        entropy=entropy,
        all_params=all_params,
        high_res_output=high_res_output,
    )
