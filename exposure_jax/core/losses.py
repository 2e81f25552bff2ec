"""Loss functions: dense RL reward, TD(0) advantage, WGAN-GP.

Parity map into the reference:

- reward   = (all_reward + (1-all_reward)*stopped) *
             (fake_logit - sg(input_logit)) * critic_logit_multiplier
             - penalty                        (net.py:100-113)
- q        = reward + (1-stopped)*gamma*V(s') with V(s') zeroed past the
             maximum trajectory length        (net.py:92-97, 125-126)
- advantage = sg(q) - V(s); v_loss = E[advantage^2]   (net.py:128-129)
- g_loss   = E[-q*parameter_lr_mul + log pi * sg(-advantage)]
                                              (net.py:153-163)
- c_loss   = E[fake] - E[real] + lambda*GP, one-sided GP on uniform
             interpolates                     (net.py:151, 174-194)

Gradient-partitioning notes (the part that is easy to get silently wrong,
SURVEY.md §7 "hard parts"):

- The generator gradient flows through the critic's and value net's
  *activations* (pathwise reward) but NOT into their parameters; we
  stop-gradient the critic/value parameter trees inside the generator
  loss so a single ``jax.grad`` over the combined {gen, val} tree yields
  exactly the reference's per-optimizer gradients.
- v_loss is naturally independent of the generator parameters (it only
  sees sg(q) and V of the *input* image), so no extra blocking is needed.
- The discrete selection trains via the score-function surrogate
  ``log pi * sg(-advantage)`` while filter parameters train pathwise
  through ``-q`` — both terms live in g_loss.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from exposure_jax.models.agent import agent_step
from exposure_jax.utils.ops import STATE_STEP_DIM, STATE_STOPPED_DIM

sg = jax.lax.stop_gradient


def _sg_tree(tree):
    return jax.tree_util.tree_map(sg, tree)


class GVLossAux(NamedTuple):
    g_loss: jnp.ndarray
    v_loss: jnp.ndarray
    reward: jnp.ndarray
    q_value: jnp.ndarray
    advantage: jnp.ndarray
    fake_logit: jnp.ndarray
    new_images: jnp.ndarray
    new_states: jnp.ndarray
    selected_filter_id: jnp.ndarray
    selected_params: jnp.ndarray
    pdf: jnp.ndarray


def supervised_distance(images, ground_truth):
    """Default supervised scorer: per-sample MSE to the paired ground
    truth (lower is better; the reward negates it, net.py:100-102)."""
    return jnp.mean((images - ground_truth) ** 2, axis=(1, 2, 3))[:, None]


def generator_value_loss(params, crit_params, policy, critic, value,
                         batch_images, batch_states, key, is_train,
                         progress, cfg, filters, ground_truth=None):
    """Joint scalar loss for the generator (actor) + value optimizers.

    Args:
      params: {'gen': policy variables, 'val': value variables} — the
        differentiated tree.
      crit_params: critic variables (constants here).
      ground_truth: paired targets, supervised mode only.
    Returns:
      (g_loss + v_loss, GVLossAux)
    """
    gen_params = params['gen']
    val_params = params['val']
    supervised = bool(cfg.get('supervised', False))

    out = agent_step(policy, gen_params, batch_images, batch_states,
                     key=key, is_train=is_train, progress=progress,
                     cfg=cfg, filters=filters)

    if supervised:
        assert ground_truth is not None, (
            'supervised mode requires paired ground truth')
        scorer = cfg.get('supervised_scorer', None) or supervised_distance
        fake_logit = scorer(out.image, ground_truth)
        input_logit = scorer(batch_images, ground_truth)
    else:
        # Critic parameters are constants; activations stay
        # differentiable so the pathwise reward gradient reaches the
        # generator (net.py:108-110).
        fake_logit = critic.apply(_sg_tree(crit_params), out.image)
        input_logit = critic.apply(_sg_tree(crit_params), batch_images)

    old_value = value.apply(val_params, batch_images, batch_states)
    # Value *parameters* are blocked in the generator path (theta_g does
    # not include theta_v, net.py:205-210), activations stay live.
    new_value_for_g = value.apply(_sg_tree(val_params), out.image,
                                  out.new_states)

    stopped = out.new_states[:, STATE_STOPPED_DIM:STATE_STOPPED_DIM + 1]
    clear_final = (out.new_states[:, STATE_STEP_DIM:STATE_STEP_DIM + 1]
                   > cfg.maximum_trajectory_length).astype(jnp.float32)
    new_value_for_g = new_value_for_g * (1.0 - clear_final)

    all_mask = cfg.all_reward + (1 - cfg.all_reward) * stopped
    if supervised:
        # Supervised mode (net.py:100-102): the scorer measures distance
        # to ground truth; reward is its negation.
        raw_reward = all_mask * (-fake_logit)
    elif cfg.gan == 'ls':
        # LSGAN branch (net.py:104-106) — dormant in shipped configs.
        raw_reward = all_mask * (1 - (fake_logit - 1) ** 2)
    else:
        raw_reward = all_mask * (
            fake_logit - sg(input_logit)) * cfg.critic_logit_multiplier
    reward = raw_reward
    if cfg.use_penalty:
        reward = reward - out.penalty

    q_value = reward + (1.0 - stopped) * cfg.discount_factor * new_value_for_g
    advantage = sg(q_value) - old_value
    v_loss = jnp.mean(advantage ** 2)

    if cfg.use_TD:
        routine_loss = -q_value * cfg.parameter_lr_mul
        adv_for_pg = -advantage
    else:
        routine_loss = -reward
        adv_for_pg = -reward
    g_loss = jnp.mean(routine_loss + out.surrogate * sg(adv_for_pg))

    aux = GVLossAux(
        g_loss=g_loss,
        v_loss=v_loss,
        reward=reward,
        q_value=q_value,
        advantage=advantage,
        fake_logit=fake_logit,
        new_images=out.image,
        new_states=out.new_states,
        selected_filter_id=out.selected_filter_id,
        selected_params=out.selected_params,
        pdf=out.pdf,
    )
    return g_loss + v_loss, aux


class CriticLossAux(NamedTuple):
    c_loss: jnp.ndarray
    emd: jnp.ndarray
    gradient_penalty: jnp.ndarray
    critic_gradient_norm: jnp.ndarray
    c_average: jnp.ndarray


def critic_loss(crit_params, critic, real_images, fake_images, key, cfg):
    """Critic loss: WGAN-GP (net.py:151, 174-194) or LSGAN
    (net.py:131-134)."""
    fake_logit = critic.apply(crit_params, fake_images)
    real_logit = critic.apply(crit_params, real_images)
    if cfg.gan == 'ls':
        c_loss = jnp.mean(fake_logit ** 2) + jnp.mean(
            (real_logit - 1) ** 2)
        emd = c_loss
        c_average = jnp.zeros(())
    else:
        c_loss = jnp.mean(fake_logit) - jnp.mean(real_logit)
        emd = -c_loss
        c_average = jnp.mean(fake_logit + real_logit) * 0.5

    alpha = jax.random.uniform(key, (real_images.shape[0], 1, 1, 1))
    interpolated = real_images + alpha * (fake_images - real_images)

    # Per-sample input gradients via grad-of-sum (critic rows are
    # independent across the batch).
    grad_fn = jax.grad(lambda x: jnp.sum(critic.apply(crit_params, x)))
    gradients = grad_fn(interpolated)
    gradient_norm = jnp.sqrt(1e-6 + jnp.sum(gradients ** 2, axis=(1, 2, 3)))
    gradient_penalty = cfg.gradient_penalty_lambda * jnp.mean(
        jnp.maximum(gradient_norm - 1.0, 0.0) ** 2)
    if cfg.gan == 'w' and cfg.gradient_penalty_lambda > 0:
        c_loss = c_loss + gradient_penalty

    aux = CriticLossAux(
        c_loss=c_loss,
        emd=emd,
        gradient_penalty=gradient_penalty,
        critic_gradient_norm=jnp.mean(gradient_norm),
        c_average=c_average,
    )
    return c_loss, aux
