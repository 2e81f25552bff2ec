"""Filter-chain replay: apply a recorded (filter_id, params) trajectory to
an image at any resolution.

This is the white-box replay primitive (reference filters.py:89-98,
net.py:683-709): the policy decides on the 64x64 proxy, and the chosen
operations are replayed losslessly on the full-resolution image.  The
reference rebuilds a TF graph per resolution and round-trips per step;
here the chain is a single jitted function (this module) or, on the
GPU, a single fused Pallas kernel (``exposure_jax.ops.pallas_chain``).

The jnp implementation evaluates all K filters per step and selects
(branchless — the XLA-friendly formulation under vmap).  It is the
reference the kernel is tested against, and the CPU path."""

import jax
import jax.numpy as jnp
import numpy as np


def apply_filter_step(img, filter_id, packed_params, filters,
                      mask_params=None):
    """Apply one recorded step to [B, H, W, C] given per-sample ids.

    Args:
      img: [B, H, W, C].
      filter_id: [B] int32.
      packed_params: [B, max_p] regressed parameters (zero-padded).
      mask_params: optional [B, max_mask] raw mask-head outputs
        (masking mode).
    """
    outs = []
    for f in filters:
        n = f.get_num_filter_parameters()
        mp = None
        if mask_params is not None and f.use_masking():
            mp = mask_params[:, :f.get_num_mask_parameters()]
        out, _, _ = f.apply(img, specified_parameter=packed_params[:, :n],
                            mask_parameters=mp)
        outs.append(out)
    stacked = jnp.stack(outs, axis=1)  # [B, K, H, W, C]
    one_hot = jax.nn.one_hot(filter_id, len(filters), dtype=img.dtype)
    return jnp.sum(stacked * one_hot[:, :, None, None, None], axis=1)


def apply_filter_chain(img, filter_ids, packed_params, filters,
                       active_steps=None, mask_params=None):
    """Replay a K-step trajectory.

    Args:
      img: [B, H, W, C] input image (linear RAW domain).
      filter_ids: [K, B] int32 per-step filter choices.
      packed_params: [K, B, max_p] per-step packed parameters.
      active_steps: optional [K, B] 0/1 mask (1 = apply step); lets a
        jitted caller stop trajectories early without dynamic shapes.
      mask_params: optional [K, B, max_mask] per-step raw mask-head
        outputs (masking mode).

    Returns:
      [B, H, W, C] output image.
    """
    num_steps = filter_ids.shape[0]

    def body(carry, xs):
        fid, par, act, mp = xs
        out = apply_filter_step(carry, fid, par, filters, mask_params=mp)
        if act is not None:
            out = jnp.where(act[:, None, None, None] > 0, out, carry)
        return out, None

    # lax.scan requires uniform xs; thread absent optionals as None via
    # a python-level wrapper over per-step slices
    def scan_like(body_fn, init):
        carry = init
        for i in range(num_steps):
            act = active_steps[i] if active_steps is not None else None
            mp = mask_params[i] if mask_params is not None else None
            carry, _ = body_fn(carry, (filter_ids[i], packed_params[i],
                                       act, mp))
        return carry

    if active_steps is None and mask_params is None:
        xs = (filter_ids, packed_params)

        def simple_body(carry, xs_):
            fid, par = xs_
            return apply_filter_step(carry, fid, par, filters), None

        out, _ = jax.lax.scan(simple_body, img, xs, length=num_steps)
        return out
    return scan_like(body, img)


def quantize_u8(x):
    """[0, 1] float -> uint8, rounding half up (the replay kernel's
    quantizer)."""
    return jnp.floor(jnp.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)


def replay_filter_chain(img, filter_ids, packed_params, filters,
                        active_steps=None, mask_params=None):
    """``apply_filter_chain`` under the replay kernel's I/O contract
    (``ops/pallas_chain.py::pallas_apply_filter_chain``): a uint8 image
    is read as fixed-point [0, 1] and the result is quantized back to
    uint8; float32 passes through."""
    if img.dtype != jnp.uint8:
        return apply_filter_chain(img, filter_ids, packed_params, filters,
                                  active_steps, mask_params)
    out = apply_filter_chain(img.astype(jnp.float32) * (1.0 / 255.0),
                             filter_ids, packed_params, filters,
                             active_steps, mask_params)
    return quantize_u8(out)


# The replay kernel's tolerance against this module's chain (chip_smoke.py,
# tools/bench_replay.py): uint8 within U8_TOL steps of the 8-bit scale,
# float32 within F32_TOL absolute.  One allowance, for float32: where the
# chain is ill-conditioned (an S+ step on a near-gray pixel multiplies
# differences in its input by up to k*v/range), last-bit differences
# between two implementations grow past F32_TOL.  There a value may differ
# by F32_TOL plus SPREAD_FACTOR times the chain's own spread
# (``rounding_spread``), on at most SPREAD_FRAC of the pixels.
U8_TOL = 1
F32_TOL = 2e-5
PERTURB = 2.0 ** -21  # relative; 4-8 float32 steps
SPREAD_FACTOR = 4
SPREAD_FRAC = 2e-5


def rounding_spread(img, filter_ids, packed_params, filters,
                    active_steps=None, mask_params=None, draws=2):
    """How far the chain's float32 result moves when the output of every
    step is perturbed by PERTURB (relative, random sign per value): the
    largest change over ``draws`` perturbations, per value.  Arguments as
    ``replay_filter_chain``'s; a uint8 image is dequantized."""
    x0 = img.astype(jnp.float32) * (1.0 / 255.0) \
        if img.dtype == jnp.uint8 else img

    def run(key):
        x = x0
        for k in range(filter_ids.shape[0]):
            out = apply_filter_step(
                x, filter_ids[k], packed_params[k], filters,
                mask_params=None if mask_params is None else mask_params[k])
            if key is not None:
                sign = jax.random.rademacher(jax.random.fold_in(key, k),
                                             out.shape, out.dtype)
                out = out * (1.0 + PERTURB * sign)
            if active_steps is not None:
                out = jnp.where(active_steps[k][:, None, None, None] > 0,
                                out, x)
            x = out
        return x

    plain = run(None)
    return jnp.stack([jnp.abs(run(jax.random.PRNGKey(d)) - plain)
                      for d in range(draws)]).max(axis=0)


def replay_mismatch(got, ref, spread=None):
    """Hold a replay to this chain's result ``ref`` under the tolerance
    above.  Returns ``(worst, n_bad, n_eased)``: the largest difference
    (LSB for uint8, absolute for float32; inf for a non-finite value on
    either side), how many values break the tolerance, and how many
    float32 values pass only through the ill-conditioning allowance
    (``spread`` from ``rounding_spread``; without it there is none)."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.dtype == np.uint8:
        err = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        return int(err.max()), int((err > U8_TOL).sum()), 0
    finite = np.isfinite(got) & np.isfinite(ref)
    err = np.where(finite, np.abs(got.astype(np.float64) - ref), np.inf)
    over = err > F32_TOL
    eased = np.zeros_like(over)
    if spread is not None:
        eased = over & (err <= F32_TOL + SPREAD_FACTOR * np.asarray(spread))
        if eased.any(axis=-1).sum() > SPREAD_FRAC * eased[..., 0].size:
            eased[:] = False
    return float(err.max()), int((over & ~eased).sum()), int(eased.sum())
