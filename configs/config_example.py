"""Flagship config: unpaired FiveK RAW -> expert-C retouching.

Knob NAMES and VALUES carry parity with the reference's config_example.py
(cited per group below, into /root/reference/config_example.py) so users
of the reference can bring their configs across unchanged; the
provider/optimizer entries are JAX equivalents."""

from exposure_jax.data import ArtistDataProvider, FiveKDataProvider
from exposure_jax.ops.filters import (
    ColorFilter,
    ContrastFilter,
    ExposureFilter,
    GammaFilter,
    ImprovedWhiteBalanceFilter,
    SaturationPlusFilter,
    ToneFilter,
    WNBFilter,
)
from exposure_jax.utils import Dict

cfg = Dict()

# --- filter bank (reference config_example.py:19-39) ---------------------
cfg.update(
    filters=[
        ExposureFilter, GammaFilter, ImprovedWhiteBalanceFilter,
        SaturationPlusFilter, ToneFilter, ContrastFilter, WNBFilter,
        ColorFilter,
    ],
    curve_steps=8,
    gamma_range=3,
    exposure_range=3.5,
    wb_range=1.1,
    color_curve_range=(0.90, 1.10),
    lab_curve_range=(0.90, 1.10),
    tone_curve_range=(0.5, 2),
    # spatial masking is a dormant capability in the shipped setup
    masking=False,
    minimum_strength=0.3,
    maximum_sharpness=1,
    clamp=False,
)

# --- RL (reference config_example.py:41-65) -------------------------------
cfg.update(
    critic_logit_multiplier=0.05,
    discount_factor=1.0,
    filter_usage_penalty=1.0,
    use_TD=True,
    test_random_walk=False,
    replay_memory_size=128,
    maximum_trajectory_length=7,
    over_length_keep_prob=0.5,
    all_reward=1.0,
    img_include_states=True,
    exploration=0.05,
    exploration_penalty=0.05,
    early_stop_penalty=1.0,
    test_steps=5,
)

# --- networks (reference config_example.py:67-80) -------------------------
cfg.update(
    source_img_size=64,
    base_channels=32,
    dropout_keep_prob=0.5,
    share_feed_dict=True,
    shared_feature_extractor=True,
    fc1_size=128,
    bnw=False,
    feature_extractor_dims=4096,
)

# --- GAN (reference config_example.py:82-110) -----------------------------
cfg.update(
    use_penalty=True,
    gan='w',           # 'w' (WGAN-GP) or 'ls' (LSGAN)
    giters=1,
    citers=5,
    gradient_penalty_lambda=10,
    critic_initialization=10,
    clamp_critic=0.01,
    median_filter_size=101,
    z_type='uniform',
    z_dim_per_filter=16,
)
cfg.num_state_dim = 3 + len(cfg.filters)
cfg.z_dim = 3 + len(cfg.filters) * cfg.z_dim_per_filter
cfg.real_img_size = 64
cfg.real_img_channels = 1 if cfg.bnw else 3

# --- training schedule (reference config_example.py:123-165) --------------
_multiplier = 2
cfg.update(
    supervised=False,
    batch_size=64,
    max_iter_step=int(10000 * _multiplier),
    parameter_lr_mul=1,
    value_lr_mul=10,
    adam_beta1=0.5,
    adam_beta2=0.9,
    num_samples=64,
    summary_freq=100,
)
cfg.img_channels = 1 if cfg.bnw else 3

_lr_decay, _base_lr, _segments = 0.1, 5e-5, 3
_generator_lr_mul, _critic_lr_mul = 0.3, 1


def _decayed(mul):
    def schedule(t):
        return mul * _base_lr * _lr_decay ** (
            1.0 * t * _segments / cfg.max_iter_step)
    return schedule


cfg.lr_g = _decayed(_generator_lr_mul)
cfg.lr_c = _decayed(_critic_lr_mul)

# --- dispatch (exposure_jax extension; no reference counterpart) ----------
# Fuse up to N plain outer iterations into one device dispatch
# (bit-identical RNG to per-iteration dispatch, core/steps.py) and defer
# bookkeeping by `dispatch_pipeline_depth` chunks so metric fetches
# overlap device execution (core/trainer.py).
cfg.iters_per_dispatch = 100
cfg.dispatch_pipeline_depth = 2

# --- observability (reference config_example.py:167-173) ------------------
cfg.update(
    vis_draw_critic_scores=True,
    vis_step_test=False,
    realtime_vis=False,
    write_image_interval=int(200 * _multiplier),
)

# --- datasets (reference config_example.py:175-198) -----------------------
cfg.fake_data_provider = lambda: FiveKDataProvider(
    set_name='2k_train', raw=True, bnw=cfg.bnw, output_size=64,
    default_batch_size=cfg.batch_size, augmentation=0.3)

cfg.fake_data_provider_test = lambda: FiveKDataProvider(
    set_name='u_test', raw=True, bnw=cfg.bnw, output_size=64,
    default_batch_size=cfg.batch_size, augmentation=0.0)

cfg.real_data_provider = lambda: ArtistDataProvider(
    set_name='2k_target', name='FiveK_C', bnw=cfg.bnw, output_size=64,
    default_batch_size=cfg.batch_size, augmentation=1.0)
