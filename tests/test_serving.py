"""Serving pipeline tests (CPU: the jnp chain, or the replay kernel in
Pallas interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exposure_jax.core.serving import RetouchPipeline
from exposure_jax.core.trainer import build_models, init_train_state
from exposure_jax.ops.pallas_chain import select_chain_replay
from exposure_jax.utils import load_config

def kernel_pipeline(cfg, state):
    """A pipeline replaying through the kernel in interpret mode."""
    pipe = RetouchPipeline(cfg, state)
    pipe.replay = select_chain_replay(interpret=True)
    return pipe



@pytest.fixture(scope='module')
def pipeline():
    cfg = load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    return kernel_pipeline(cfg, state)


def test_uint8_roundtrip(pipeline, rng):
    imgs = (rng.rand(2, 64, 128, 3) * 255).astype(np.uint8)
    out = pipeline(imgs)
    assert out.shape == imgs.shape
    assert out.dtype == np.uint8


def test_device_out_matches_fetched(pipeline, rng):
    # __call__(device_out=True) returns the device array un-fetched;
    # values must equal the host-fetched path bit-for-bit
    imgs = (rng.rand(2, 64, 128, 3) * 255).astype(np.uint8)
    dev = pipeline(imgs, seed=7, device_out=True)
    assert isinstance(dev, jax.Array)
    host = pipeline(imgs, seed=7)
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(np.asarray(dev), host)


def test_float_input(pipeline, rng):
    cfg = load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    pipe = RetouchPipeline(cfg, state)
    imgs = rng.rand(2, 64, 64, 3).astype(np.float32) * 0.5
    out = pipe(imgs)
    assert out.shape == imgs.shape
    assert np.isfinite(out).all()


def test_deterministic_same_seed(pipeline, rng):
    imgs = (rng.rand(1, 64, 128, 3) * 255).astype(np.uint8)
    a = pipeline(imgs, seed=3)
    b = pipeline(imgs, seed=3)
    np.testing.assert_array_equal(a, b)


def test_bf16_rollout(rng):
    # bf16 policy rollout: params/proxy cast to bfloat16, replay params
    # cast back to f32 — output stays finite and full precision
    cfg = load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    pipe = RetouchPipeline(cfg, state, bf16=True)
    imgs = rng.rand(2, 64, 64, 3).astype(np.float32) * 0.5
    out = pipe(imgs)
    assert out.dtype == np.float32
    assert np.isfinite(out).all()
    # greedy selection is usually robust to bf16: outputs should be close
    # to the f32 pipeline wherever the selected chains agree
    pipe32 = RetouchPipeline(cfg, state, bf16=False)
    out32 = pipe32(imgs)
    assert np.isfinite(out32).all()


def test_masked_serving(rng):
    # masking config: recorded mask params ride through the fused kernel
    cfg = load_config('test').copy()
    cfg.masking = True
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    pipe = kernel_pipeline(cfg, state)
    imgs = (rng.rand(1, 64, 128, 3) * 255).astype(np.uint8)
    out = pipe(imgs)
    assert out.shape == imgs.shape and out.dtype == np.uint8

    # and the jnp fallback path agrees within a quantization step
    pipe_jnp = RetouchPipeline(cfg, state)
    out_jnp = pipe_jnp(imgs)
    diff = np.abs(out.astype(np.int32) - out_jnp.astype(np.int32))
    assert diff.max() <= 1


def test_map_batches_pipelined(rng):
    cfg = load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    pipe = kernel_pipeline(cfg, state)
    batches = [(rng.rand(2, 64, 128, 3) * 255).astype(np.uint8)
               for _ in range(3)]
    outs = list(pipe.map_batches(iter(batches), seed=2))
    assert len(outs) == 3
    for b, o in zip(batches, outs):
        assert o.shape == b.shape and o.dtype == np.uint8
    # determinism: same stream twice
    outs2 = list(pipe.map_batches(iter(batches), seed=2))
    for a, c in zip(outs, outs2):
        np.testing.assert_array_equal(a, c)


def test_map_batches_depth_invariant(rng):
    # per-batch RNG depends only on (seed, position): streaming a batch
    # list must give what calling each batch at its position gives
    cfg = load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    pipe = kernel_pipeline(cfg, state)
    batches = [(rng.rand(2, 64, 128, 3) * 255).astype(np.uint8)
               for _ in range(7)]
    stream = list(pipe.map_batches(iter(batches), seed=3))
    assert len(stream) == 7
    for i, (b, a) in enumerate(zip(batches, stream)):
        out, _ = pipe.plan_and_replay(b, seed=3, idx=i)
        np.testing.assert_array_equal(a, np.asarray(out))


def test_map_batches_early_break(rng):
    # a consumer that stops early must close the generator cleanly
    cfg = load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    pipe = kernel_pipeline(cfg, state)
    batches = [(rng.rand(2, 64, 128, 3) * 255).astype(np.uint8)
               for _ in range(5)]
    gen = pipe.map_batches(iter(batches), seed=1)
    first = next(gen)
    assert first.shape == batches[0].shape
    gen.close()


def test_kernel_pipeline_matches_jnp_pipeline(rng):
    # the kernel path (interpret mode) and the CPU jnp path plan and
    # replay the same batch within a quantization step
    cfg = load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    imgs = (rng.rand(4, 64, 128, 3) * 255).astype(np.uint8)
    a = kernel_pipeline(cfg, state)(imgs, seed=5)
    b = RetouchPipeline(cfg, state)(imgs, seed=5)
    assert a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= 1, diff.max()


def test_plan_and_replay_returns_its_plan(pipeline, rng):
    # the returned plan replays (jnp chain) to the returned output
    from exposure_jax.ops.chain import replay_filter_chain
    imgs = (rng.rand(3, 48, 64, 3) * 255).astype(np.uint8)
    out, (ids, params, mask) = pipeline.plan_and_replay(imgs, seed=2)
    k = pipeline.cfg.test_steps
    assert ids.shape == (k, 3) and params.shape[:2] == (k, 3)
    assert mask.shape[:2] == (k, 3)
    ref = replay_filter_chain(jnp.asarray(imgs), ids, params,
                              pipeline.filters)
    diff = np.abs(np.asarray(out).astype(np.int32) -
                  np.asarray(ref).astype(np.int32))
    assert diff.max() <= 1


def test_program_shards_over_devices(rng):
    # the per-batch program under shard_map: each device plans and
    # replays its own slice of the batch (data-parallel serving)
    from jax.sharding import PartitionSpec as P

    from exposure_jax.parallel.mesh import DATA_AXIS, data_parallel_mesh
    cfg = load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    pipe = RetouchPipeline(cfg, state)
    mesh = data_parallel_mesh(2)
    imgs = jnp.asarray((rng.rand(4, 32, 48, 3) * 255).astype(np.uint8))
    program = pipe.program((2, 32, 48, 3), jnp.uint8)
    serve = jax.jit(jax.shard_map(
        lambda p, x, k: program(p, x, k, 0), mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P()),
        out_specs=(P(DATA_AXIS), (P(None, DATA_AXIS),) * 3),
        check_vma=False))
    out, _ = serve(state.gen_params, imgs, jax.random.PRNGKey(1))
    # same key on every shard: each half equals the single-device run
    for s in (slice(0, 2), slice(2, 4)):
        one, _ = pipe.plan_and_replay(imgs[s], seed=1)
        np.testing.assert_array_equal(np.asarray(out[s]), np.asarray(one))


@pytest.mark.parametrize('platform', ['rocm', 'METAL'])
def test_pipeline_refuses_other_platforms(monkeypatch, platform):
    cfg = load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state, _ = init_train_state(cfg, policy, critic, value, 0)
    monkeypatch.setattr(jax, 'default_backend', lambda: platform)
    with pytest.raises(NotImplementedError):
        RetouchPipeline(cfg, state)
