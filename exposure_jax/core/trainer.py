"""The Trainer: owns the models, train state, device data and the loop.

JAX counterpart of the reference ``GAN`` class (net.py:18-877):
same run layout (``models/<name>/`` with scripts backup, log tee, images
dir, periodic checkpoints) and the same training choreography
(citers bursts, iter-0 warmup at lr 0, net.py:307-364) — but the per
iteration work is ONE jitted sharded call (see core/steps.py) and the
input pipeline is device-resident, so the host loop only dispatches and
occasionally reads scalars."""

import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from exposure_jax.core.checkpoint import (
    latest_checkpoint_step,
    restore_checkpoint,
    save_checkpoint,
)
from exposure_jax.core.replay import PoolState
from exposure_jax.core.rollout import rollout
from exposure_jax.core.steps import build_outer_step
from exposure_jax.core.train_state import TrainState, make_optimizer
from exposure_jax.models import CriticNet, PolicyNet
from exposure_jax.parallel.mesh import DATA_AXIS, data_parallel_mesh
from exposure_jax.utils import MedianWindow, MetricLogger, Tee
from exposure_jax.utils.image_io import make_image_grid, write_image


_REALTIME_VIS_FAILED = [False]


def _show_realtime(img, title):
    """Live visualization window (reference net.py:547-549's cv2 window);
    degrades to a one-time notice on headless machines."""
    if _REALTIME_VIS_FAILED[0]:
        return
    try:
        import cv2
        bgr = (np.clip(img[..., ::-1], 0, 1) * 255).astype(np.uint8)
        cv2.imshow(title, bgr)
        cv2.waitKey(1)
    except Exception as e:
        _REALTIME_VIS_FAILED[0] = True
        print('# realtime_vis unavailable (%s); continuing headless' % e)


def is_special_iteration(i, cfg, supervised):
    """Iterations that need their own dispatch schedule: the iter-0
    warmup (100 G updates at lr 0) and the citers bursts at
    initialization and every 500 iters (reference net.py:312-328)."""
    if i == 0:
        return True
    if supervised:
        return False
    return cfg.gan == 'w' and (i < cfg.critic_initialization or
                               i % 500 == 0)


def plan_fused_chunk(it, cfg, n_fuse, supervised):
    """How many consecutive iterations starting at ``it`` can run in one
    fused dispatch without crossing a schedule or bookkeeping boundary.

    Returns 1 (single-dispatch path) for special iterations (warmup,
    critic bursts) and otherwise the largest c <= n_fuse such that
    [it, it+c) contains no burst iteration.  The fused step returns
    metrics for EVERY iteration in the chunk, so chunks may span any
    number of 10-iter logging boundaries; they still end exactly ON
    checkpoint iterations ((j+1) % interval == 0) to keep the
    checkpoint cadence, and ON visualization iterations
    (j % write_image_interval == 0) so the grid is drawn from the
    state at that iteration."""
    def special(i):
        return is_special_iteration(i, cfg, supervised)

    if n_fuse <= 1 or special(it):
        return 1
    end = min(it + n_fuse - 1, cfg.max_iter_step)
    ckpt = cfg.get('checkpoint_interval', 500)
    wii = cfg.get('write_image_interval', 0)
    for j in range(it, end + 1):
        if j > it and special(j):
            return j - it
        if (j + 1) % ckpt == 0 and j < end:
            return j - it + 1              # end ON the checkpoint iter
        if wii and j % wii == 0 and j < end:
            return j - it + 1              # end ON the viz iter
    return end - it + 1


def pool_health_warning(citers, supervised, terminated_frac):
    """Guard against the silent failure mode where the critic trains
    while the replay pool holds no terminated records: our
    ``sample_terminated`` falls back to uniform sampling there (the
    reference hard-asserts instead, replay_memory.py:260), which would
    quietly feed the critic non-terminated images."""
    if citers > 0 and not supervised and terminated_frac <= 0:
        return ('critic phase ran with ZERO terminated records in the '
                'replay pool; critic batches fell back to uniform '
                'sampling over unterminated records — check the warmup '
                'schedule (reference replay_memory.py:260 hard-asserts '
                'here)')
    return None


def build_models(cfg):
    """Instantiate filters + the three networks from a config."""
    filters = [f(cfg) for f in cfg.filters]
    policy = PolicyNet(
        filter_output_dims=tuple(
            f.get_num_filter_parameters() + f.get_num_mask_parameters()
            for f in filters),
        feature_extractor_dims=cfg.feature_extractor_dims,
        base_channels=cfg.base_channels,
        fc1_size=cfg.fc1_size,
        dropout_keep_prob=cfg.dropout_keep_prob)
    critic = CriticNet(cfg.base_channels, cfg.fc1_size)
    value = CriticNet(cfg.base_channels, cfg.fc1_size)
    return filters, policy, critic, value


def init_train_state(cfg, policy, critic, value, seed=0):
    key = jax.random.PRNGKey(seed)
    k_g, k_c, k_v, k_d = jax.random.split(key, 4)
    img = jnp.zeros((2, cfg.source_img_size, cfg.source_img_size,
                     cfg.real_img_channels + cfg.num_state_dim))
    gen_params = policy.init({'params': k_g, 'dropout': k_d}, img)
    plain = jnp.zeros((2, cfg.source_img_size, cfg.source_img_size,
                       cfg.real_img_channels))
    crit_params = critic.init(k_c, plain)
    val_params = value.init(k_v, plain, jnp.zeros((2, cfg.num_state_dim)))
    tx = make_optimizer(cfg.get('adam_beta1', 0.5), cfg.get('adam_beta2', 0.9))
    return TrainState.create(gen_params, val_params, crit_params, tx), tx


class Trainer:

    def __init__(self, cfg, restore=False, num_devices=None, data_root='.',
                 model_root='models'):
        self.cfg = cfg
        self.data_root = data_root
        assert cfg.gan == 'w' or cfg.gan == 'ls'
        self.dir = os.path.join(model_root, cfg.name)
        safe = cfg.name.replace('/', '-')
        self.image_dir = os.path.join(self.dir, 'images-' + safe)
        self.dump_dir = os.path.join(self.dir, 'dump-' + safe)
        for d in (self.dir, self.image_dir, self.dump_dir):
            os.makedirs(d, exist_ok=True)

        self.tee = None
        if not restore:
            self.backup_scripts()
            self.tee = Tee(os.path.join(self.dir, 'log.txt'))

        self.mesh = data_parallel_mesh(num_devices)
        self.n_dev = self.mesh.shape[DATA_AXIS]
        print('# exposure_jax: %d-device data-parallel mesh' % self.n_dev)

        self.filters, self.policy, self.critic, self.value = build_models(cfg)
        self.state, self.tx = init_train_state(
            cfg, self.policy, self.critic, self.value, cfg.get('seed', 0))
        # replicated over the mesh, as every step returns it: the first
        # dispatch then compiles the program all later ones reuse (an
        # uncommitted state is a different jit cache key)
        self.state = jax.device_put(self.state,
                                    NamedSharding(self.mesh, P()))

        # ---------------- data: device-resident or streaming ----------
        self.fake_provider = cfg.fake_data_provider()
        self.real_provider = cfg.real_data_provider()
        shard = NamedSharding(self.mesh, P(DATA_AXIS))
        self.streaming = bool(cfg.get('stream_data', False))
        if self.streaming:
            # host-assembled fresh data per call (native hostloader path)
            self.fake_images = self.real_images = None
            self.fake_meta = self.real_meta = None
        else:
            fake_pack = self.fake_provider.device_pack()
            real_pack = self.real_provider.device_pack()
            self.fake_meta = (fake_pack.output_size, fake_pack.augment)
            self.real_meta = (real_pack.output_size, real_pack.augment)
            self.fake_images = jax.device_put(
                self._pad_to_devices(fake_pack.images), shard)
            self.real_images = jax.device_put(
                self._pad_to_devices(real_pack.images), shard)

        # ---------------- replay pool ----------------
        self.supervised = bool(cfg.get('supervised', False))
        pool_batch, _ = self.fake_provider.get_next_batch(
            cfg.replay_memory_size)
        if self.supervised:
            # paired provider yields [P, 2, S, S, C] (input, ground truth)
            pool_images = jnp.asarray(pool_batch[:, 0])
            pool_gt = jax.device_put(jnp.asarray(pool_batch[:, 1]), shard)
        else:
            pool_images = jnp.asarray(pool_batch)
            pool_gt = None
        pool = PoolState.create(pool_images, cfg.num_state_dim, pool_gt)
        self.pool = pool.replace(
            images=jax.device_put(pool.images, shard),
            states=jax.device_put(pool.states, shard))

        self._steps = {}
        self._logger = MetricLogger(os.path.join(self.dir, 'metrics.jsonl'))
        self._rollout_fn = None
        self._score_fn = None

    def _pad_to_devices(self, arr):
        n = arr.shape[0]
        r = (-n) % self.n_dev
        if r:
            arr = np.concatenate([arr, arr[:r]], axis=0)
        return jnp.asarray(arr)

    def backup_scripts(self):
        """Snapshot the config (and repo configs) into the run dir so runs
        are self-describing (reference net.py:672-681)."""
        script_dir = os.path.join(self.dir, 'scripts')
        os.makedirs(script_dir, exist_ok=True)
        src = self.cfg.get('config_path', None)
        candidates = []
        if src:
            candidates.append(src)
        here = os.getcwd()
        for d in (here, os.path.join(here, 'configs')):
            if os.path.isdir(d):
                for fn in os.listdir(d):
                    if fn.startswith('config_') and fn.endswith('.py'):
                        candidates.append(os.path.join(d, fn))
        for path in candidates:
            try:
                shutil.copy(path, script_dir)
            except (IOError, shutil.SameFileError):
                pass

    # ------------------------------------------------------------------
    def _get_step(self, giters, citers):
        key = (self.streaming, giters, citers)
        if key not in self._steps:
            t0 = time.time()
            if self.streaming:
                from exposure_jax.core.steps import \
                    build_streaming_outer_step
                self._steps[key] = build_streaming_outer_step(
                    self.cfg, self.policy, self.critic, self.value,
                    self.filters, self.tx, self.mesh, giters, citers)
            else:
                self._steps[key] = build_outer_step(
                    self.cfg, self.policy, self.critic, self.value,
                    self.filters, self.tx, self.mesh, self.fake_meta,
                    self.real_meta, giters, citers)
            print('# compiled outer step (giters=%d, citers=%d) handle in '
                  '%.1fs' % (giters, citers, time.time() - t0))
        return self._steps[key]

    def _assemble_stream(self, giters, citers, n_iters=1):
        """Host-side fresh-data assembly for one streaming call; in
        supervised mode each fresh image carries its paired ground truth
        channel-stacked ([..., 2C]).  ``n_iters > 1`` assembles the
        stacked bundle for a fused multi-iteration dispatch
        ([N, giters, ...] / [N, citers, ...]) in the same single native
        call — reshaped host-side so no extra device op is dispatched."""
        cfg = self.cfg
        n = n_iters
        giters, citers = giters * n, citers * n
        b, p = cfg.batch_size, cfg.replay_memory_size
        chunk = 2 * b + p
        c = cfg.real_img_channels
        # uint8 bundles quarter the host->device upload; pixels are
        # quantized at assembly and dequantized inside the jitted step
        # (steps.py _dequant_stream)
        u8 = str(cfg.get('stream_dtype', 'float32')) == 'uint8'
        dt = np.uint8 if u8 else np.float32
        g_fresh = np.empty((giters, chunk) +
                           (cfg.source_img_size, cfg.source_img_size,
                            (2 * c if self.supervised else c)), dt)
        if (not self.supervised
                and hasattr(self.fake_provider, 'sample_into')):
            # native zero-restack path: ONE hostloader call fills the
            # whole [giters*chunk, S, S, C] bundle in its final layout
            # (quantizing at write in the u8 case)
            self.fake_provider.sample_into(
                g_fresh.reshape((giters * chunk,) + g_fresh.shape[2:]))
        else:
            def q(x):
                return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(dt) \
                    if u8 else x
            for i in range(giters):
                batch = self.fake_provider.get_next_batch(chunk)[0]
                if self.supervised:
                    # paired provider yields [n, 2, S, S, C]
                    g_fresh[i, ..., :c] = q(batch[:, 0])
                    g_fresh[i, ..., c:] = q(batch[:, 1])
                else:
                    g_fresh[i] = q(batch)
        if citers > 0 and hasattr(self.real_provider, 'sample_into'):
            real = np.empty((citers * b, cfg.source_img_size,
                             cfg.source_img_size, cfg.real_img_channels),
                            dt)
            self.real_provider.sample_into(real)
            real = real.reshape((citers, b) + real.shape[1:])
        elif citers > 0:
            real = np.stack([self.real_provider.get_next_batch(b)[0]
                             for _ in range(citers)])
            if u8:
                real = (np.clip(real, 0.0, 1.0) * 255.0 + 0.5).astype(dt)
        else:
            real = np.zeros((0, b, cfg.source_img_size,
                             cfg.source_img_size, cfg.real_img_channels),
                            dt)
        if n > 1:
            g_fresh = g_fresh.reshape((n, giters // n) + g_fresh.shape[1:])
            real = real.reshape((n, citers // n) + real.shape[1:])
        return jnp.asarray(g_fresh), jnp.asarray(real)

    def _stream_bundle(self, giters, citers, n_iters=1):
        """Fetch a streaming data bundle, overlapping host assembly with
        device execution via a multi-slot prefetcher per shape."""
        from exposure_jax.utils.prefetch import AsyncPrefetcher
        if not hasattr(self, '_prefetchers'):
            self._prefetchers = {}
        key = (giters, citers, n_iters)
        if key not in self._prefetchers:
            self._prefetchers[key] = AsyncPrefetcher(
                self._assemble_stream, args=key,
                slots=int(self.cfg.get('prefetch_slots', 2)))
        return self._prefetchers[key].get_next()

    def train(self):
        """Run the training loop; set ``cfg.profile_dir`` to capture a
        jax.profiler device trace starting around iteration 20
        (TensorBoard-compatible; the reference's RunMetadata equivalent,
        net.py:310-354).

        Dispatch is SOFTWARE-PIPELINED: every chunk's bookkeeping
        (metric fetch + logging + checkpoint + viz) is deferred by
        ``cfg.dispatch_pipeline_depth`` (default 2) chunks, so the
        device->host metric fetch of chunk N overlaps the device
        execution of chunks N+1..N+depth instead of serializing with
        it.  Checkpoints/viz read the
        chunk-end state/pool references held in the pending record, so
        their artifacts are bit-identical to unpipelined execution."""
        import collections
        import concurrent.futures
        cfg = self.cfg
        profile_dir = cfg.get('profile_dir', None)
        start_t = time.time()
        books = {'g': MedianWindow(cfg.median_filter_size),
                 'v': MedianWindow(cfg.median_filter_size),
                 'emd': MedianWindow(cfg.median_filter_size),
                 'start_t': start_t, 'start_iter': int(self.state.step),
                 'timed_iters': 0, 'timed_secs': 0.0,
                 'first_skipped': False}
        base_key = jax.random.PRNGKey(cfg.get('seed', 0) + 1)
        start_iter = int(self.state.step)

        # Streaming fuses fewer iterations per dispatch than the
        # device-resident path (default 10, not 100): the host bundle
        # grows linearly with the chunk (~27 MB/iter at flagship
        # shapes), and a divisor of checkpoint_interval keeps the
        # number of distinct compiled chunk sizes small.
        n_fuse = int(cfg.get('stream_iters_per_dispatch', 10)) \
            if self.streaming else int(cfg.get('iters_per_dispatch', 1))
        depth = max(0, int(cfg.get('dispatch_pipeline_depth', 2)))
        pending = collections.deque()
        self._metrics_last = None
        self._prof_on = self._prof_done = False
        last_t = [time.time()]
        # background workers for checkpoint writes and viz: both fetch
        # large arrays to the host and must not serialize with
        # dispatch.  Separate single-worker lanes so a slow viz job
        # (first call compiles the bundle) cannot delay checkpoint
        # durability; each lane stays FIFO.
        self._bg = {
            'ckpt': concurrent.futures.ThreadPoolExecutor(max_workers=1),
            'viz': concurrent.futures.ThreadPoolExecutor(max_workers=1),
        }
        self._bg_futures = []
        # all special-iteration phase keys in ONE dispatch + fetch
        # (eager fold_in per burst costs 2 host round trips each)
        if not self.streaming:
            specials = [i for i in range(start_iter,
                                         cfg.max_iter_step + 1)
                        if is_special_iteration(i, cfg, self.supervised)]
            phase_keys = self._precompute_phase_keys(base_key, specials)
        else:
            phase_keys = {}

        def push(it0, chunk, citers, metrics):
            now = time.time()
            pending.append((it0, chunk, citers, metrics, self.state,
                            self.pool, now - last_t[0]))
            last_t[0] = now
            while len(pending) > depth:
                self._process_record(pending.popleft(), books)
            # surface background checkpoint failures promptly
            for f in list(self._bg_futures):
                if f.done():
                    self._bg_futures.remove(f)
                    f.result()

        it = start_iter
        while it <= cfg.max_iter_step:
            if profile_dir and not self._prof_on and it >= 20:
                jax.profiler.start_trace(profile_dir)
                self._prof_on = True
            if profile_dir and self._prof_on and not self._prof_done \
                    and it > 30:
                jax.profiler.stop_trace()
                self._prof_done = True

            chunk = plan_fused_chunk(it, cfg, n_fuse, self.supervised)
            if chunk > 1:
                citers = cfg.citers if not self.supervised else 0
                metrics = (self._run_fused_streaming(it, chunk, base_key)
                           if self.streaming
                           else self._run_fused(it, chunk, base_key))
                self.state = self.state.replace(step=np.int32(it + chunk))
                push(it, chunk, citers, metrics)
                it += chunk
                continue

            progress = it / cfg.max_iter_step
            if self.supervised:
                # no discriminator updates in supervised mode
                # (reference net.py:360-364)
                citers = 0
            elif cfg.gan == 'w' and (it < cfg.critic_initialization or
                                     it % 500 == 0):
                citers = cfg.get('critic_burst', 100)
            else:
                citers = cfg.citers
            giters = cfg.get('warmup_giters', 100) if it == 0 else cfg.giters
            lr_g = 0.0 if it == 0 else cfg.lr_g(it)
            lr_c = cfg.lr_c(it)

            # Device-resident mode runs each phase (normal iters, the
            # iter-0 warmup, citers bursts) as ONE dispatch of a
            # phase-sized program — a 100-update burst is one compiled
            # scan, not 20 round trips.  Streaming mode keeps the
            # cfg-sized programs and loops, bounding the per-call host
            # data bundle.  For plain iterations both paths fold RNG
            # identically (g phase sub 0, c phase sub 1 — the contract
            # the fused chunks reproduce bit-exactly).
            pk = phase_keys.get(it)
            it_key = jax.random.fold_in(base_key, it) if pk is None \
                else None

            def run(step, sub, lr_g_, phase, g_n, c_n):
                if self.streaming:
                    data = self._stream_bundle(g_n, 0) if phase == 'g' \
                        else self._stream_bundle(0, c_n)
                else:
                    data = (self.fake_images, self.real_images)
                if pk is not None and sub < 2:
                    key = pk[sub]
                else:
                    # fall back to the eager pair — correct even if a
                    # phase ever runs >2 sub-dispatches (precomputed keys
                    # cover subs 0/1 only; it_key is None when pk exists)
                    key = jax.random.fold_in(
                        it_key if it_key is not None
                        else jax.random.fold_in(base_key, it), sub)
                return step(self.state, self.pool, *data, key,
                            np.float32(lr_g_), np.float32(lr_c),
                            np.float32(progress))

            g_n = cfg.giters if self.streaming else giters
            g_step = self._get_step(g_n, 0)
            sub = 0
            for _ in range(max(giters // g_n, 1)):
                self.state, self.pool, metrics = run(g_step, sub, lr_g,
                                                     'g', g_n, 0)
                sub += 1
            if citers > 0:
                c_n = cfg.citers if self.streaming else citers
                c_step = self._get_step(0, c_n)
                c_metrics = metrics
                for _ in range(max(citers // c_n, 1)):
                    self.state, self.pool, c_metrics = run(c_step, sub,
                                                           lr_g, 'c', 0,
                                                           c_n)
                    sub += 1
                metrics = metrics._replace(
                    emd=c_metrics.emd,
                    critic_gradient_norm=c_metrics.critic_gradient_norm,
                    pool_avg_trajectory=c_metrics.pool_avg_trajectory,
                    pool_terminated_frac=c_metrics.pool_terminated_frac)
            self.state = self.state.replace(step=np.int32(it + 1))
            push(it, 1, citers, metrics)
            it += 1

        while pending:
            self._process_record(pending.popleft(), books)
        for ex in self._bg.values():
            ex.shutdown(wait=True)
        for f in self._bg_futures:
            f.result()
        self._bg = None
        # guarantee the newest checkpoint boundary reached disk (the
        # idle-worker gate above may have skipped the last boundary)
        pend = getattr(self, '_ckpt_pending', None)
        if pend is not None and \
                getattr(self, '_ckpt_saved_step', -1) < pend[1]:
            self._ckpt_requested = pend[1]
            self._save_ckpt_job(*pend)
        if profile_dir and self._prof_on and not self._prof_done:
            jax.profiler.stop_trace()
        return self._metrics_last

    def _precompute_phase_keys(self, base_key, iters):
        """(g, c) phase keys for the given iterations, computed in ONE
        jitted dispatch and fetched once as numpy — identical key math
        to the eager fold_in(fold_in(base, it), sub) pair."""
        if not iters:
            return {}
        f = jax.jit(lambda k, its: jax.vmap(lambda i: jnp.stack([
            jax.random.fold_in(jax.random.fold_in(k, i), 0),
            jax.random.fold_in(jax.random.fold_in(k, i), 1)]))(its))
        arr = np.asarray(f(base_key, np.asarray(iters, np.int32)))
        return {int(i): arr[n] for n, i in enumerate(iters)}

    def _run_fused(self, it, chunk, base_key):
        """Dispatch ``chunk`` plain iterations as one fused scan call."""
        cfg = self.cfg
        citers = 0 if self.supervised else cfg.citers
        key = ('fused', cfg.giters, citers, chunk)
        if key not in self._steps:
            from exposure_jax.core.steps import build_fused_iterations_step
            t0 = time.time()
            self._steps[key] = build_fused_iterations_step(
                cfg, self.policy, self.critic, self.value, self.filters,
                self.tx, self.mesh, self.fake_meta, self.real_meta,
                cfg.giters, citers, chunk)
            print('# compiled fused step (giters=%d, citers=%d, n=%d) '
                  'handle in %.1fs' % (cfg.giters, citers, chunk,
                                       time.time() - t0))
        # numpy args bind inside the ONE jitted dispatch; building jnp
        # arrays here would cost one eager host->device round trip each
        iters = np.arange(it, it + chunk, dtype=np.int32)
        lr_gs = np.asarray([cfg.lr_g(j) for j in iters], np.float32)
        lr_cs = np.asarray([cfg.lr_c(j) for j in iters], np.float32)
        progs = np.asarray(iters / cfg.max_iter_step, np.float32)
        self.state, self.pool, metrics = self._steps[key](
            self.state, self.pool, self.fake_images, self.real_images,
            base_key, iters, lr_gs, lr_cs, progs)
        return metrics

    def _run_fused_streaming(self, it, chunk, base_key):
        """Dispatch ``chunk`` streaming iterations as one fused scan call
        over a stacked host bundle (assembled by ONE prefetcher call, so
        the provider seed streams stay single-threaded per shape)."""
        cfg = self.cfg
        citers = 0 if self.supervised else cfg.citers
        key = ('sfused', cfg.giters, citers, chunk)
        if key not in self._steps:
            from exposure_jax.core.steps import build_streaming_fused_step
            t0 = time.time()
            self._steps[key] = build_streaming_fused_step(
                cfg, self.policy, self.critic, self.value, self.filters,
                self.tx, self.mesh, cfg.giters, citers, chunk)
            print('# compiled streaming fused step (giters=%d, citers=%d,'
                  ' n=%d) handle in %.1fs' % (cfg.giters, citers, chunk,
                                              time.time() - t0))
        g_fresh, real = self._stream_bundle(cfg.giters, citers, chunk)
        iters = np.arange(it, it + chunk, dtype=np.int32)
        lr_gs = np.asarray([cfg.lr_g(j) for j in iters], np.float32)
        lr_cs = np.asarray([cfg.lr_c(j) for j in iters], np.float32)
        progs = np.asarray(iters / cfg.max_iter_step, np.float32)
        self.state, self.pool, metrics = self._steps[key](
            self.state, self.pool, g_fresh, real, base_key, iters,
            lr_gs, lr_cs, progs)
        return metrics

    def _process_record(self, rec, books):
        """Deferred bookkeeping for one dispatched chunk: metric fetch,
        logging for every 10th iteration inside the chunk, the NaN
        guard, checkpointing and visualization — all from the chunk-end
        state/pool references captured at dispatch time, so pipelining
        never changes what gets saved or drawn."""
        it0, chunk, citers, metrics, state, pool, interval = rec
        g_pool, v_pool, emd_pool = books['g'], books['v'], books['emd']
        start_t, start_iter = books['start_t'], books['start_iter']
        cfg = self.cfg
        it_end = it0 + chunk - 1
        m = jax.device_get(metrics)
        # fused chunks stack metrics per iteration; the single path
        # yields scalars — normalize to [chunk]-indexed arrays
        from exposure_jax.core.steps import StepMetrics
        flat = StepMetrics(*[np.reshape(np.asarray(v), (-1,)) for v in m])
        self._metrics_last = StepMetrics(*[v[-1] for v in flat])
        if not all(np.isfinite(v).all() for v in flat):
            # failure detection: surface divergence immediately
            # with a diagnostic dump instead of training on NaNs
            dump = save_checkpoint(self.dir, state, it_end, keep=10)
            raise FloatingPointError(
                'non-finite training metrics in iters [%d, %d]: %s '
                '(state dumped at %s)' % (it0, it_end, m, dump))
        # amortized wall ms/it: per-chunk dispatch intervals telescope to
        # total wall time, so the cumulative ratio is honest even though
        # async dispatch makes individual intervals meaningless; the
        # first interval (compile-tainted) is excluded
        if books['first_skipped']:
            books['timed_iters'] += chunk
            books['timed_secs'] += interval
        else:
            books['first_skipped'] = True
        ms = 1000.0 * books['timed_secs'] / max(books['timed_iters'], 1)
        for j in range(it0, it_end + 1):
            if j % 10 == 0:
                i = min(j - it0, flat.g_loss.shape[0] - 1)
                warn = pool_health_warning(citers, self.supervised,
                                           flat.pool_terminated_frac[i])
                if warn:
                    print('# WARNING (it %d): %s' % (j, warn))
                g_pool.add(flat.g_loss[i])
                v_pool.add(flat.v_loss[i])
                emd_pool.add(flat.emd[i])
                print('it%6d,%5.0f ms/it, g_loss=%.2f, v_loss=%.2f, '
                      'EMD=%.3f, cgn=%.2f' %
                      (j, ms, g_pool.median(), v_pool.median(),
                       emd_pool.median(), flat.critic_gradient_norm[i]))
                self._logger.log(
                    j, g_loss=flat.g_loss[i], v_loss=flat.v_loss[i],
                    emd=flat.emd[i], cgn=flat.critic_gradient_norm[i],
                    reward=flat.reward[i],
                    pool_avg_traj=flat.pool_avg_trajectory[i],
                    pool_term_frac=flat.pool_terminated_frac[i],
                    ms_per_iter=ms)
            if j % 100 == 0:
                i = min(j - it0, flat.g_loss.shape[0] - 1)
                ela = (time.time() - start_t) / 60.0
                eta = (time.time() - start_t) / (j - start_iter + 1) / \
                    3600 * (cfg.max_iter_step - j)
                print('#--------------------------------------------')
                print('# Task: %s  ela. %.2f min  ETA: %.1f h' %
                      (cfg.name, ela, eta))
                print('# Replay pool: avg. traj. %.2f, terminated %.0f%%'
                      % (flat.pool_avg_trajectory[i],
                         100 * flat.pool_terminated_frac[i]))

        if (it_end + 1) % cfg.get('checkpoint_interval', 500) == 0:
            # checkpoint boundaries can arrive faster than one ~100 MB
            # save completes (wall-clock per 500 iters is seconds here);
            # submit only when the worker is idle — crash-recovery
            # granularity becomes one save-duration, and the newest
            # skipped boundary is guaranteed at drain time
            self._ckpt_pending = (state, it_end + 1)
            last = getattr(self, '_ckpt_future', None)
            if last is None or last.done():
                self._ckpt_requested = it_end + 1
                self._ckpt_future = self._bg_run(
                    'ckpt', self._save_ckpt_job, state, it_end + 1)
            else:
                print('# checkpoint boundary %d coalesced (save in '
                      'flight; newest boundary guaranteed at drain)'
                      % (it_end + 1))

        wii = cfg.get('write_image_interval', 0)
        if wii and any(j % wii == 0 for j in range(it0, it_end + 1)):
            # provider batches are fetched HERE (main thread): providers
            # mutate unsynchronized state (epoch indices, global RNG) and
            # in streaming mode the prefetcher threads call them too —
            # only the device work belongs on the background lane
            raw, real_imgs = self._viz_batches()
            self._bg_run('viz', self._viz_job, it_end, state, pool,
                         raw, real_imgs)

    def _viz_batches(self):
        n = min(self.cfg.num_samples, 16)
        raw, _ = self.fake_provider.get_next_batch(n)
        if self.supervised:
            raw = raw[:, 0]
        real_imgs, _ = self.real_provider.get_next_batch(n)
        return raw, real_imgs

    def _save_ckpt_job(self, state, step):
        # coalesce: when the worker falls behind, only the NEWEST
        # requested checkpoint matters (keep-N pruning discards older
        # ones anyway); each save fetches ~100 MB to the host, so
        # writing a stale backlog serially would stall the drain
        if getattr(self, '_ckpt_requested', step) > step:
            print('# checkpoint %d skipped (newer boundary %d requested)'
                  % (step, self._ckpt_requested))
            return
        # keep=2: metrics can stay finite for the iteration whose UPDATE
        # diverges, so the newest boundary save may hold non-finite
        # params before the (pipelined) NaN guard raises — keeping the
        # previous boundary guarantees a known-good restore point
        path = save_checkpoint(self.dir, state, step, keep=2)
        self._ckpt_saved_step = step
        print('# checkpoint saved:', path)

    def _viz_job(self, it, state, pool, raw=None, real_imgs=None):
        try:
            self.visualize(it, state=state, pool=pool, raw=raw,
                           real_imgs=real_imgs)
        except Exception as e:  # viz must never kill training
            print('# visualization failed:', e)

    def _bg_run(self, lane, fn, *args):
        """Run a bookkeeping job on the named background lane
        (checkpoint writes and viz each fetch MBs to the host; they
        must not serialize with dispatch).  Falls back to
        synchronous execution outside a train() loop.  Returns the
        future (or None when run synchronously)."""
        bg = getattr(self, '_bg', None)
        if bg is None:
            fn(*args)
            return None
        fut = bg[lane].submit(fn, *args)
        self._bg_futures.append(fut)
        return fut

    # ------------------------------------------------------------------
    def restore(self, ckpt=None):
        self.state, step = restore_checkpoint(self.dir, self.state, ckpt)
        print('# restored checkpoint at step', step)
        return step

    def latest_checkpoint(self):
        return latest_checkpoint_step(self.dir)

    # ------------------------------------------------------------------
    def run_rollout(self, images, key=None, is_train=None, num_steps=None,
                    state=None):
        """Jitted K-step rollout with the current policy weights."""
        cfg = self.cfg
        if key is None:
            key = jax.random.PRNGKey(0)
        if is_train is None:
            is_train = cfg.test_random_walk
        if state is None:
            state = self.state
        if self._rollout_fn is None:
            self._rollout_fn = jax.jit(
                lambda params, imgs, k, it: rollout(
                    self.policy, params, imgs, k, cfg=cfg,
                    filters=self.filters, is_train=it,
                    num_steps=num_steps or cfg.test_steps))
        return self._rollout_fn(state.gen_params, jnp.asarray(images),
                                key, jnp.int32(int(is_train)))

    def critic_scores(self, images, state=None):
        """Centered critic scores for a host batch (reference
        centered_fake_logit, net.py:166-168)."""
        if state is None:
            state = self.state
        if self._score_fn is None:
            self._score_fn = jax.jit(
                lambda p, x: self.critic.apply(p, x)[:, 0])
        logits = self._score_fn(state.crit_params, jnp.asarray(images))
        return np.asarray(logits) - float(state.ema.value)

    def state_values(self, images, states, state=None):
        """V(s) for host batches (reference new_value, net.py:76-97)."""
        if state is None:
            state = self.state
        if getattr(self, '_value_fn', None) is None:
            self._value_fn = jax.jit(
                lambda p, x, s: self.value.apply(p, x, s)[:, 0])
        return np.asarray(self._value_fn(state.val_params,
                                         jnp.asarray(images),
                                         jnp.asarray(states)))

    def critic_gradients(self, images, state=None):
        """Per-pixel d(critic logit)/d(image), display-scaled (reference
        fake_gradients net.py:169-171 + gradient_processor net.py:409-418:
        10*grads + 0.5 for WGAN)."""
        if state is None:
            state = self.state
        if getattr(self, '_grad_fn', None) is None:
            self._grad_fn = jax.jit(jax.grad(
                lambda x, p: jnp.sum(self.critic.apply(p, x))))
        grads = self._grad_fn(jnp.asarray(images), state.crit_params)
        return np.clip(10.0 * np.asarray(grads) + 0.5, 0, 1)

    def _viz_bundle(self):
        """One jitted function computing EVERYTHING the visualization
        grid needs on-device (rollout, critic gradient images, scores,
        state values) so a viz event costs ONE dispatch + ONE fetch
        instead of ~10 host round trips."""
        if getattr(self, '_viz_fn', None) is None:
            cfg = self.cfg

            def fn(state, pool_images, raw, real, key):
                traj = rollout(self.policy, state.gen_params, raw, key,
                               cfg=cfg, filters=self.filters,
                               is_train=jnp.int32(
                                   int(cfg.test_random_walk)),
                               num_steps=cfg.test_steps)
                steps = traj.images  # [K, n, S, S, C]
                k, n = steps.shape[0], steps.shape[1]
                flat = steps.reshape((-1,) + steps.shape[2:])

                def score(x):
                    return (self.critic.apply(state.crit_params, x)[:, 0]
                            - state.ema.value)

                grads = jax.grad(lambda x: jnp.sum(
                    self.critic.apply(state.crit_params, x)))(flat)
                grads = jnp.clip(10.0 * grads + 0.5, 0, 1).reshape(
                    steps.shape)
                flat_states = traj.states.reshape(-1, cfg.num_state_dim)
                values = self.value.apply(
                    state.val_params, flat, flat_states)[:, 0].reshape(
                        (k, n))
                return dict(
                    traj=traj, grad_imgs=grads,
                    scores=score(flat).reshape((k, n)),
                    values=values, in_scores=score(raw),
                    pool_images=pool_images,
                    pool_scores=score(pool_images),
                    final_scores=score(steps[-1]),
                    real_scores=score(real))

            self._viz_fn = jax.jit(fn)
        return self._viz_fn

    def visualize(self, it, state=None, pool=None, raw=None,
                  real_imgs=None):
        """Write the periodic visualization grid (reference
        net.py:420-552): rollout trajectories with per-step
        decision/operation panels on top; pool / generated / real sample
        grids with critic-score stamps below.

        ``state``/``pool`` default to the Trainer's current ones; the
        pipelined train loop passes the chunk-end references so deferred
        visualization is identical to unpipelined execution."""
        from exposure_jax.utils.viz import (
            draw_score,
            draw_step_panels,
        )
        cfg = self.cfg
        if state is None:
            state = self.state
        if pool is None:
            pool = self.pool
        n = min(cfg.num_samples, 16)
        if raw is None or real_imgs is None:
            raw, real_imgs = self._viz_batches()
        pool_imgs_dev = pool.images[:n]
        # ALL device work for the grid happens in ONE jitted call with
        # ONE device->host fetch
        bundle = jax.device_get(self._viz_bundle()(
            state, pool_imgs_dev, jnp.asarray(raw),
            jnp.asarray(real_imgs), jax.random.PRNGKey(it)))
        traj = bundle['traj']
        steps = np.asarray(traj.images)  # [K, n, S, S, C]
        k_steps = steps.shape[0]
        grad_imgs = bundle['grad_imgs']
        scores = bundle['scores']
        values = bundle['values']
        in_scores = bundle['in_scores']

        from exposure_jax.utils.viz import draw_value_reward_score

        rows = []
        for b in range(min(n, 4)):
            img_row = [np.asarray(raw[b])]
            for k in range(k_steps):
                prev = in_scores[b] if k == 0 else scores[k - 1, b]
                reward = (scores[k, b] - prev) * \
                    cfg.critic_logit_multiplier
                img_row.append(draw_value_reward_score(
                    steps[k, b], values[k, b], reward, scores[k, b],
                    cfg.gan))
            blank = np.ones_like(img_row[0])
            grad_row = [blank] + [grad_imgs[k, b] for k in range(k_steps)]
            dec_row, op_row = [blank], [blank]
            mask_row = [blank] if cfg.masking else None
            for k in range(k_steps):
                dbg = {'pdf': np.asarray(traj.pdfs[k, b]),
                       'filter_id': int(traj.filter_ids[k, b]),
                       'filter_parameters':
                           np.asarray(traj.params[k, b])}
                nparam = self.filters[dbg['filter_id']] \
                    .get_num_filter_parameters()
                dbg['filter_parameters'] = dbg['filter_parameters'][:nparam]
                dec, op = draw_step_panels(self.filters, dbg,
                                           size=img_row[0].shape[0])
                dec_row.append(dec)
                op_row.append(op)
                if mask_row is not None:
                    from exposure_jax.utils.viz import draw_mask_panel
                    step_input = np.asarray(raw[b]) if k == 0 \
                        else steps[k - 1, b]
                    mask_row.append(draw_mask_panel(
                        self.filters[dbg['filter_id']], step_input,
                        np.asarray(traj.mask_params[k, b])))

            def hcat(row):
                return np.hstack([np.pad(r, ((1, 1), (1, 1), (0, 0)),
                                         constant_values=1.0) for r in row])
            panel_rows = [hcat(img_row), hcat(grad_row), hcat(dec_row),
                          hcat(op_row)]
            if mask_row is not None:
                panel_rows.append(hcat(mask_row))
            rows.append(np.vstack(panel_rows))
        upper = np.vstack(rows)

        pool_imgs = np.asarray(bundle['pool_images'])
        final = steps[-1]
        per_row = 8

        def grid(x, x_scores):
            x = np.asarray(x)[:per_row * (len(x) // per_row)]
            if len(x) == 0:
                return None
            if cfg.vis_draw_critic_scores:
                x = np.stack([draw_score(im, s, cfg.gan)
                              for im, s in zip(x, x_scores)])
            return make_image_grid(x, per_row=per_row)

        lowers = [g for g in (grid(pool_imgs, bundle['pool_scores']),
                              grid(final, bundle['final_scores']),
                              grid(real_imgs, bundle['real_scores']))
                  if g is not None]
        lower = np.vstack(lowers)
        w = max(upper.shape[1], lower.shape[1])

        def padw(x):
            return np.pad(x, ((0, 0), (0, w - x.shape[1]), (0, 0)),
                          constant_values=1.0)
        img = np.vstack([padw(upper), np.ones((8, w, 3), np.float32),
                         padw(lower)])
        write_image(os.path.join(self.image_dir, '%06d.png' % it),
                    np.clip(img, 0, 1))
        if cfg.get('realtime_vis', False):
            _show_realtime(img, 'exposure_jax: ' + cfg.name)
