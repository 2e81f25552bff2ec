"""Tests for the offline tools: histogram-intersection metric, user-study
session, and the TikZ exporter."""

import json
import os
import pickle

import numpy as np
import pytest

from exposure_jax.tools.histogram_intersection import (
    calc_hist,
    get_statistics,
    hist_intersection,
)
from exposure_jax.tools.user_study import RetouchSession, all_filters
from exposure_jax.tools.user_study.session import NUM_STEPS


class TestHistogramIntersection:
    def test_identical_distributions_are_100pct(self, rng):
        vals = rng.rand(500)
        h = calc_hist(vals)
        assert hist_intersection(h, h) == pytest.approx(1.0)

    def test_disjoint_distributions_are_0pct(self):
        a = calc_hist(np.full(100, 0.1))
        b = calc_hist(np.full(100, 0.9))
        assert hist_intersection(a, b) == pytest.approx(0.0)

    def test_statistics_oracle(self, rng):
        img = rng.rand(64, 64, 3).astype(np.float32)
        lum_mean, contrast, sat = get_statistics(img)
        lum = (img[..., 0] * 0.27 + img[..., 1] * 0.67 + img[..., 2] * 0.06)
        assert lum_mean == pytest.approx(lum.mean(), abs=1e-5)
        assert contrast == pytest.approx(2 * lum.std(), abs=1e-5)
        assert 0 <= sat <= 1


class TestUserStudy:
    def test_default_chain_structure(self, rng):
        img = rng.rand(32, 32, 3).astype(np.float32)
        s = RetouchSession(img, 'tester', 'img0')
        out = s.recalculate()
        assert out.shape == img.shape
        assert np.isfinite(out).all()
        assert len(s.action_sequence()) == NUM_STEPS

    def test_exposure_step(self, rng):
        img = (rng.rand(16, 16, 3) * 0.3).astype(np.float32)
        s = RetouchSession(img, 't', 'i')
        s.set_step_filter(0, 0)  # Exposure
        s.set_parameters(0, [60])  # 0.6 -> EV +1
        out = s.recalculate(upto=1)
        np.testing.assert_allclose(out, np.clip(img * 2.0, 0, 1), rtol=1e-5)

    def test_save_writes_image_and_json(self, rng, tmp_path):
        img = rng.rand(16, 16, 3).astype(np.float32)
        s = RetouchSession(img, 'tester', 'img0')
        img_path, json_path = s.save(str(tmp_path))
        assert os.path.exists(img_path)
        with open(json_path) as f:
            data = json.load(f)
        assert data['user'] == 'tester'
        assert len(data['actions']) == NUM_STEPS
        for a in data['actions']:
            assert 0 <= a['filter_id'] < len(all_filters)

    def test_tone_spline_is_monotone_defaults(self):
        from exposure_jax.tools.user_study.filters import ToneFilter
        f = ToneFilter()
        x = np.linspace(0, 1, 64).astype(np.float32)[:, None, None]
        y = f.apply(np.concatenate([x] * 3, axis=2))
        assert (np.diff(y[:, 0, 0]) >= -1e-6).all()
        np.testing.assert_allclose(y[:, 0, 0], x[:, 0, 0], atol=1e-5)


class TestPickleToTex:
    def test_convert(self, tmp_path):
        from exposure_jax.tools.pickle_to_tex import convert
        debug = [{
            'step': 0, 'filter_id': 1, 'short_name': 'T',
            'filter_parameters': np.linspace(0.5, 2, 8),
            'pdf': np.full(8, 1 / 8.0), 'applied': True,
        }, {
            'step': 1, 'filter_id': 2, 'short_name': 'W',
            'filter_parameters': np.asarray([1.0, 0.9, 1.1]),
            'pdf': np.full(8, 1 / 8.0), 'applied': True,
        }]
        pkl = str(tmp_path / 'x_debug.pkl')
        with open(pkl, 'wb') as f:
            pickle.dump(debug, f)
        out = convert(pkl)
        text = open(out).read()
        assert r'\begin{tikzpicture}' in text
        assert 'Step 1' in text and 'Step 2' in text


class TestQtShell:
    """Smoke-run the PyQt5 shell (tools/user_study/main.py) against a
    stubbed Qt: builds the window, loads an image, wires up tabs/sliders
    and renders a preview through the real RetouchSession — catching any
    shell-level typo without a display or PyQt5 (reference
    user_study_ui/main.py:314-322)."""

    def test_run_qt_with_stubbed_pyqt5(self, rng, tmp_path, monkeypatch):
        import sys
        import types
        from unittest import mock

        class _Widget:
            def __init__(self, *a, **k):
                pass

            def __getattr__(self, name):
                return mock.MagicMock()

        qtcore = types.ModuleType('PyQt5.QtCore')
        qtcore.Qt = mock.MagicMock()
        qtgui = types.ModuleType('PyQt5.QtGui')
        qtgui.QImage = mock.MagicMock()
        qtgui.QPixmap = mock.MagicMock()
        qtw = types.ModuleType('PyQt5.QtWidgets')
        qtw.QWidget = _Widget
        for name in ('QApplication', 'QComboBox', 'QGridLayout', 'QLabel',
                     'QPushButton', 'QSlider', 'QTabWidget', 'QVBoxLayout'):
            setattr(qtw, name, mock.MagicMock())
        pyqt5 = types.ModuleType('PyQt5')
        pyqt5.QtCore = qtcore
        pyqt5.QtGui = qtgui
        pyqt5.QtWidgets = qtw
        for modname, mod in (('PyQt5', pyqt5), ('PyQt5.QtCore', qtcore),
                             ('PyQt5.QtGui', qtgui),
                             ('PyQt5.QtWidgets', qtw)):
            monkeypatch.setitem(sys.modules, modname, mod)

        np.save(str(tmp_path / 'study0.npy'),
                rng.rand(16, 16, 3).astype(np.float32))
        from exposure_jax.tools.user_study.main import run_qt
        run_qt(str(tmp_path), 'tester')


class TestValidateParity:
    def test_summarize(self):
        from exposure_jax.tools.validate_parity import summarize
        runs = [
            {'quality': {'intersection_before': [0.0, 0.0, 0.0],
                         'intersection_after': [0.7, 0.2, 0.3],
                         'avg_before': 0.0, 'avg_after': 0.4}},
            {'quality': {'intersection_before': [0.0, 0.0, 0.0],
                         'intersection_after': [0.8, 0.4, 0.5],
                         'avg_before': 0.0, 'avg_after': 0.5667}},
        ]
        s = summarize(runs)
        assert s['seeds'] == 2
        assert s['intersection_after']['luminance']['mean'] == \
            pytest.approx(0.75)
        assert s['intersection_after']['contrast']['std'] == \
            pytest.approx(0.1)
        assert s['avg_after_mean'] == pytest.approx(0.4834, abs=1e-3)


class TestProbeCriticFamily:
    def test_probe_two_runs(self, tmp_path, monkeypatch):
        import json
        import sys

        from exposure_jax.core.checkpoint import save_checkpoint
        from exposure_jax.core.trainer import (
            build_models,
            init_train_state,
        )
        from exposure_jax.utils import load_config

        cfg = load_config('test')
        filters, policy, critic, value = build_models(cfg)
        state, _ = init_train_state(cfg, policy, critic, value, 0)
        for run in ('run_a', 'run_b'):
            save_checkpoint(str(tmp_path / 'test' / run), state, 1)

        from exposure_jax.tools import probe_critic_family as pcf
        out = tmp_path / 'probe.json'
        monkeypatch.setattr(sys, 'argv', [
            'prog', '--runs', 'test/run_a', 'test/run_b',
            '--n', '4', '--model-root', str(tmp_path),
            '--out', str(out)])
        pcf.main()
        d = json.loads(out.read_text())
        m = d['critic_score_matrix']
        assert set(m) == {'critic:test/run_a', 'critic:test/run_b'}
        row = m['critic:test/run_a']
        assert {'targets', 'inputs', 'out:test/run_a',
                'out:test/run_b'} <= set(row)
        # identical checkpoints -> identical outputs -> identical scores
        assert row['out:test/run_a'] == row['out:test/run_b']
        assert d['patch_profiles']['targets']['flat_frac'] is not None
        assert sorted(d['consensus_ranking']) == \
            sorted(['out:test/run_a', 'out:test/run_b'])


class TestSelectPolicy:
    def test_consensus_ranking_math(self):
        from exposure_jax.tools.probe_critic_family import consensus_ranking

        names = ['out:a', 'out:b', 'out:c']
        matrix = {
            # critic 1: b > a > c ; critic 2: b > c > a ; critic 3: b > a > c
            'c1': {'out:a': {'mean': 0.5}, 'out:b': {'mean': 1.0},
                   'out:c': {'mean': 0.1}},
            'c2': {'out:a': {'mean': -1.0}, 'out:b': {'mean': 2.0},
                   'out:c': {'mean': 0.0}},
            'c3': {'out:a': {'mean': 3.0}, 'out:b': {'mean': 4.0},
                   'out:c': {'mean': 2.0}},
        }
        ranking, mean_rank = consensus_ranking(matrix, names)
        assert ranking[0] == 'out:b'
        assert ranking[-1] == 'out:c'
        assert mean_rank['out:b'] == pytest.approx(1.0)
        assert mean_rank['out:a'] == pytest.approx((2 + 3 + 2) / 3)

    def test_family_separation_statistic(self):
        from exposure_jax.tools.probe_critic_family import (
            ABSTAIN_THRESHOLD,
            family_separation,
        )

        names = ['out:a', 'out:b']
        # family-split regime: output spread is a large fraction of the
        # critic's own output-vs-input gap (CRITIC_PROBE.json shape)
        split = {
            'c1': {'inputs': {'mean': -7.0}, 'out:a': {'mean': 12.0},
                   'out:b': {'mean': 16.0}},
            'c2': {'inputs': {'mean': -41.0}, 'out:a': {'mean': -19.0},
                   'out:b': {'mean': -14.0}},
            'c3': {'inputs': {'mean': 0.0}, 'out:a': {'mean': 20.0},
                   'out:b': {'mean': 25.0}},
        }
        sep, per = family_separation(split, names)
        assert sep > ABSTAIN_THRESHOLD
        assert set(per) == {'c1', 'c2', 'c3'}
        # within-family regime: residual preferences are tiny relative
        # to the same gap (SELECT.json round-3 shape) -> abstain
        tight = {
            'c1': {'inputs': {'mean': -40.0}, 'out:a': {'mean': -14.9},
                   'out:b': {'mean': -14.8}},
            'c2': {'inputs': {'mean': -30.0}, 'out:a': {'mean': -2.9},
                   'out:b': {'mean': -2.8}},
            'c3': {'inputs': {'mean': -25.0}, 'out:a': {'mean': 0.0},
                   'out:b': {'mean': 0.6}},
        }
        sep2, _ = family_separation(tight, names)
        assert sep2 < ABSTAIN_THRESHOLD
        # median over critics: one noisy critic cannot flip the verdict
        tight['c3']['out:b']['mean'] = 20.0
        sep3, _ = family_separation(tight, names)
        assert sep3 < ABSTAIN_THRESHOLD
        # no anchor column -> no statistic (callers keep the old path)
        sep4, per4 = family_separation(
            {'c1': {'out:a': {'mean': 0.0}, 'out:b': {'mean': 1.0}}},
            names)
        assert sep4 is None and per4 == {}

    def test_select_end_to_end_with_promote(self, tmp_path, monkeypatch):
        import sys

        from exposure_jax.core.checkpoint import save_checkpoint
        from exposure_jax.core.trainer import build_models, init_train_state
        from exposure_jax.utils import load_config

        cfg = load_config('test')
        filters, policy, critic, value = build_models(cfg)
        state, _ = init_train_state(cfg, policy, critic, value, 0)
        for run in ('seed0', 'seed1'):
            save_checkpoint(str(tmp_path / 'test' / run), state, 1)

        truth = tmp_path / 'parity.json'
        truth.write_text(json.dumps({'runs': [
            {'run': 'test/seed0', 'quality': {'avg_after': 0.4}},
            {'run': 'test/seed1', 'quality': {'avg_after': 0.6}},
        ]}))

        from exposure_jax.tools import select_policy as sp
        out = tmp_path / 'select.json'
        # identical checkpoints -> identical outputs -> ZERO family
        # separation: consensus ABSTAINS and promotion falls back to
        # the comp2 within-family discriminant (round 5, SELECT_R5.json)
        monkeypatch.setattr(sys, 'argv', [
            'prog', '--config', 'test', '--runs', 'seed0', 'seed1',
            '--n', '4', '--model-root', str(tmp_path),
            '--out', str(out), '--promote', 'best',
            '--truth', str(truth)])
        sp.main()
        d = json.loads(out.read_text())
        assert d['verdict'] == 'abstain'
        assert d['family_separation'] < d['abstain_threshold']
        # comp2 fallback declares a winner (from the pool) + records
        # its signals; promotion went through
        assert d['winner_by'] == 'comp2'
        assert d['winner'] in ('seed0', 'seed1')
        assert d['comp2']['ranking'][0] == d['winner']
        assert set(d['comp2']['ct_usage']) == {'seed0', 'seed1'}
        link = tmp_path / 'test' / 'best'
        assert link.is_symlink()
        assert os.readlink(link) == d['winner']
        # the declared truth winner rides along for the truth path
        assert d['truth_winner'] == 'seed1'
        assert d['spearman_vs_truth'] == pytest.approx(-1.0)

        # --promote-by truth works on an abstained pool: it promotes by
        # measured quality, which abstention does not gate
        monkeypatch.setattr(sys, 'argv', [
            'prog', '--config', 'test', '--runs', 'seed0', 'seed1',
            '--n', '4', '--model-root', str(tmp_path),
            '--out', str(out), '--promote', 'best',
            '--truth', str(truth), '--promote-by', 'truth'])
        sp.main()
        link = tmp_path / 'test' / 'best'
        assert link.is_symlink()
        assert os.readlink(link) == 'seed1'
        # promoted run restores through the symlink like a normal run
        from exposure_jax.core.evaluator import Evaluator
        cfg2 = load_config('test')
        cfg2.name = 'test/best'
        Evaluator(cfg2, model_root=str(tmp_path))


class TestValidateSelector:
    def test_rank_stats_and_comp2(self, tmp_path, monkeypatch):
        """The retrospective selector validator: scipy-free rank stats
        plus the shipped comp2 composite on a synthetic pool where
        final_emd alone mispicks (the inject2 seed-4 failure mode) and
        Ct-usage rescues it."""
        import sys

        from exposure_jax.tools import validate_selector as vs

        np.testing.assert_array_equal(
            vs.rankdata([3.0, 1.0, 2.0]), [3.0, 1.0, 2.0])
        np.testing.assert_array_equal(
            vs.rankdata([1.0, 1.0, 2.0]), [1.5, 1.5, 3.0])
        assert vs.spearman([1, 2, 3], [10, 20, 30]) == pytest.approx(1.0)
        assert vs.spearman([1, 2, 3], [3, 2, 1]) == pytest.approx(-1.0)

        def rec(seed, q, emd, ct):
            return {'seed': seed, 'final_emd': emd, 'final_g_loss': -0.8,
                    'quality': {'avg_after': q},
                    'trajectories': {'filter_usage': {'Ct': ct},
                                     'distinct_sequences_frac': 0.02}}

        # seed2 is best; seed0 has the LOWEST emd but Ct-everywhere
        # lock-in (the measured failure mode comp2 exists to catch)
        runs = [rec(0, 0.55, 20.0, 250), rec(1, 0.60, 23.0, 240),
                rec(2, 0.72, 21.0, 120)]
        pool = tmp_path / 'PARITY_FAKE.json'
        pool.write_text(json.dumps({'runs': runs}))
        out = tmp_path / 'SELECT_T.json'
        monkeypatch.setattr(sys, 'argv', [
            'prog', '--pools', str(pool), '--min-n', '3',
            '--out', str(out)])
        vs.main()
        d = json.loads(out.read_text())
        sel = d['pools'][str(pool)]['selectors']
        assert sel['neg_emd']['picked_seed'] == 0      # emd alone fails
        assert sel['comp2']['picked_seed'] == 2        # comp2 rescues
        assert sel['comp2']['regret'] == 0.0
        assert d['shipped'] == 'comp2'

    def test_comp2_scores_in_select_policy(self):
        from exposure_jax.tools.select_policy import comp2_scores

        runs = ['a', 'b', 'c']
        scores = comp2_scores(runs, ct_usage={'a': 250, 'b': 120,
                                              'c': 200},
                              final_emd={'a': 20.0, 'b': 21.0,
                                         'c': 25.0})
        # b: best Ct rank (1) + mid emd rank (2) -> best mean rank
        assert max(scores, key=scores.get) == 'b'
        # c: worst on both -> worst
        assert min(scores, key=scores.get) == 'c'


class TestEditSequence:
    def test_edit_scale_and_drop(self, tmp_path):
        """One-command white-box edit: halve a recorded exposure boost,
        replay, and check the output dims accordingly (reference
        net.py:841-877 step export is the artifact this edits)."""
        from exposure_jax.core.trainer import build_models
        from exposure_jax.tools import edit_sequence as es
        from exposure_jax.utils import load_config
        from exposure_jax.utils.image_io import read_image, write_image

        cfg = load_config('test')
        filters, _, _, _ = build_models(cfg)
        fid = next(i for i, f in enumerate(filters)
                   if type(f).__name__ == 'ExposureFilter')
        names = [f.get_short_name() for f in filters]
        debug = [
            {'step': 0, 'filter_id': fid, 'short_name': names[fid],
             'all_short_names': names,
             'filter_parameters': np.asarray([2.0], np.float32),
             'mask_parameters': np.zeros((0,), np.float32),
             'pdf': np.zeros((len(filters),), np.float32),
             'applied': True},
            # no mask_parameters key: unmasked runs' pickles omit it
            {'step': 1, 'filter_id': fid, 'short_name': names[fid],
             'all_short_names': names,
             'filter_parameters': np.asarray([0.5], np.float32),
             'pdf': np.zeros((len(filters),), np.float32),
             'applied': False},
        ]
        dbg = tmp_path / 'img_debug.pkl'
        with open(dbg, 'wb') as f:
            pickle.dump(debug, f)
        img = tmp_path / 'img.png'
        rng = np.random.RandomState(0)
        write_image(str(img), rng.rand(24, 32, 3) * 0.5 + 0.2)

        out = tmp_path / 'edit'
        es.main(['--config', 'test', '--debug', str(dbg),
                 '--image', str(img), '--step', '0', '--scale', '0.5',
                 '--out-dir', str(out)])
        before = read_image(str(out / 'before.png'))
        after = read_image(str(out / 'after.png'))
        # exposure 2 stops -> 1 stop: strictly dimmer, not identical
        assert after.mean() < before.mean()
        assert np.abs(after - before).max() > 0.01
        rec = json.loads((out / 'edit.json').read_text())
        assert rec['edit'] == 'scale 0.5'
        assert rec['params_before'] == [2.0]
        assert rec['params_after'] == [1.0]
        assert len(rec['sequence']) == 2
        assert rec['sequence'][1]['applied'] is False

        # --drop skips the step entirely: output equals the identity
        # replay of the (inactive) rest of the sequence
        out2 = tmp_path / 'edit2'
        es.main(['--config', 'test', '--debug', str(dbg),
                 '--image', str(img), '--step', '0', '--drop',
                 '--out-dir', str(out2)])
        after2 = read_image(str(out2 / 'after.png'))
        lin = es.load_debug(dbg)  # sanity: tool did not mutate the pkl
        assert lin[0]['applied'] is True
        from exposure_jax.core.evaluator import load_linear_image
        ident = np.clip(load_linear_image(str(img)), 0, 1)
        assert np.abs(after2 - ident).max() < 2.5 / 255
