"""Unsupervised model selection by critic consensus.

The round-3 quality campaigns established (CRITIC_PROBE.json,
CRITIC_PROBE_EXPLORE.json) that ranking N trained seeds by the MEAN
RANK their outputs receive across all N runs' critics reproduces the
ground-truth histogram-intersection quality ordering exactly within a
same-config pool (Spearman 1.0; ~0.76 across mixed configs) — i.e. the
WGAN critics collectively already know which policy is best, even
though no single run's reward told its generator so.  That turns the
"train N seeds, keep the best" workflow into a fully unsupervised one:
no retouched targets are needed at selection time, only the candidate
checkpoints themselves.

SCOPE (measured, round 3): the consensus signal separates POLICY
FAMILIES — it reliably flags seeds locked into the inferior
Ct-everywhere optimum (the variance mode that motivated it).  On a
post-exploration-fix pool where all seeds land in the SAME high-quality
family, the fine within-family ordering is NOT recovered
(SELECT.json on the `synthetic_explore` campaign: Spearman −0.70 vs
measured quality; the critics' residual preferences no longer track
the histogram metric once the family gap is gone).  Use consensus to
reject locked-in seeds; use ``--truth`` + ``--promote-by truth`` when
a target set exists and candidates are within one family.

ABSTAIN (round 4): the tool now DETECTS which regime a pool is in
without targets — the median per-critic output spread relative to each
critic's own output-vs-raw-inputs gap
(``probe_critic_family.family_separation``; ~0.20 on the recorded
family-split pool vs ~20x smaller within one family).  Below
``ABSTAIN_THRESHOLD`` the verdict is ``abstain``: consensus declares no
winner.

COMP2 FALLBACK (round 5): when consensus abstains, the tool falls back
to the ``comp2`` target-free WITHIN-family discriminant — the rank-mean
of (-final_emd, -Ct-usage), validated retrospectively on 9 recorded
campaign pools and prospectively (pre-registered) on a fresh
inject15 5-seed pool (SELECT_R5.json; tools/validate_selector.py):
Spearman >=0.6 on 5/9 pools and regret 0.000/0.000/0.003 on the three
injection-family pools the shipped reliability workflow produces.  Both
signals are free at selection time: ``final_emd`` is the critic's
real/fake Wasserstein gap from the run's own metrics.jsonl, and
Ct-usage is counted from the trajectories this tool already plans on
the held-out inputs.  ``--promote`` therefore always has a target-free
winner: consensus when the pool splits by family, comp2 within one.

This tool runs that selection end-to-end:

1. restore every candidate run's full train state;
2. retouch the SAME held-out inputs with each policy (critic-native
   64 px resolution);
3. score every candidate's outputs with every candidate's critic;
4. rank by consensus (``probe_critic_family.consensus_ranking``) and
   report the winner; ``--promote NAME`` symlinks
   ``models/<config>/NAME`` at the winning run so downstream CLIs
   (evaluate.py, bench.py --run) can address it stably.

Usage:
  python -m exposure_jax.tools.select_policy \
      --config synthetic_explore --runs parity-seed0 parity-seed1 ... \
      [--n 256] [--out SELECT.json] [--promote best]

Reference anchor: the reference ships ONE pretrained model per config
chosen by its authors with held-out targets (README.md "pretrained
models"); this tool produces that artifact without targets, using the
critics the training run already paid for.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from exposure_jax.core.evaluator import Evaluator
from exposure_jax.tools.probe_critic_family import (
    ABSTAIN_THRESHOLD,
    consensus_ranking,
    family_separation,
)
from exposure_jax.tools.validate_selector import rankdata
from exposure_jax.utils.config import load_config


def comp2_scores(runs, ct_usage, final_emd):
    """Rank-mean of (-final_emd, -Ct-usage); higher = pick first.

    The shipped within-family selector (SELECT_R5.json): the two
    components fail on DISJOINT pools (emd tracks convergence quality,
    Ct-usage the Ct-everywhere lock-in), so the rank-mean covers both.
    """
    n = len(runs)
    mean = np.zeros(n)
    for sig in (np.array([-final_emd[r] for r in runs]),
                np.array([-float(ct_usage[r]) for r in runs])):
        mean += (n + 1) - rankdata(sig)  # rank 1 = best
    return {r: -float(mean[i]) / 2.0 for i, r in enumerate(runs)}


def score_matrix(runs, evs, outputs):
    """Every run's critic on every run's outputs -> nested mean/std."""
    matrix = {}
    for run, ev in zip(runs, evs):
        score = jax.jit(lambda p, x, critic=ev.critic: critic.apply(p, x))
        row = {}
        for name, imgs in outputs.items():
            logits = np.asarray(score(ev.state.crit_params,
                                      jnp.asarray(imgs)))
            row[name] = {'mean': round(float(logits.mean()), 4),
                         'std': round(float(logits.std()), 4)}
        matrix['critic:' + run] = row
    return matrix


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', required=True)
    ap.add_argument('--runs', nargs='+', required=True,
                    help='run names under models/<config>/')
    ap.add_argument('--n', type=int, default=256)
    ap.add_argument('--model-root', default='models')
    ap.add_argument('--out', default='SELECT.json')
    ap.add_argument('--promote', default=None,
                    help='symlink models/<config>/<PROMOTE> -> winner')
    ap.add_argument('--truth', default=None,
                    help='a validate_parity JSON covering the same runs: '
                         'cross-check the consensus ranking against the '
                         'measured quality ordering (Spearman)')
    ap.add_argument('--promote-by', choices=('consensus', 'truth', 'comp2'),
                    default='consensus',
                    help='which winner --promote points at (truth '
                         'requires --truth; consensus falls back to '
                         'comp2 automatically on abstain; comp2 forces '
                         'the within-family discriminant)')
    args = ap.parse_args()
    if args.promote_by == 'truth' and not args.truth:
        ap.error('--promote-by truth requires --truth')

    cfg0 = load_config(args.config)
    inputs, _ = cfg0.fake_data_provider_test().get_next_batch(args.n)
    inputs = np.clip(inputs, 0.0, 1.0).astype(np.float32)

    # the raw inputs are the anchor for the abstain statistic: each
    # critic's output-vs-input gap calibrates the scale of its
    # preferences (family_separation docstring)
    evs, outputs = [], {'inputs': inputs}
    ct_usage, final_emd = {}, {}
    for run in args.runs:
        cfg = load_config(args.config)
        cfg.name = '%s/%s' % (args.config, run)
        ev = Evaluator(cfg, model_root=args.model_root)
        traj, _ = ev.plan_trajectory(inputs, jax.random.PRNGKey(0))
        outputs['out:' + run] = np.clip(ev.retouch(inputs, traj), 0.0, 1.0)
        evs.append(ev)
        # comp2 signals (free at selection time): Ct usage on the
        # held-out plan, final critic EMD from the run's own metrics
        ids = np.asarray(traj.filter_ids)
        active = np.asarray(ev.active_mask(traj)) > 0
        short = [f.get_short_name() for f in ev.filters]
        ct = short.index('Ct') if 'Ct' in short else None
        ct_usage[run] = (int(((ids == ct) & active).sum())
                         if ct is not None else 0)
        mpath = os.path.join(args.model_root, cfg.name, 'metrics.jsonl')
        final_emd[run] = float('nan')
        if os.path.exists(mpath):
            with open(mpath) as f:
                lines = f.readlines()
            if lines:
                final_emd[run] = float(
                    json.loads(lines[-1]).get('emd', float('nan')))

    matrix = score_matrix(args.runs, evs, outputs)
    out_names = ['out:' + r for r in args.runs]
    ranking, mean_rank = consensus_ranking(matrix, out_names)
    winner = ranking[0][len('out:'):]
    separation, sep_per_critic = family_separation(matrix, out_names)
    abstain = separation is not None and separation < ABSTAIN_THRESHOLD
    print('# consensus ranking (most real first): %s'
          % [n[len('out:'):] for n in ranking])
    print('# family separation: %.3f (abstain threshold %.2f)'
          % (separation, ABSTAIN_THRESHOLD))
    comp2 = comp2_scores(args.runs, ct_usage, final_emd)
    comp2_ranking = sorted(args.runs, key=lambda r: -comp2[r])
    comp2_winner = comp2_ranking[0]
    if abstain:
        print('# verdict: ABSTAIN — pool shows no family split; '
              'within-family ordering is not recoverable by critic '
              'consensus (measured Spearman -0.70, SELECT.json r3).')
        print('# comp2 fallback (rank-mean of -emd, -Ct-usage; '
              'SELECT_R5.json): %s -> winner %s/%s'
              % (comp2_ranking, args.config, comp2_winner))
    else:
        print('# winner: %s/%s' % (args.config, winner))

    result = {
        'config': args.config,
        'runs': args.runs,
        'n_eval': args.n,
        'critic_score_matrix': matrix,
        'consensus_ranking': ranking,
        'consensus_mean_rank': {n: round(v, 3)
                                for n, v in mean_rank.items()},
        'family_separation': round(separation, 4),
        'family_separation_per_critic': {
            c: round(v, 4) for c, v in sep_per_critic.items()},
        'abstain_threshold': ABSTAIN_THRESHOLD,
        'verdict': 'abstain' if abstain else 'rank',
        'winner': comp2_winner if abstain else winner,
        'winner_by': 'comp2' if abstain else 'consensus',
        'comp2': {
            'ranking': comp2_ranking,
            'scores': {r: round(comp2[r], 3) for r in args.runs},
            'ct_usage': ct_usage,
            'final_emd': {r: round(final_emd[r], 3) for r in args.runs},
        },
    }

    if args.truth:
        with open(args.truth) as f:
            truth = json.load(f)
        entries = truth['runs'] if isinstance(truth, dict) else truth
        quality = {e['run'].split('/', 1)[1]: e['quality']['avg_after']
                   for e in entries
                   if e['run'].split('/', 1)[0] == args.config}
        common = [r for r in args.runs if r in quality]
        if len(common) >= 2:
            cons = np.argsort(np.argsort(
                [mean_rank['out:' + r] for r in common]))
            true = np.argsort(np.argsort(
                [-quality[r] for r in common]))
            rho = float(np.corrcoef(cons, true)[0, 1])
            result['truth_quality'] = {r: quality[r] for r in common}
            result['spearman_vs_truth'] = round(rho, 4)
            result['truth_winner'] = max(common, key=lambda r: quality[r])
            print('# consensus vs measured quality: Spearman %.3f '
                  '(truth winner: %s)' % (rho, result['truth_winner']))

    if args.promote:
        if args.promote_by == 'truth':
            if 'truth_winner' not in result:
                raise SystemExit('--promote-by truth: no overlapping '
                                 'runs found in %s' % args.truth)
            target = result['truth_winner']
        elif args.promote_by == 'comp2' or abstain:
            if abstain and args.promote_by == 'consensus':
                print('# abstain: family separation %.3f < %.2f — '
                      'promoting the comp2 fallback winner'
                      % (separation, ABSTAIN_THRESHOLD))
            target = comp2_winner
            result['winner_by'] = 'comp2'
        else:
            target = winner  # relative: same directory level
        link = os.path.join(args.model_root, args.config, args.promote)
        if os.path.islink(link):
            os.unlink(link)
        elif os.path.exists(link):
            raise SystemExit('refusing to replace non-symlink %s' % link)
        os.symlink(target, link)
        result['promoted'] = link
        print('# promoted: %s -> %s' % (link, target))

    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    print('# wrote %s' % args.out)


if __name__ == '__main__':
    main()
