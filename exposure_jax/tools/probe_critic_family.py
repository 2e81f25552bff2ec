"""Critic-side probe of the Ct/C policy-family bimodality.

PARITY_RUNS.json showed seeds of the same config converging to two
reward-equivalent families — gentle per-channel curves (C, high
contrast-intersection) vs uniform aggressive cosine contrast (Ct, low).
The wide-target campaign refuted distribution WIDTH as the missing
pressure (PARITY_WIDE.json), and the texture analysis showed the
per-patch separating statistics (local-contrast excess at matched
luminance, blocked-shadow patches absent from targets) already exist in
the stand-in data.  The remaining question is WHERE the signal dies:

  (a) the trained CRITIC cannot tell the families' outputs apart
      (capacity / gradient-penalty Lipschitz budget spent on the
      dominant luminance axis), or
  (b) the critic CAN tell — it scores the other family's outputs as
      more real than its own policy's — and the GENERATOR never found
      the better family (RL exploration / local optimum).

This tool measures it directly.  For each run it restores the full
train state, retouches the SAME held-out inputs with its policy
(64 px, the critic's native resolution), then scores every run's
outputs plus the real targets and the raw inputs with EVERY run's
critic (higher Wasserstein logit = more real, core/losses.py
critic_loss).  It also records the per-patch statistics of each
family's actual outputs vs the targets (4x4 luminance-patch std by
mean bin; dark-patch fraction) — the honest version of the emulated
analysis in DIVERSITY.md.

Usage:
  python -m exposure_jax.tools.probe_critic_family \
      --runs synthetic_tex/parity-seed0 synthetic_tex/parity-seed2 \
      [--n 256] [--out CRITIC_PROBE.json]

Reference anchor: the WGAN critic is the reference's quality oracle
(net.py:151-194); this probe asks whether that oracle, as trained,
actually encodes the per-patch realism the paper credits it with.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from exposure_jax.core.evaluator import Evaluator
from exposure_jax.tools.validate_parity import trajectory_stats
from exposure_jax.utils.config import load_config

LUM_W = np.asarray([0.27, 0.67, 0.06], np.float32)


def consensus_ranking(matrix, out_names):
    """Rank candidate output sets by mean rank across ALL critics.

    ``matrix`` maps critic name -> {candidate name: {'mean': logit}};
    rank 1 = scored most real by that critic.  Returns (ranking,
    mean_rank) with the ranking most-real-first.  Measured property
    (CRITIC_PROBE.json vs PARITY_TEX.json, CRITIC_PROBE_EXPLORE.json):
    within a same-config seed pool this reproduces the ground-truth
    histogram-intersection ordering exactly (Spearman 1.0) — an
    unsupervised model selector needing no targets at selection time.
    """
    mean_rank = {n: 0.0 for n in out_names}
    for row in matrix.values():
        ordered = sorted(out_names, key=lambda n: -row[n]['mean'])
        for rank, n in enumerate(ordered, 1):
            mean_rank[n] += rank / len(matrix)
    ranking = sorted(out_names, key=lambda n: mean_rank[n])
    return ranking, mean_rank


def family_separation(matrix, out_names, anchor='inputs'):
    """Median per-critic RELATIVE output spread — the abstain statistic.

    The consensus ranking separates policy FAMILIES but is actively
    anti-correlated with quality inside one family (SELECT.json round 3:
    Spearman -0.70 on the healthy ``synthetic_explore`` pool).  What
    distinguishes the two regimes is not inter-critic agreement
    (Kendall's W is >0.85 in BOTH recorded pools) but the ABSOLUTE
    scale of the critics' preferences: on the family-split pool
    (CRITIC_PROBE.json) each critic's spread across candidate outputs
    is ~20% of its own output-vs-raw-inputs gap (median 0.196 over 5
    critics); inside one family the residual preferences are ~20x
    smaller relative to the same gap.  So: for every critic compute
    ``(max - min over candidate outputs) / (mean(outputs) -
    score(anchor))`` and take the MEDIAN over critics (robust — 2 of 5
    good-pool critics measure 0.04-0.06).  Returns (median_ratio,
    per_critic_ratios); callers abstain below ``ABSTAIN_THRESHOLD``.

    ``anchor`` names a matrix column scored on the UNRETOUCHED inputs —
    available at selection time with no targets, which is the whole
    point of unsupervised selection.
    """
    ratios = {}
    for critic, row in matrix.items():
        if anchor not in row:
            continue
        outs = [row[n]['mean'] for n in out_names]
        spread = max(outs) - min(outs)
        gap = sum(outs) / len(outs) - row[anchor]['mean']
        ratios[critic] = spread / max(gap, 1e-9)
    if not ratios:
        return None, {}
    vals = sorted(ratios.values())
    mid = len(vals) // 2
    median = vals[mid] if len(vals) % 2 else \
        0.5 * (vals[mid - 1] + vals[mid])
    return median, ratios


# below this median relative spread the pool shows no family split and
# the consensus ordering is noise (see family_separation docstring)
ABSTAIN_THRESHOLD = 0.10


def patch_profile(images, patch=4):
    """Median 4x4 luminance-patch std per patch-mean bin + dark-patch
    fraction — the per-patch statistics that separate an
    over-contrasted output from an artist-style target."""
    lum = (np.asarray(images, np.float32) * LUM_W).sum(-1)
    n, h, w = lum.shape
    hp, wp = h // patch, w // patch
    p = lum[:, :hp * patch, :wp * patch].reshape(
        n, hp, patch, wp, patch).transpose(0, 1, 3, 2, 4).reshape(
        -1, patch * patch)
    m, s = p.mean(-1), p.std(-1)
    prof = {}
    for lo, hi in ((0.0, 0.1), (0.4, 0.6), (0.7, 0.8), (0.8, 0.9),
                   (0.9, 1.01)):
        sel = (m >= lo) & (m < hi)
        prof['%.1f-%.1f' % (lo, hi)] = {
            'frac': round(float(sel.mean()), 4),
            'med_std': round(float(np.median(s[sel])), 4)
            if sel.any() else None,
        }
    prof['flat_frac'] = round(float((s < 2e-3).mean()), 4)
    return prof


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--runs', nargs='+', required=True,
                    help='<config>/<run> entries (same config family)')
    ap.add_argument('--n', type=int, default=256)
    ap.add_argument('--model-root', default='models')
    ap.add_argument('--out', default='CRITIC_PROBE.json')
    args = ap.parse_args()

    cfg0 = load_config(args.runs[0].split('/', 1)[0])
    inputs, _ = cfg0.fake_data_provider_test().get_next_batch(args.n)
    inputs = np.clip(inputs, 0.0, 1.0).astype(np.float32)
    targets, _ = cfg0.real_data_provider().get_next_batch(args.n)
    targets = np.clip(targets, 0.0, 1.0).astype(np.float32)

    evs, outputs, labels = [], [], []
    for run in args.runs:
        config_name, _ = run.split('/', 1)
        cfg = load_config(config_name)
        cfg.name = run
        ev = Evaluator(cfg, model_root=args.model_root)
        traj, _ = ev.plan_trajectory(inputs, jax.random.PRNGKey(0))
        out = np.clip(ev.retouch(inputs, traj), 0.0, 1.0)
        stats = trajectory_stats(cfg, ev, inputs)
        evs.append(ev)
        outputs.append(out)
        labels.append(stats['filter_usage'])
        print('# %s usage: %s' % (run, stats['filter_usage']))

    candidates = {'targets': targets, 'inputs': inputs}
    for run, out in zip(args.runs, outputs):
        candidates['out:' + run] = out

    # score matrix: every run's critic on every candidate set
    score_fns = {}
    matrix = {}
    for run, ev in zip(args.runs, evs):
        critic, params = ev.critic, ev.state.crit_params
        if run not in score_fns:
            score_fns[run] = jax.jit(
                lambda p, x, critic=critic: critic.apply(p, x))
        row = {}
        for name, imgs in candidates.items():
            logits = np.asarray(
                score_fns[run](params, jnp.asarray(imgs)))
            row[name] = {'mean': round(float(logits.mean()), 4),
                         'std': round(float(logits.std()), 4)}
        matrix['critic:' + run] = row
        own = row['out:' + run]['mean']
        others = {n: v['mean'] for n, v in row.items()
                  if n.startswith('out:') and n != 'out:' + run}
        print('# critic %s: targets %.3f | own out %.3f | others %s'
              % (run, row['targets']['mean'], own,
                 {k.split('/')[-1]: v for k, v in others.items()}))

    out_names = ['out:' + r for r in args.runs]
    consensus, mean_rank = consensus_ranking(matrix, out_names)
    print('# consensus ranking (most real first): %s'
          % [n.split('/')[-1] for n in consensus])

    profiles = {name: patch_profile(imgs)
                for name, imgs in candidates.items()}

    result = {
        'runs': args.runs,
        'n_eval': args.n,
        'filter_usage': dict(zip(args.runs, labels)),
        'critic_score_matrix': matrix,
        'consensus_ranking': consensus,
        'consensus_mean_rank': {n: round(v, 3)
                                for n, v in mean_rank.items()},
        'patch_profiles': profiles,
        'reading': 'higher critic logit = more real (critic_loss '
                   'minimizes mean(fake)-mean(real)); if a critic '
                   'scores another family ABOVE its own policy '
                   'output, the generator failed to find that '
                   'family (exploration), not the critic to see it',
    }
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    print('# wrote %s' % args.out)


if __name__ == '__main__':
    main()
