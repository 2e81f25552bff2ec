"""MIT-Adobe FiveK fold definitions (reference util.py:441-473).

The fold id lists themselves are dataset artifacts that live under
``data/folds/*.txt`` (fetched together with the dataset; see
``exposure_jax/tools/fetch_fivek.py``)."""

import os

FOLD_FILES = {
    'u_test': 'data/folds/FiveK_test.txt',
    'u_amt': 'data/folds/FiveK_test_AMT.txt',
    '2k_train': 'data/folds/FiveK_train_first2k.txt',
    '2k_target': 'data/folds/FiveK_train_second2k.txt',
}


def read_set(name, data_root='.'):
    """Return the list of FiveK image ids in the named fold."""
    if name == '5k':
        return list(range(1, 5001))
    if name not in FOLD_FILES:
        raise ValueError('%s not found (known folds: %s)' %
                         (name, sorted(FOLD_FILES) + ['5k']))
    fn = os.path.join(data_root, FOLD_FILES[name])
    if not os.path.exists(fn):
        raise FileNotFoundError(
            '%s missing - fetch the FiveK dataset artifacts first '
            '(python -m exposure_jax.tools.fetch_fivek)' % fn)
    ids = []
    with open(fn) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            try:
                ids.append(int(line))
            except ValueError:
                pass
    return ids
