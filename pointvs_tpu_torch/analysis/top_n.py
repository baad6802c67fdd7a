"""Scores read back from a predictions file (own copy of the reference's
``pointvs_tpu/analysis/top_n.py`` and its Pearson helper).

Rows are ``<y_true> | <y_pred> <rec> <lig>``. top_n groups poses by
receptor, ranks them by predicted score, and returns the fraction of
receptors whose top-n poses hold at least one true positive.
"""
from __future__ import annotations

from collections import defaultdict

from pointvs_tpu_torch.utils import expand_path


def _rows(predictions_file):
    with open(expand_path(predictions_file), 'r', encoding='utf-8') as f:
        for line in f:
            chunks = line.split()
            if len(chunks) >= 5 and chunks[1] == '|':
                yield chunks


def top_n(predictions_file, n: int = 1) -> float:
    scores = defaultdict(list)
    for chunks in _rows(predictions_file):
        scores[chunks[3]].append((float(chunks[2]), int(float(chunks[0]))))
    if not scores:
        return 0.0
    hits = 0
    for vals in scores.values():
        ranked = sorted(vals, key=lambda x: x[0], reverse=True)
        hits += bool(sum(label for _, label in ranked[:n]))
    return hits / len(scores)


def regression_pearson(predictions_file):
    """(r, p-value) between truths and predictions."""
    from scipy.stats import pearsonr
    rows = [(float(c[0]), float(c[2])) for c in _rows(predictions_file)]
    if len(rows) < 2:
        return 0.0, 1.0
    r, p = pearsonr([t for t, _ in rows], [p for _, p in rows])
    return float(r), float(p)
