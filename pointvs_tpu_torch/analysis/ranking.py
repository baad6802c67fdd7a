"""Pose rankings per target (counterpart of
``pointvs_tpu/analysis/ranking.py``)."""
from __future__ import annotations

import numpy as np


class Ranking:
    """Per-target arrays of rows ``(..., score, rmsd)`` sorted best
    first, read from ``fname``."""

    def __init__(self, fname, sorted_scores_and_rmsds):
        self.fname = fname
        self.sorted_scores_and_rmsds = sorted_scores_and_rmsds

    def get_top_n(self, n: int, threshold: float = 2.0) -> float:
        """The fraction of targets with a pose within ``threshold`` RMSD
        among their first ``n``."""
        in_top_n = sum(
            1 for info in self.sorted_scores_and_rmsds
            if (info[:n, -1] <= threshold).any())
        return in_top_n / len(self.sorted_scores_and_rmsds)

    def get_mean_top_ranked_rmsd(self) -> float:
        return float(np.mean(
            [item[0, -1] for item in self.sorted_scores_and_rmsds]))

    def __str__(self):
        return ('Mean RMSD of top ranked structure: {0:0.5f}\n'
                'Top1 at 2.0 A: {1:0.5f}\n').format(
                    self.get_mean_top_ranked_rmsd(), self.get_top_n(1, 2.0))

    def __repr__(self):
        return (f'Ranking object obtained from {self.fname} containing '
                f'stats:\n{self}')
