"""The precision/recall of an attribution against interaction labels
(the part of ``pointvs_tpu/attribution/plip_subclasses.py`` that
``attribution.attribute`` reaches).

The labels come from ``interaction_parser.geometric_interactions`` (PLIP's
profiler is gated there). The average precision is computed here, as
scikit-learn's ``average_precision_score`` defines it, so the port needs
no scikit-learn. The reference module's PyMOL session rendering is not
here (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import pandas as pd

from pointvs_tpu_torch.attribution.interaction_parser import \
    geometric_interactions


def average_precision(labels, scores) -> float:
    """Area under the precision-recall steps: the sum over the distinct
    score thresholds, best first, of (recall gained) x precision."""
    labels = np.asarray(labels, np.float64)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, kind='mergesort')
    labels, scores = labels[order], scores[order]
    last = np.r_[np.flatnonzero(np.diff(scores)), len(scores) - 1]
    tps = np.cumsum(labels)[last]
    precision = tps / (last + 1)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def label_attributions_with_interactions(
        scored: pd.DataFrame) -> pd.DataFrame:
    """A scored structure frame with ``hbd``, ``hba``, ``pistacking`` and
    ``interaction`` (any of the three) columns; receptor rows 0."""
    rec = scored[scored.bp == 1]
    lig = scored[scored.bp == 0]
    labelled_lig = geometric_interactions(rec, lig)
    out = scored.copy()
    for col in ('hbd', 'hba', 'pistacking'):
        out[col] = 0
        out.loc[labelled_lig.index, col] = labelled_lig[col]
    out['interaction'] = (
        (out.hbd + out.hba + out.pistacking) > 0).astype(int)
    return out


def attribution_precision_recall(scored: pd.DataFrame
                                 ) -> Tuple[float, float, pd.DataFrame]:
    """(average precision, random baseline, labelled frame) of the ligand
    atoms ranked by attribution; NaNs when the labels are all one class."""
    labelled = label_attributions_with_interactions(scored)
    lig = labelled[labelled.bp == 0]
    if not len(lig) or lig.interaction.sum() in (0, len(lig)):
        return float('nan'), float('nan'), labelled
    ap = average_precision(lig.interaction, lig.attribution)
    return ap, float(lig.interaction.mean()), labelled
