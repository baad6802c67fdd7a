"""The precision/recall of an attribution against interaction labels,
and the PyMOL session rendering of a scored structure (counterpart of
``pointvs_tpu/attribution/plip_subclasses.py``).

The labels come from ``interaction_parser.geometric_interactions`` (PLIP's
profiler is gated there). The average precision is computed here, as
scikit-learn's ``average_precision_score`` defines it, so the port needs
no scikit-learn. The H-bond cylinders' geometry and colours
(``hbond_cgo_objects``) need no PyMOL; ``render_attribution_pse`` does
nothing and returns False where PyMOL does not import.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import pandas as pd

from pointvs_tpu_torch.attribution.interaction_parser import \
    geometric_interactions
from pointvs_tpu_torch.utils import coords_to_string, get_logger

LOG = get_logger()


def get_colour_interpolation_fn(c1, c2, min_val, max_val):
    """A function from a score to the RGB colour linearly between ``c1``
    (at ``min_val``) and ``c2`` (at ``max_val``), clamped to the range."""
    c1, c2 = np.asarray(c1, dtype=float), np.asarray(c2, dtype=float)
    assert (c2 >= c1).all(), 'All values in c2 must be >= those in c1'
    assert max_val >= min_val, 'max_val must be >= min_val'
    rgb_rng = c2 - c1
    val_rng = max(max_val - min_val, 1e-12)

    def interp(val):
        frac = (float(val) - min_val) / val_rng
        return (c1 + rgb_rng * min(max(frac, 0.0), 1.0)).tolist()

    return interp


# PyMOL's cgo CYLINDER opcode (``pymol.cgo.CYLINDER``), copied so that the
# geometry below needs no PyMOL.
CYLINDER = 9.0


def hbond_cgo_objects(bonds, inverse_colour: bool = False,
                      radius: float = 0.08):
    """Score-coloured CGO cylinders for attribution H-bonds.

    ``bonds`` maps ``'id1-id2'`` to ``((x1, y1, z1), (x2, y2, z2),
    score)``. Returns ``[(object name, cgo floats, label text, label
    position)]``: cylinders of ``radius`` on a magenta-to-white ramp, the
    highest score magenta unless ``inverse_colour``."""
    if not bonds:
        return []
    scores = [b[2] for b in bonds.values()]
    interp = get_colour_interpolation_fn(
        [1.0, 0.0, 1.0], [1.0, 1.0, 1.0], min(scores), max(scores))
    objects = []
    for idx, (p1, p2, score) in enumerate(bonds.values()):
        interp_score = (score if inverse_colour
                        else min(scores) + max(scores) - score)
        col = interp(interp_score)
        cgo = [CYLINDER, *[float(c) for c in p1],
               *[float(c) for c in p2], radius, *col, *col]
        mid = [(a + b) / 2 for a, b in zip(p1, p2)]
        objects.append((f'bond{idx}', cgo, f'{score:.2g}', mid))
    return objects


def render_attribution_pse(pdb_file, pse_path, bfactors=None, bonds=None,
                           ligname: str = None,
                           inverse_colour: bool = False) -> bool:
    """Save a PyMOL session of ``pdb_file``: cartoon and lines, the ligand
    (residue ``ligname``) as sticks, B-factors from ``bfactors`` (a map
    from ``coords_to_string`` keys to scores) on a blue-white-red
    spectrum, and ``bonds`` as ``hbond_cgo_objects`` with score labels.
    Returns False, and saves nothing, where PyMOL does not import."""
    try:
        import pymol
        from pymol import cmd
    except ImportError:
        LOG.info('PyMOL not importable: no .pse written')
        return False
    pymol.finish_launching(['pymol', '-qc'])
    cmd.reinitialize()
    cmd.load(str(pdb_file), 'complex')
    cmd.hide('everything', 'all')
    cmd.show('cartoon', 'polymer')
    cmd.show('lines', 'polymer')
    if ligname:
        cmd.select('ligand', f'resn {ligname}')
        cmd.show('sticks', 'ligand')
    if bfactors:
        def modify_bfactor(x, y, z):
            return bfactors.get(coords_to_string((x, y, z)), 0)
        cmd.alter_state(0, '(all)', 'b=modify_bfactor(x, y, z)',
                        space={'modify_bfactor': modify_bfactor},
                        quiet=True)
        cmd.spectrum('b', 'blue_white_red', 'complex')
    for name, cgo, label, mid in hbond_cgo_objects(
            bonds or {}, inverse_colour=inverse_colour):
        cmd.load_cgo(cgo, name)
        ps_name = 'PS_' + name
        cmd.pseudoatom(ps_name, pos=mid, label=label)
        cmd.set('label_color', 'black', ps_name)
        cmd.set('label_size', 20, ps_name)
    cmd.save(str(pse_path))
    cmd.delete('all')
    return True


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
