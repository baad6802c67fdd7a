"""Re-screening a cached library with a three-output affinity model: the
traffic kind ``rescreen_affinity``.

Set-up, window, release and the end-to-end metric are ``rescreen``'s. The
weights follow a schema with three outputs (pKi, pKd, pIC50), set on the
cell before set-up, and the check scores a sampled pose by the mean of
the reference's three outputs, as the screen scores a ``multi_regression``
run; the rows' order and ranks are checked as ``rescreen`` checks them.
"""
from __future__ import annotations

import numpy as np
import torch

from pvsbench import inputs
from pvsbench.kinds import rescreen
from pvsbench.reference import egnn as ref_egnn
from pvsbench.reference import featurise as ref_feat

OUTPUTS = 3
window, release, end_to_end = (rescreen.window, rescreen.release,
                               rescreen.end_to_end)


def setup(ctx) -> dict:
    flags = ctx.config['flags']
    ctx.schema = ref_egnn.param_schema(flags['channels'], flags['layers'],
                                       ctx.config['dim_input'],
                                       dim_output=OUTPUTS)
    return rescreen.setup(ctx)


def reference_scores(ctx, state, sample, prec) -> np.ndarray:
    """The mean of the reference's outputs for the library's poses
    ``sample``."""
    flags, poses = ctx.config['flags'], state['poses']
    rec = ref_feat.read_structure(poses['root'] / inputs.RECEPTOR)
    graphs = [ref_feat.featurise(
        rec, ref_feat.read_structure(poses['files'][i]), flags['radius'],
        flags['edge_radius'], flags.get('estimate_bonds', False))
        for i in sample]
    weights = {k: v.to(ctx.device) for k, v in state['weights'].items()}
    out = []
    with torch.no_grad(), prec.active():
        for lo, hi in ref_egnn.blocks_of(graphs, ref_egnn.EDGE_BUDGET):
            b = ref_egnn.block(graphs[lo:hi], ctx.device)
            outputs = ref_egnn.forward(weights, b, flags['layers'], prec)
            out.append(outputs.mean(dim=1).cpu().double().numpy())
    return np.concatenate(out)


def check(ctx, state, obs) -> dict:
    files = state['poses']['files']
    sample = rescreen.check_sample(ctx, len(files))
    ref = reference_scores(ctx, state, sample, ref_egnn.Precision(False))
    library = {str(f) for f in files}
    return {'score_gap': rescreen.score_gap(obs['rows'], files, sample, ref),
            'rank_faults': max(rescreen.rank_faults(rows, library)
                               for rows in obs['rows'])}
