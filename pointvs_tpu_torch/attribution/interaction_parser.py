"""Protein-ligand interaction labels for the precision/recall of an
attribution (the port's own copy of
``pointvs_tpu/attribution/interaction_parser.py``).

PLIP's interaction profiler labels atoms (``hba``, ``hbd``,
``pistacking``) where it is importable (``HAVE_PLIP``);
``geometric_interactions`` is the labeller that needs no PLIP: a ligand
H-bond donor (type channel 5/7) within ``HBOND_MAX_DIST`` of a receptor
acceptor (4-7) labels ``hbd``, mirrored for ``hba``; an aromatic carbon
(2/3) within ``PISTACK_MAX_DIST`` of a receptor aromatic carbon labels
``pistacking``. It is conservative: a labelling aid for ranking
attributions, not a full interaction profiler.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pandas as pd

from pointvs_tpu_torch.dataset_generation.types_to_parquet import (
    StructuralFileParser,
)
from pointvs_tpu_torch.utils import PositionDict, coords_to_string

try:  # pragma: no cover
    from plip.structure.preparation import PDBComplex  # noqa: F401
    HAVE_PLIP = True
except ImportError:
    HAVE_PLIP = False

HBOND_MAX_DIST = 3.5     # donor-acceptor heavy-atom distance (Angstrom)
PISTACK_MAX_DIST = 5.5   # aromatic ring centroid distance


class StructuralInteractionParser(StructuralFileParser):
    """Labels each ligand/receptor atom with interaction participation."""

    def mol_calculate_interactions(self, mol, pl_interaction=None
                                   ) -> Optional[pd.DataFrame]:
        """PLIP path: pl_interaction is a characterised binding site."""
        if pl_interaction is None:
            raise ValueError('PLIP interaction object required; use '
                             'geometric_interactions() without PLIP.')
        interaction_info = {
            'lig_acceptors': _count_map(
                [h.a.coords for h in pl_interaction.hbonds_ldon]
                + [h.a.coords for h in pl_interaction.hbonds_pdon]),
            'lig_donors': _count_map(
                [h.d.coords for h in pl_interaction.hbonds_ldon]
                + [h.d.coords for h in pl_interaction.hbonds_pdon]),
            'pi_stacking': _count_map(
                [atom.coords for pi in pl_interaction.pistacking
                 for atom in pi.ligandring.atoms]),
        }
        return self.featurise_interaction(mol, interaction_info)

    def featurise_interaction(self, mol, interaction_dict: Dict,
                              include_noncovalent: bool = True
                              ) -> pd.DataFrame:
        """Structure + coordinate->count maps -> labelled DataFrame."""
        df = self.obmol_to_parquet(mol, add_polar_hydrogens=False)
        n = len(df)
        hba = np.zeros(n, dtype=np.int32)
        hbd = np.zeros(n, dtype=np.int32)
        pistacking = np.zeros(n, dtype=np.int32)
        for i in range(n):
            key = coords_to_string((df.x[i], df.y[i], df.z[i]))
            hba[i] = interaction_dict['lig_acceptors'].get(key, 0)
            hbd[i] = interaction_dict['lig_donors'].get(key, 0)
            pistacking[i] = interaction_dict['pi_stacking'].get(key, 0)
        df['hba'] = hba
        df['hbd'] = hbd
        df['pistacking'] = pistacking
        return df


def _count_map(coords_list) -> PositionDict:
    out = PositionDict()
    for coords in coords_list:
        key = coords_to_string(coords)
        out[key] = out.get(key, 0) + 1
    return out


def geometric_interactions(rec_struct: pd.DataFrame,
                           lig_struct: pd.DataFrame,
                           rec_mol=None, lig_mol=None) -> pd.DataFrame:
    """PLIP-free fallback: label ligand atoms interacting with the
    receptor.

    hbond: ligand donor (type channel 5/7) within HBOND_MAX_DIST of a
    receptor acceptor (channel 4/6 offset) gives hbd; mirrored for hba.
    pistacking: aromatic carbons (channels 2/3) within PISTACK_MAX_DIST of
    receptor aromatic carbons.
    """
    lig_xyz = np.stack([lig_struct.x, lig_struct.y, lig_struct.z], axis=1)
    rec_xyz = np.stack([rec_struct.x, rec_struct.y, rec_struct.z], axis=1)
    lig_types = lig_struct.types.to_numpy() % 11
    rec_types = rec_struct.types.to_numpy() % 11

    diff = lig_xyz[:, None, :] - rec_xyz[None, :, :]
    dists = np.sqrt(np.einsum('ijk,ijk->ij', diff, diff))

    lig_donor = np.isin(lig_types, (5, 7))
    lig_acceptor = np.isin(lig_types, (4, 5, 6, 7))
    lig_aromatic = np.isin(lig_types, (2, 3))
    rec_donor = np.isin(rec_types, (5, 7))
    rec_acceptor = np.isin(rec_types, (4, 5, 6, 7))
    rec_aromatic = np.isin(rec_types, (2, 3))

    close = dists < HBOND_MAX_DIST
    hbd = lig_donor & (close & rec_acceptor[None, :]).any(axis=1)
    hba = lig_acceptor & (close & rec_donor[None, :]).any(axis=1)
    pi_close = dists < PISTACK_MAX_DIST
    pistack = lig_aromatic & (pi_close & rec_aromatic[None, :]).any(axis=1)

    out = lig_struct.copy()
    out['hbd'] = hbd.astype(np.int32)
    out['hba'] = hba.astype(np.int32)
    out['pistacking'] = pistack.astype(np.int32)
    return out
