"""Parsers for GNINA-style .types manifests (own copy of the reference's
``pointvs_tpu/data/types_files.py``).

- classification: ``<label> <...> <rmsd> <receptor> <ligand> [dE rmsd]``;
  the first two fields that do not parse as floats are the receptor and
  ligand paths, the float before the receptor is the RMSD, field 0 is the
  label when integral. Two-field lines are ``<receptor> <ligand>``.
- regression: ``<pki> <pkd> <ic50> <receptor> <ligand>`` or just
  ``<receptor> <ligand>``; -1 marks a missing target.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

from pointvs_tpu_torch.utils import expand_path, get_logger, get_n_cols

LOG = get_logger()


@dataclass
class ClassificationEntries:
    labels: List[Optional[int]] = field(default_factory=list)
    rmsds: List[Optional[float]] = field(default_factory=list)
    receptors: List[str] = field(default_factory=list)
    ligands: List[str] = field(default_factory=list)


@dataclass
class RegressionEntries:
    pki: List[Optional[float]] = field(default_factory=list)
    pkd: List[Optional[float]] = field(default_factory=list)
    ic50: List[Optional[float]] = field(default_factory=list)
    receptors: List[str] = field(default_factory=list)
    ligands: List[str] = field(default_factory=list)


def _is_float(chunk: str) -> bool:
    try:
        float(chunk)
        return True
    except ValueError:
        return False


def parse_classification_types(types_fname) -> ClassificationEntries:
    out = ClassificationEntries()
    with open(expand_path(types_fname), 'r', encoding='utf-8') as f:
        for line in f:
            chunks = line.strip().split()
            if not chunks:
                continue
            label = rmsd = recpath = ligpath = None
            if len(chunks) == 2:
                recpath, ligpath = chunks
            else:
                try:
                    label = int(chunks[0])
                except ValueError:
                    label = None
                for idx, chunk in enumerate(chunks):
                    if chunk.startswith('#') or _is_float(chunk):
                        continue
                    if recpath is None:
                        recpath = chunk
                        rmsd = float(chunks[idx - 1])
                    elif ligpath is None:
                        ligpath = chunk
            if recpath is None or ligpath is None:
                continue
            out.labels.append(label)
            out.rmsds.append(rmsd)
            out.receptors.append(recpath)
            out.ligands.append(ligpath)
    return out


def parse_regression_types(data_root, types_fname) -> RegressionEntries:
    """Parse an affinity types file, dropping entries whose structures are
    missing under ``data_root`` (with a warning listing them)."""
    n_cols = get_n_cols(types_fname)
    out = RegressionEntries()
    missing = []
    with open(expand_path(types_fname), 'r', encoding='utf-8') as f:
        for line in f:
            chunks = line.strip().split()
            if not chunks:
                continue
            if n_cols >= 5:
                pki, pkd, ic50 = (float(c) for c in chunks[:3])
                rec, lig = chunks[3], chunks[4]
            else:
                pki = pkd = ic50 = None
                rec, lig = chunks[0], chunks[1]
            if Path(data_root, rec).is_file() and Path(data_root,
                                                       lig).is_file():
                out.pki.append(pki)
                out.pkd.append(pkd)
                out.ic50.append(ic50)
                out.receptors.append(rec)
                out.ligands.append(lig)
            else:
                missing.append((rec, lig))
    for rec, lig in missing:
        LOG.warning(f'Missing structures: {Path(data_root, rec)} '
                    f'{Path(data_root, lig)}')
    return out
