"""Structure parsing: PDB/SDF/MOL2 -> smina-typed parquet files (the
port's own copy of ``pointvs_tpu/dataset_generation/types_to_parquet.py``).

- The 28-entry smina atom table and the map that collapses it to 10 (or
  18 with ``extended``) channels, plus a catch-all: ``n_features`` is 11
  (18 extended, as Sodium/Potassium matches no table entry).
- The typing rules: carbon aromaticity and hetero-bonded carbon, the
  H-bond donor/acceptor adjustment, water excluded.
- ``StructuralFileParser.file_to_parquets``: one DataFrame with columns
  ``x, y, z`` (float64), ``atomic_number, types, bp`` (int64; ligand
  ``bp`` 0, receptor 1), or a parquet file per molecule.
- Openbabel/pybel perceives the chemistry where it is importable;
  otherwise ``chem.py``'s pure-Python chemistry does, which gives the
  same collapsed channels wherever its perception is exact (standard
  protein residues; SDF/MOL2 ligands with bond orders).
- ``download_pdb_file`` fetches from RCSB through a local cache
  (``POINTVS_PDB_CACHE``, default ``~/.cache/pointvs_tpu_torch/pdb``),
  so a cached id needs no network.

Usage (a types file's structures, converted beside their paths):
    python -m pointvs_tpu_torch.dataset_generation.types_to_parquet \\
        <types_file> <output_path> <input_base_path> [-e] [-m]
"""
from __future__ import annotations

import argparse
import urllib.request
from collections import defaultdict, namedtuple
from pathlib import Path
from typing import List, Optional

import pandas as pd

from pointvs_tpu_torch.utils import expand_path, get_logger, mkdir, \
    no_return_parallelise

LOG = get_logger()

try:  # pragma: no cover - depends on image
    from openbabel import openbabel, pybel
    HAVE_OPENBABEL = True
except ImportError:
    openbabel = pybel = None
    HAVE_OPENBABEL = False


AtomInfo = namedtuple('AtomInfo', 'sm adname anum xs_donor xs_acceptor')

# The smina/AutoDock atom taxonomy (fields needed for typing; the full
# radius/depth/solvation table lives in smina and is not used on this path).
SMINA_ATOM_TYPES = [
    AtomInfo('Hydrogen', 'H', 1, False, False),
    AtomInfo('PolarHydrogen', 'HD', 1, False, False),
    AtomInfo('AliphaticCarbonXSHydrophobe', 'C', 6, False, False),
    AtomInfo('AliphaticCarbonXSNonHydrophobe', 'C', 6, False, False),
    AtomInfo('AromaticCarbonXSHydrophobe', 'A', 6, False, False),
    AtomInfo('AromaticCarbonXSNonHydrophobe', 'A', 6, False, False),
    AtomInfo('Nitrogen', 'N', 7, False, False),
    AtomInfo('NitrogenXSDonor', 'N', 7, True, False),
    AtomInfo('NitrogenXSDonorAcceptor', 'NA', 7, True, True),
    AtomInfo('NitrogenXSAcceptor', 'NA', 7, False, True),
    AtomInfo('Oxygen', 'O', 8, False, False),
    AtomInfo('OxygenXSDonor', 'O', 8, True, False),
    AtomInfo('OxygenXSDonorAcceptor', 'OA', 8, True, True),
    AtomInfo('OxygenXSAcceptor', 'OA', 8, False, True),
    AtomInfo('Sulfur', 'S', 16, False, False),
    AtomInfo('SulfurAcceptor', 'SA', 16, False, False),
    AtomInfo('Phosphorus', 'P', 15, False, False),
    AtomInfo('Fluorine', 'F', 9, False, False),
    AtomInfo('Chlorine', 'Cl', 17, False, False),
    AtomInfo('Bromine', 'Br', 35, False, False),
    AtomInfo('Iodine', 'I', 53, False, False),
    AtomInfo('Magnesium', 'Mg', 12, True, False),
    AtomInfo('Manganese', 'Mn', 25, True, False),
    AtomInfo('Zinc', 'Zn', 30, True, False),
    AtomInfo('Calcium', 'Ca', 20, True, False),
    AtomInfo('Iron', 'Fe', 26, True, False),
    AtomInfo('GenericMetal', 'M', 0, True, False),
    AtomInfo('Boron', 'B', 5, False, False),
]

NON_AD_METAL_NAMES = ['Cu', 'Fe', 'Na', 'K', 'Hg', 'Co', 'U', 'Cd', 'Ni',
                      'Si']
ATOM_EQUIVALENCES = [('Se', 'S')]

# Collapsed feature channels (ref get_type_map, types_to_parquet.py:548-579)
TYPE_GROUPS = [
    ['AliphaticCarbonXSHydrophobe'],
    ['AliphaticCarbonXSNonHydrophobe'],
    ['AromaticCarbonXSHydrophobe'],
    ['AromaticCarbonXSNonHydrophobe'],
    ['Nitrogen', 'NitrogenXSAcceptor'],
    ['NitrogenXSDonor', 'NitrogenXSDonorAcceptor'],
    ['Oxygen', 'OxygenXSAcceptor'],
    ['OxygenXSDonor', 'OxygenXSDonorAcceptor'],
    ['Sulfur', 'SulfurAcceptor', 'Selenium'],
    ['Phosphorus'],
]
EXTENDED_TYPE_GROUPS = TYPE_GROUPS + [
    ['Fluorine'],
    ['Chlorine'],
    ['Bromine'],
    ['Zinc'],
    ['Magnesium', 'Calcium'],
    ['Sodium', 'Potassium'],
    ['Iron'],
    ['GenericMetal'],
]


class StructuralFileParser:
    """PDB/SDF/MOL2 -> typed DataFrame/parquet (ref class at :75)."""

    def __init__(self, mol_type: str = 'ligand', extended: bool = False):
        assert mol_type in ('ligand', 'receptor')
        self.mol_type = mol_type
        self.extended = extended
        self.atom_types = [info.sm for info in SMINA_ATOM_TYPES]
        self.type_map = self.get_type_map()
        self.n_features = len(set(self.type_map.values())) + 1

    def get_type_map(self):
        groups = EXTENDED_TYPE_GROUPS if self.extended else TYPE_GROUPS
        out = defaultdict(lambda: len(groups))
        for i, name in enumerate(self.atom_types):
            for group in groups:
                if name in group:
                    out[i] = groups.index(group)
                    break
        return out

    # ------------------------------------------------------------------ #
    # smina typing rules (both backends)
    # ------------------------------------------------------------------ #
    @staticmethod
    def adjust_smina_type(t: str, h_bonded: bool, hetero_bonded: bool) -> str:
        """Refine a base type using bonding environment
        (ref :605-644; the donor/acceptor adjustment)."""
        if t in ('AliphaticCarbonXSNonHydrophobe',
                 'AliphaticCarbonXSHydrophobe'):
            return ('AliphaticCarbonXSNonHydrophobe' if hetero_bonded
                    else 'AliphaticCarbonXSHydrophobe')
        if t in ('AromaticCarbonXSNonHydrophobe',
                 'AromaticCarbonXSHydrophobe'):
            return ('AromaticCarbonXSNonHydrophobe' if hetero_bonded
                    else 'AromaticCarbonXSHydrophobe')
        if t in ('Nitrogen', 'NitrogenXSDonor'):
            return 'NitrogenXSDonor' if h_bonded else 'Nitrogen'
        if t in ('NitrogenXSAcceptor', 'NitrogenXSDonorAcceptor'):
            return 'NitrogenXSDonorAcceptor' if h_bonded \
                else 'NitrogenXSAcceptor'
        if t in ('Oxygen', 'OxygenXSDonor'):
            return 'OxygenXSDonor' if h_bonded else 'Oxygen'
        if t in ('OxygenXSAcceptor', 'OxygenXSDonorAcceptor'):
            return 'OxygenXSDonorAcceptor' if h_bonded \
                else 'OxygenXSAcceptor'
        return t

    def string_to_smina_type(self, string: str) -> str:
        """AD name / smina name / element symbol -> smina type
        (ref :646-711)."""
        if len(string) <= 2:
            for info in SMINA_ATOM_TYPES:
                if string == info.adname:
                    return info.sm
            for a, b in ATOM_EQUIVALENCES:
                if string == a:
                    return self.string_to_smina_type(b)
            if string in NON_AD_METAL_NAMES:
                return 'GenericMetal'
            return 'GenericMetal'
        for info in SMINA_ATOM_TYPES:
            if string == info.sm:
                return info.sm
        return 'NumTypes'

    def type_int_for(self, base_symbol: str, h_bonded: bool,
                     hetero_bonded: bool) -> int:
        atype = self.string_to_smina_type(base_symbol)
        atype = self.adjust_smina_type(atype, h_bonded, hetero_bonded)
        if atype == 'NumTypes':
            return self.n_features - 1
        return self.type_map[self.atom_types.index(atype)]

    # openbabel path -------------------------------------------------- #
    def obatom_to_smina_type(self, ob_atom) -> str:
        """Exact reference typing via openbabel perception (ref :713-737)."""
        atomic_number = ob_atom.atomicnum
        num_to_name = {1: 'HD', 6: 'A', 7: 'NA', 8: 'OA', 16: 'SA'}
        condition_fns = defaultdict(lambda: lambda: True)
        condition_fns.update({
            6: ob_atom.OBAtom.IsAromatic,
            7: ob_atom.OBAtom.IsHbondAcceptor,
            16: ob_atom.OBAtom.IsHbondAcceptor,
        })
        ename = openbabel.GetSymbol(atomic_number)
        if condition_fns[atomic_number]():
            ename = num_to_name.get(atomic_number, ename)
        atype = self.string_to_smina_type(ename)
        h_bonded = hetero_bonded = False
        for neighbour in openbabel.OBAtomAtomIter(ob_atom.OBAtom):
            if neighbour.GetAtomicNum() == 1:
                h_bonded = True
            elif neighbour.GetAtomicNum() != 6:
                hetero_bonded = True
        return self.adjust_smina_type(atype, h_bonded, hetero_bonded)

    # ------------------------------------------------------------------ #
    # Reading + conversion
    # ------------------------------------------------------------------ #
    def read_file(self, infile, add_hydrogens: bool = True) -> List:
        if HAVE_OPENBABEL:
            molecules = []
            suffix = Path(infile).suffix[1:]
            for mol in pybel.readfile(suffix, str(infile)):
                if add_hydrogens:
                    mol.OBMol.AddHydrogens()
                molecules.append(mol)
            return molecules
        from pointvs_tpu_torch.dataset_generation import chem
        return chem.read_molecules(infile)

    def _mol_to_frame_ob(self, mol, add_polar_hydrogens: bool):
        xs, ys, zs, atomic_nums, types = [], [], [], [], []
        for atom in mol:
            residue = atom.OBAtom.GetResidue()
            if (self.mol_type == 'receptor' and residue is None) or (
                    residue is not None
                    and residue.GetName().lower() == 'hoh'):
                continue
            z = atom.atomicnum
            if z == 1:
                if atom.OBAtom.IsNonPolarHydrogen() \
                        or not add_polar_hydrogens:
                    continue
                raise NotImplementedError(
                    'Hydrogens temporarily disabled.')
            smina_type = self.obatom_to_smina_type(atom)
            if smina_type == 'NumTypes':
                type_int = self.n_features - 1
            else:
                type_int = self.type_map[self.atom_types.index(smina_type)]
            x, y, z_coord = atom.coords
            xs.append(x)
            ys.append(y)
            zs.append(z_coord)
            atomic_nums.append(atom.atomicnum)
            types.append(type_int)
        return xs, ys, zs, atomic_nums, types

    def _mol_to_frame_fallback(self, mol, add_polar_hydrogens: bool):
        from pointvs_tpu_torch.dataset_generation import chem
        adj = mol.neighbours()
        xs, ys, zs, atomic_nums, types = [], [], [], [], []
        for idx, atom in enumerate(mol.atoms):
            if atom.residue_name.lower() == 'hoh':
                continue
            if atom.element == 1:
                # polar hydrogens disabled, matching the reference's
                # current code path (ref :725-729)
                continue
            symbol = chem.Z_TO_SYMBOL.get(atom.element, 'M')
            num_to_name = {6: 'A', 7: 'NA', 8: 'OA', 16: 'SA'}
            if atom.element == 6:
                base = num_to_name[6] if atom.is_aromatic else 'C'
            elif atom.element in (7, 16):
                # acceptor perception: N/S treated as acceptor (openbabel
                # IsHbondAcceptor) — irrelevant to the collapsed channels,
                # which merge acceptor/non-acceptor groups (TYPE_GROUPS)
                base = num_to_name[atom.element]
            elif atom.element == 8:
                base = num_to_name[8]
            else:
                base = symbol
            type_int = self.type_int_for(
                base, mol.has_h_neighbour(idx, adj),
                mol.has_hetero_neighbour(idx, adj))
            xs.append(atom.x)
            ys.append(atom.y)
            zs.append(atom.z)
            atomic_nums.append(atom.element)
            types.append(type_int)
        return xs, ys, zs, atomic_nums, types

    def mol_typed_atoms(self, mol):
        """Yield (x, y, z, atomic_number, smina_type_str, residue_name)
        for every heavy atom, on either chemistry backend. Used by the
        attribution hotspot pipeline (ref hotspot.py:268-281) which needs
        the smina type STRING, not the collapsed channel int."""
        if HAVE_OPENBABEL and not hasattr(mol, 'atoms'):
            for atom in mol:
                if atom.atomicnum == 1:
                    continue
                residue = atom.OBAtom.GetResidue()
                resname = residue.GetName() if residue is not None else ''
                x, y, z = atom.coords
                yield (x, y, z, atom.atomicnum,
                       self.obatom_to_smina_type(atom), resname)
            return
        from pointvs_tpu_torch.dataset_generation import chem
        adj = mol.neighbours()
        num_to_name = {6: 'A', 7: 'NA', 8: 'OA', 16: 'SA'}
        for idx, atom in enumerate(mol.atoms):
            if atom.element == 1:
                continue
            symbol = chem.Z_TO_SYMBOL.get(atom.element, 'M')
            if atom.element == 6:
                base = num_to_name[6] if atom.is_aromatic else 'C'
            elif atom.element in (7, 8, 16):
                base = num_to_name[atom.element]
            else:
                base = symbol
            atype = self.adjust_smina_type(
                self.string_to_smina_type(base),
                mol.has_h_neighbour(idx, adj),
                mol.has_hetero_neighbour(idx, adj))
            yield (atom.x, atom.y, atom.z, atom.element, atype,
                   atom.residue_name)

    def obmol_to_parquet(self, mol, add_polar_hydrogens: bool
                         ) -> pd.DataFrame:
        if HAVE_OPENBABEL:
            xs, ys, zs, atomic_nums, types = self._mol_to_frame_ob(
                mol, add_polar_hydrogens)
        else:
            xs, ys, zs, atomic_nums, types = self._mol_to_frame_fallback(
                mol, add_polar_hydrogens)
        df = pd.DataFrame()
        df['x'], df['y'], df['z'] = xs, ys, zs
        df['atomic_number'] = atomic_nums
        df['types'] = types
        df['bp'] = int(self.mol_type == 'receptor')
        return df

    def file_to_parquets(self, input_file, output_path=None,
                         output_fname=None, add_polar_hydrogens: bool = True,
                         sdf_idx: Optional[int] = None):
        """Convert a structure file; returns the DataFrame when no
        output_path is given (ref :769-791)."""
        mols = self.read_file(input_file)
        if output_path is not None:
            output_path = mkdir(output_path)
        if output_fname is not None:
            output_fname = Path(output_fname)
        for idx, mol in enumerate(mols):
            if sdf_idx is not None and idx != sdf_idx:
                continue
            df = self.obmol_to_parquet(mol, add_polar_hydrogens)
            if output_path is None:
                return df
            if output_fname is None:
                title = (mol.OBMol.GetTitle() if HAVE_OPENBABEL
                         else mol.title)
                fname = output_path / (
                    Path(title).name.split('.')[0] + '.parquet')
            else:
                fname = output_path / output_fname
            if not str(fname).endswith('.parquet'):
                raise RuntimeError('Output filename must end in .parquet')
            df.to_parquet(fname)
        return None

    # ------------------------------------------------------------------ #
    @staticmethod
    def download_pdb_file(pdbid: str, output_dir):
        """Fetch a PDB structure from RCSB (ref :793-831).

        Downloads are cached under ~/.cache/pointvs_tpu/pdb/ (override
        with POINTVS_PDB_CACHE) so repeat attribution runs — and offline
        runs against previously fetched ids — never hit the network.
        """
        import os
        import shutil
        output_dir = Path(output_dir).expanduser()
        pdbpath = output_dir / 'receptor.pdb'
        if pdbpath.is_file():
            LOG.warning(f'{pdbpath} already exists.')
            return pdbpath
        if len(pdbid) != 4:
            raise RuntimeError('Unknown protein ' + pdbid)
        cache_dir = Path(os.environ.get(
            'POINTVS_PDB_CACHE',
            Path.home() / '.cache' / 'pointvs_tpu_torch' / 'pdb'))
        cached = cache_dir / f'{pdbid.lower()}.pdb'
        if not cached.is_file():
            url = f'https://files.rcsb.org/download/{pdbid.lower()}.pdb'
            last_err = None
            for attempt in range(3):
                try:
                    with urllib.request.urlopen(url, timeout=30) as resp:
                        contents = resp.read().decode()
                    break
                except Exception as exc:   # URLError / timeout / HTTP
                    last_err = exc
                    LOG.warning(f'Fetching pdb {pdbid} failed '
                                f'(attempt {attempt + 1}/3): {exc}')
            else:
                raise RuntimeError(
                    f'Could not fetch {pdbid} from RCSB and it is not in '
                    f'the offline cache ({cached}). Place the .pdb there '
                    f'to run without network.') from last_err
            cache_dir.mkdir(parents=True, exist_ok=True)
            tmp = cached.with_suffix('.tmp')
            tmp.write_text(contents)
            tmp.rename(cached)
            LOG.info(f'Downloaded {pdbid} into cache {cached}.')
        output_dir.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(cached, pdbpath)
        LOG.info(f'File available as {pdbpath}.')
        return pdbpath

    def download_pdbs_from_csv(self, csv, output_dir):
        output_dir = Path(output_dir).expanduser()
        pdbids = set()
        with open(csv, 'r', encoding='utf-8') as f:
            for line in f:
                pdbids.add(line.split(',')[0].lower())
        for pdbid in sorted(pdbids):
            if not (output_dir / pdbid / 'receptor.pdb').is_file():
                self.download_pdb_file(pdbid, output_dir / pdbid)


# ---------------------------------------------------------------------- #
# Types-file batch conversion (ref :833-928)
# ---------------------------------------------------------------------- #
def parse_types_file(types_file):
    recs, ligs = set(), set()
    with open(expand_path(types_file), 'r', encoding='utf-8') as f:
        for line in f:
            chunks = line.split()
            paths = [c for c in chunks if not _is_number(c)]
            if len(paths) >= 2:
                recs.add(paths[0])
                ligs.add(paths[1])
    return list(recs), list(ligs)


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def parse_single_types_entry(inp, outp, structure_type: str,
                             extended: bool = False, mol2: bool = False):
    extension = '.mol2' if mol2 else '.sdf'
    parser = StructuralFileParser(structure_type, extended)
    inp = Path(inp)
    outp = Path(outp)
    if structure_type == 'receptor':
        name = inp.with_suffix('').name
        if name.endswith('_0'):
            inp = inp.parent / (name[:-2] + inp.suffix)
        inp = Path(str(inp).replace('.parquet', '.pdb').replace(
            '.gninatypes', '.pdb'))
        sdf_idx = None
    else:
        stem = str(inp)
        parts = stem.split('_')
        try:
            sdf_idx = int(parts[-1].split('.')[0])
            inp = Path('_'.join(parts[:-1]) + extension)
        except ValueError:
            sdf_idx = 0
            inp = Path(stem).with_suffix(extension)
    parser.file_to_parquets(
        inp, outp.parent, outp.name.replace('.gninatypes', '.parquet'),
        add_polar_hydrogens=False, sdf_idx=sdf_idx)


def parse_types_mp(types_file, input_base_path, output_base_path,
                   extended: bool = False, mol2: bool = False,
                   cpus: int = 1):
    output_dir = mkdir(output_base_path)
    input_base_path = expand_path(input_base_path)
    recs, ligs = parse_types_file(types_file)
    inputs = recs + ligs
    structure_types = (['receptor'] * len(recs)) + (['ligand'] * len(ligs))
    outputs = [Path(output_dir, i) for i in inputs]
    inputs = [Path(input_base_path, i) for i in inputs]
    no_return_parallelise(
        parse_single_types_entry, inputs, outputs, structure_types,
        extended, mol2, cpus=cpus)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('types_file')
    ap.add_argument('output_path')
    ap.add_argument('input_base_path')
    ap.add_argument('--extended_atom_types', '-e', action='store_true')
    ap.add_argument('--use_mol2', '-m', action='store_true')
    args = ap.parse_args(argv)
    parse_types_mp(args.types_file, args.input_base_path, args.output_path,
                   args.extended_atom_types, mol2=args.use_mol2)


if __name__ == '__main__':
    main()
