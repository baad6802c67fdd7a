"""Pure-Python chemistry: PDB/SDF/MOL2 parsing, bond inference, implicit
hydrogens and aromaticity (the port's own copy of
``pointvs_tpu/dataset_generation/chem.py``).

Smina typing (``types_to_parquet.py``) needs four facts per atom: its
element, whether it is aromatic (carbon), whether a hydrogen is bonded
(donor) and whether a heavy atom other than carbon is bonded. Openbabel
perceives them where it is installed; without it this module does:

- SDF (V2000) and MOL2 give explicit bonds and bond orders (aromatic is
  order 4, or type 'ar');
- PDB bonds are inferred from covalent radii (CONECT records honoured);
  aromaticity and polar hydrogens come from standard-residue templates,
  with ring perception for HETATM ligands;
- implicit hydrogen counts are standard valences minus explicit bond
  orders (what openbabel's AddHydrogens materialises).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

# Covalent radii (Angstrom, Pyykko & Atsumi 2009) for bond inference.
COVALENT_RADII = {
    1: 0.32, 5: 0.85, 6: 0.75, 7: 0.71, 8: 0.63, 9: 0.64, 11: 1.55,
    12: 1.39, 14: 1.16, 15: 1.11, 16: 1.03, 17: 0.99, 19: 1.96, 20: 1.71,
    25: 1.19, 26: 1.16, 27: 1.11, 29: 1.12, 30: 1.18, 34: 1.16, 35: 1.14,
    53: 1.33,
}
DEFAULT_COVALENT_RADIUS = 1.4

SYMBOL_TO_Z = {
    'H': 1, 'B': 5, 'C': 6, 'N': 7, 'O': 8, 'F': 9, 'NA': 11, 'MG': 12,
    'SI': 14, 'P': 15, 'S': 16, 'CL': 17, 'K': 19, 'CA': 20, 'MN': 25,
    'FE': 26, 'CO': 27, 'NI': 28, 'CU': 29, 'ZN': 30, 'SE': 34, 'BR': 35,
    'CD': 48, 'I': 53, 'HG': 80, 'U': 92,
}
Z_TO_SYMBOL = {z: s.capitalize() for s, z in SYMBOL_TO_Z.items()}

# Standard valences for implicit-H computation.
STANDARD_VALENCE = {1: 1, 5: 3, 6: 4, 7: 3, 8: 2, 9: 1, 15: 5, 16: 2,
                    17: 1, 35: 1, 53: 1}

# Aromatic ring atom names per standard residue (exact for proteins).
_AROMATIC_RESIDUE_ATOMS = {
    'PHE': {'CG', 'CD1', 'CD2', 'CE1', 'CE2', 'CZ'},
    'TYR': {'CG', 'CD1', 'CD2', 'CE1', 'CE2', 'CZ'},
    'TRP': {'CG', 'CD1', 'CD2', 'NE1', 'CE2', 'CE3', 'CZ2', 'CZ3', 'CH2'},
    'HIS': {'CG', 'ND1', 'CD2', 'CE1', 'NE2'},
}

# Protein atoms carrying at least one bound hydrogen (polar donors +
# aliphatics are irrelevant — only N/O donor status matters downstream).
_RESIDUE_H_BONDED = {
    # Backbone amide N of every residue except proline has an H.
    ('*', 'N'): True,
    ('PRO', 'N'): False,
    ('ARG', 'NE'): True, ('ARG', 'NH1'): True, ('ARG', 'NH2'): True,
    ('ASN', 'ND2'): True, ('GLN', 'NE2'): True,
    ('HIS', 'ND1'): True, ('HIS', 'NE2'): True,
    ('LYS', 'NZ'): True,
    ('SER', 'OG'): True, ('THR', 'OG1'): True, ('TYR', 'OH'): True,
    ('TRP', 'NE1'): True, ('CYS', 'SG'): True,
}


@dataclass
class Atom:
    element: int
    x: float
    y: float
    z: float
    name: str = ''
    residue_name: str = ''
    residue_idx: int = 0
    formal_charge: int = 0
    is_aromatic: bool = False
    implicit_h: int = 0

    @property
    def coords(self) -> Tuple[float, float, float]:
        return (self.x, self.y, self.z)


@dataclass
class Molecule:
    atoms: List[Atom] = field(default_factory=list)
    # bond: (i, j, order) with order 4 meaning aromatic
    bonds: List[Tuple[int, int, int]] = field(default_factory=list)
    title: str = ''

    def neighbours(self) -> Dict[int, List[Tuple[int, int]]]:
        adj = defaultdict(list)
        for i, j, order in self.bonds:
            adj[i].append((j, order))
            adj[j].append((i, order))
        return adj

    # ------------------------------------------------------------------ #
    def perceive(self):
        """Fill is_aromatic and implicit_h from bonds/templates."""
        adj = self.neighbours()
        self._perceive_aromaticity(adj)
        self._perceive_implicit_h(adj)
        return self

    def _perceive_aromaticity(self, adj):
        # 1) explicit aromatic bonds
        for i, j, order in self.bonds:
            if order == 4:
                self.atoms[i].is_aromatic = True
                self.atoms[j].is_aromatic = True
        # 2) residue templates (proteins)
        for atom in self.atoms:
            ring_atoms = _AROMATIC_RESIDUE_ATOMS.get(atom.residue_name)
            if ring_atoms and atom.name in ring_atoms:
                atom.is_aromatic = True
        # 3) kekulé ring perception for everything else
        self._ring_aromaticity(adj)

    def _ring_aromaticity(self, adj):
        """Mark 5/6-rings whose heavy atoms all look sp2 as aromatic.

        Heuristic Hückel-lite: every ring carbon must participate in at
        least one double/aromatic bond; N/O/S ring members may contribute a
        lone pair instead.
        """
        rings = self._find_small_rings(adj)
        for ring in rings:
            if len(ring) not in (5, 6):
                continue
            ok = True
            for idx in ring:
                atom = self.atoms[idx]
                if atom.element == 6:
                    has_pi = any(order in (2, 4) for _, order in adj[idx])
                    if not has_pi:
                        ok = False
                        break
                elif atom.element not in (7, 8, 16):
                    ok = False
                    break
            if ok:
                for idx in ring:
                    self.atoms[idx].is_aromatic = True

    def _find_small_rings(self, adj, max_size: int = 6) -> List[List[int]]:
        """All simple cycles up to max_size via per-edge BFS (small mols)."""
        rings: Set[Tuple[int, ...]] = set()
        n = len(self.atoms)
        if n > 600:  # receptors: rings come from templates instead
            return []
        for start, nbrs in adj.items():
            for first, _ in nbrs:
                # shortest path start->first avoiding the direct edge
                prev = {start: None}
                queue = [start]
                found = None
                while queue and found is None:
                    node = queue.pop(0)
                    for nxt, _ in adj[node]:
                        if node == start and nxt == first:
                            continue
                        if nxt not in prev:
                            prev[nxt] = node
                            if nxt == first:
                                found = nxt
                                break
                            queue.append(nxt)
                if found is None:
                    continue
                path = [found]
                while prev[path[-1]] is not None:
                    path.append(prev[path[-1]])
                if len(path) <= max_size:
                    rings.add(tuple(sorted(path)))
        return [list(r) for r in rings]

    def _perceive_implicit_h(self, adj):
        for idx, atom in enumerate(self.atoms):
            # residue templates first (exact for proteins)
            key = (atom.residue_name, atom.name)
            if key in _RESIDUE_H_BONDED:
                atom.implicit_h = int(_RESIDUE_H_BONDED[key])
                continue
            if ('*', atom.name) in _RESIDUE_H_BONDED \
                    and atom.residue_name not in ('PRO',) \
                    and atom.residue_name in _STD_RESIDUES:
                atom.implicit_h = 1
                continue
            if atom.residue_name in _STD_RESIDUES:
                # Standard residues: donor status is template-driven only.
                # The valence heuristic below would mis-tag carbonyl /
                # carboxylate oxygens as donors because distance-inferred
                # PDB bonds carry no orders. Only N/O/S donor status
                # matters downstream, and those are all in the templates.
                atom.implicit_h = 0
                continue
            valence = STANDARD_VALENCE.get(atom.element)
            if valence is None:
                atom.implicit_h = 0
                continue
            # aromatic bonds count ~1.5; round the total down
            used = 0.0
            for _, order in adj[idx]:
                used += 1.5 if order == 4 else order
            h = int(valence - atom.formal_charge - round(used))
            atom.implicit_h = max(h, 0)

    def has_h_neighbour(self, idx: int, adj=None) -> bool:
        adj = adj or self.neighbours()
        if any(self.atoms[j].element == 1 for j, _ in adj[idx]):
            return True
        return self.atoms[idx].implicit_h > 0

    def has_hetero_neighbour(self, idx: int, adj=None) -> bool:
        adj = adj or self.neighbours()
        return any(self.atoms[j].element not in (1, 6) for j, _ in adj[idx])


_STD_RESIDUES = {
    'ALA', 'ARG', 'ASN', 'ASP', 'CYS', 'GLN', 'GLU', 'GLY', 'HIS', 'ILE',
    'LEU', 'LYS', 'MET', 'PHE', 'PRO', 'SER', 'THR', 'TRP', 'TYR', 'VAL'}


# ---------------------------------------------------------------------- #
# File parsers
# ---------------------------------------------------------------------- #
def _element_from_pdb(line: str) -> Optional[int]:
    elem = line[76:78].strip().upper()
    if not elem:
        name = line[12:16].strip()
        elem = ''.join(c for c in name if c.isalpha())[:2].upper()
        if elem not in SYMBOL_TO_Z:
            elem = elem[:1]
    if elem not in SYMBOL_TO_Z and len(elem) == 2:
        elem = elem[0]
    return SYMBOL_TO_Z.get(elem)


def parse_pdb(path, keep_waters: bool = False,
              model: int = 1) -> Molecule:
    mol = Molecule(title=Path(path).name)
    conect: List[Tuple[int, int]] = []
    serial_to_idx: Dict[int, int] = {}
    residue_counter: Dict[Tuple[str, str, str], int] = {}
    current_model = 1
    with open(path, 'r', encoding='utf-8', errors='replace') as f:
        for line in f:
            rec = line[:6]
            if rec == 'MODEL ':
                current_model = int(line.split()[1])
            elif rec == 'ENDMDL':
                current_model += 1
            if current_model != model:
                continue
            if rec in ('ATOM  ', 'HETATM'):
                res_name = line[17:20].strip()
                if res_name == 'HOH' and not keep_waters:
                    continue
                z = _element_from_pdb(line)
                if z is None:
                    continue
                res_key = (line[21], line[22:27], res_name)
                residue_counter.setdefault(res_key, len(residue_counter) + 1)
                atom = Atom(
                    element=z,
                    x=float(line[30:38]), y=float(line[38:46]),
                    z=float(line[46:54]),
                    name=line[12:16].strip(), residue_name=res_name,
                    residue_idx=residue_counter[res_key])
                try:
                    serial_to_idx[int(line[6:11])] = len(mol.atoms)
                except ValueError:
                    pass
                mol.atoms.append(atom)
            elif rec == 'CONECT':
                fields = line.split()[1:]
                if len(fields) >= 2:
                    base = int(fields[0])
                    for other in fields[1:]:
                        conect.append((base, int(other)))
    bonds = {tuple(sorted((serial_to_idx[a], serial_to_idx[b])))
             for a, b in conect
             if a in serial_to_idx and b in serial_to_idx}
    mol.bonds = [(i, j, 1) for i, j in bonds]
    _infer_distance_bonds(mol)
    return mol.perceive()


def _infer_distance_bonds(mol: Molecule, tolerance: float = 0.45):
    """Add bonds between atoms closer than r_cov(i)+r_cov(j)+tol."""
    if not mol.atoms:
        return
    coords = np.array([a.coords for a in mol.atoms])
    radii = np.array([COVALENT_RADII.get(a.element, DEFAULT_COVALENT_RADIUS)
                      for a in mol.atoms])
    existing = {(min(i, j), max(i, j)) for i, j, _ in mol.bonds}
    # Grid hash for O(N) neighbour search (receptors are ~10^4 atoms).
    cell = 2.0 * radii.max() + tolerance
    grid: Dict[Tuple[int, int, int], List[int]] = defaultdict(list)
    keys = np.floor(coords / cell).astype(int)
    for idx, key in enumerate(map(tuple, keys)):
        grid[key].append(idx)
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1)]
    for key, members in grid.items():
        neigh = []
        for off in offsets:
            neigh.extend(grid.get(
                (key[0] + off[0], key[1] + off[1], key[2] + off[2]), []))
        for i in members:
            for j in neigh:
                if j <= i:
                    continue
                pair = (i, j)
                if pair in existing:
                    continue
                cutoff = radii[i] + radii[j] + tolerance
                d2 = ((coords[i] - coords[j]) ** 2).sum()
                if 0.16 < d2 < cutoff * cutoff:
                    existing.add(pair)
                    mol.bonds.append((i, j, 1))


def parse_sdf(path) -> List[Molecule]:
    """V2000 SDF parser (multi-molecule)."""
    mols = []
    with open(path, 'r', encoding='utf-8', errors='replace') as f:
        blocks = f.read().split('$$$$')
    for block in blocks:
        lines = block.strip('\n').splitlines()
        if len(lines) < 4:
            continue
        counts = lines[3]
        try:
            n_atoms, n_bonds = int(counts[0:3]), int(counts[3:6])
        except (ValueError, IndexError):
            continue
        mol = Molecule(title=lines[0].strip())
        for line in lines[4:4 + n_atoms]:
            sym = line[31:34].strip().upper()
            charge_code = int(line[36:39]) if len(line) >= 39 else 0
            charge = {1: 3, 2: 2, 3: 1, 5: -1, 6: -2, 7: -3}.get(
                charge_code, 0)
            mol.atoms.append(Atom(
                element=SYMBOL_TO_Z.get(sym, 6),
                x=float(line[0:10]), y=float(line[10:20]),
                z=float(line[20:30]), formal_charge=charge))
        for line in lines[4 + n_atoms:4 + n_atoms + n_bonds]:
            i, j = int(line[0:3]) - 1, int(line[3:6]) - 1
            order = int(line[6:9])
            mol.bonds.append((i, j, order))
        # M  CHG overrides
        for line in lines[4 + n_atoms + n_bonds:]:
            if line.startswith('M  CHG'):
                fields = line.split()[3:]
                for a_idx, chg in zip(fields[::2], fields[1::2]):
                    mol.atoms[int(a_idx) - 1].formal_charge = int(chg)
        mols.append(mol.perceive())
    return mols


def parse_mol2(path) -> List[Molecule]:
    mols = []
    mol: Optional[Molecule] = None
    section = None
    with open(path, 'r', encoding='utf-8', errors='replace') as f:
        for line in f:
            line = line.rstrip()
            if line.startswith('@<TRIPOS>'):
                section = line[9:].strip()
                if section == 'MOLECULE':
                    mol = Molecule()
                    mols.append(mol)
                    section = 'MOLECULE_TITLE'
                continue
            if mol is None or not line.strip():
                continue
            if section == 'MOLECULE_TITLE':
                mol.title = line.strip()
                section = 'MOLECULE_REST'
            elif section == 'ATOM':
                fields = line.split()
                sym = fields[5].split('.')[0].upper()
                aromatic = fields[5].endswith('.ar')
                atom = Atom(
                    element=SYMBOL_TO_Z.get(sym, 6),
                    x=float(fields[2]), y=float(fields[3]),
                    z=float(fields[4]), name=fields[1],
                    residue_name=fields[7][:3] if len(fields) > 7 else '',
                    is_aromatic=aromatic)
                mol.atoms.append(atom)
            elif section == 'BOND':
                fields = line.split()
                order = 4 if fields[3] in ('ar', 'am') else (
                    int(fields[3]) if fields[3].isdigit() else 1)
                mol.bonds.append(
                    (int(fields[1]) - 1, int(fields[2]) - 1, order))
    return [m.perceive() for m in mols]


def read_molecules(path) -> List[Molecule]:
    suffix = Path(path).suffix.lower()
    if suffix == '.pdb':
        return [parse_pdb(path)]
    if suffix == '.sdf':
        return parse_sdf(path)
    if suffix == '.mol2':
        return parse_mol2(path)
    raise ValueError(f'Unsupported structure format: {suffix}')
