"""Chemical constant tables (own copy of the reference's
``pointvs_tpu/constants.py``): the standard amino-acid triplet codes and
Van der Waals radii by atomic number (Alvarez 2013), which the hotspot
maps read."""
from __future__ import annotations

AA_TRIPLET_CODES = frozenset((
    'ALA ARG ASN ASP CYS GLN GLU GLY HIS ILE '
    'LEU LYS MET PHE PRO SER THR TRP TYR VAL').split())

# Van der Waals radius (Angstrom) by atomic number 1..94.
_VDW_TABLE = (
    1.10, 1.40, 1.82, 1.53, 1.92, 1.70, 1.55, 1.52, 1.47, 1.54,   # H..Ne
    2.27, 1.73, 1.84, 2.10, 1.80, 1.80, 1.75, 1.88, 2.75, 2.31,   # Na..Ca
    2.15, 2.11, 2.07, 2.06, 2.05, 2.04, 2.00, 1.97, 1.96, 2.01,   # Sc..Zn
    1.87, 2.11, 1.85, 1.90, 1.85, 2.02, 3.03, 2.49, 2.32, 2.23,   # Ga..Zr
    2.18, 2.17, 2.16, 2.13, 2.10, 2.10, 2.11, 2.18, 1.93, 2.17,   # Nb..Sn
    2.06, 2.06, 1.98, 2.16, 3.43, 2.68, 2.43, 2.42, 2.40, 2.39,   # Sb..Nd
    2.38, 2.36, 2.35, 2.34, 2.33, 2.31, 2.30, 2.29, 2.27, 2.26,   # Pm..Yb
    2.24, 2.23, 2.22, 2.18, 2.16, 2.16, 2.13, 2.13, 2.14, 2.23,   # Lu..Hg
    1.96, 2.02, 2.07, 1.97, 2.02, 2.20, 3.48, 2.83, 2.47, 2.45,   # Tl..Th
    2.43, 2.41, 2.39, 2.40,                                        # Pa..Pu
)

VDW_RADII = {z + 1: r for z, r in enumerate(_VDW_TABLE)}
