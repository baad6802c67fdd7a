"""Build the host graph library (``graphops.cpp``) with g++ and bind it
with ctypes.

The library compiles at first use into the directory that
``POINTVS_NATIVE_CACHE`` names (read at each build; by default
``~/.cache/pointvs_tpu_torch/native``, apart from the JAX package's
``~/.cache/pointvs_tpu/native``), named by a digest of the source and the
flags, so an edited source is rebuilt and never served stale. Each build writes a temporary
file whose name is unique to its process (pid and a random suffix) and
``os.replace``s it into place, so processes that build at once (pytest's
workers) never see each other's half-written output. A failed build
raises ``RuntimeError`` with g++'s stderr: nothing falls back.

Wrappers (numpy in, numpy out):
- ``box_filter``: receptor atoms strictly within ``radius`` of any ligand
  atom;
- ``radius_edges``: the inter/intra radius graph in the numpy path's
  order, with the pruning BFS;
- ``counting_argsort``: stable argsort of bounded non-negative ids, and
  ``lexsort_pairs``, the (row, column) order of an edge list from two of
  them;
- ``native_symhalf``: the v3 wire format's eligibility check of one
  collated edge list and its sender < receiver half (``data/wire.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import secrets
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

SRC = Path(__file__).parent / 'graphops.cpp'
# No -march=native: the library must run on any host of the same
# architecture, and no FMA contraction, so the squared distances round
# as numpy's do.
CXX_FLAGS = ('-O3', '-ffp-contract=off', '-shared', '-fPIC')

_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int32)
_BP = ctypes.POINTER(ctypes.c_uint8)
_HP = ctypes.POINTER(ctypes.c_uint16)
SIGNATURES = {
    # lig_xyz, n_lig, rec_xyz, n_rec, radius, keep -> kept count
    'pvs_box_filter': ((_DP, ctypes.c_int, _DP, ctypes.c_int,
                        ctypes.c_double, _BP), ctypes.c_int),
    # xyz, bp, n, inter_r, intra_r, prune, rows, cols, attrs, cap, keep
    # -> edge count, or -1 past cap
    'pvs_radius_edges': ((_DP, _IP, ctypes.c_int, ctypes.c_double,
                          ctypes.c_double, ctypes.c_int, _IP, _IP, _IP,
                          ctypes.c_int64, _BP), ctypes.c_int64),
    # ids, n, max_id, out_order
    'pvs_counting_argsort': ((_IP, ctypes.c_int64, ctypes.c_int32, _IP),
                             None),
    # senders, receivers, recv_perm, edge_class, e, n_pad, half_s, half_r,
    # half_bits -> edges with sender < receiver, or -1 if ineligible
    'pvs_symhalf': ((_IP, _IP, _IP, _BP, ctypes.c_int64, ctypes.c_int32,
                     _HP, _HP, _BP), ctypes.c_int64),
}


def build_dir() -> Path:
    """Where the library is built: ``POINTVS_NATIVE_CACHE``, else
    ``~/.cache/pointvs_tpu_torch/native``."""
    default = Path.home() / '.cache' / 'pointvs_tpu_torch' / 'native'
    return Path(os.environ.get('POINTVS_NATIVE_CACHE', default))


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + ' '.join(CXX_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f'libgraphops-{digest}.so'


def build() -> Path:
    """Compile the library unless it is built already; its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which('g++')
    if cxx is None:
        raise RuntimeError('g++ not found: the host graph library '
                           '(pointvs_tpu_torch/native/graphops.cpp) needs it')
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f'{out.stem}.{os.getpid()}.{secrets.token_hex(4)}.tmp')
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), '-o', str(tmp)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed to build {SRC.name} (exit '
                           f'{proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, out)
    return out


@lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The library, built first if needed, with its C signatures set."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def _ptr(arr: np.ndarray, kind):
    return arr.ctypes.data_as(kind)


def box_filter(lig_xyz: np.ndarray, rec_xyz: np.ndarray,
               radius: float) -> np.ndarray:
    """Ascending indices of the receptor atoms strictly within ``radius``
    of any ligand atom."""
    lig = np.ascontiguousarray(lig_xyz, dtype=np.float64)
    rec = np.ascontiguousarray(rec_xyz, dtype=np.float64)
    keep = np.zeros(len(rec), dtype=np.uint8)
    if len(rec) and len(lig):
        load().pvs_box_filter(_ptr(lig, _DP), len(lig), _ptr(rec, _DP),
                              len(rec), float(radius), _ptr(keep, _BP))
    return np.flatnonzero(keep)


# First guess at the edges an atom has (a pocket at 4 A has about 10);
# an undersized guess costs one more pass at four times the capacity.
_EDGES_PER_ATOM = 32


def radius_edges(xyz: np.ndarray, bp: np.ndarray, inter_radius: float,
                 intra_radius: float, prune: bool):
    """(rows, cols, attrs, keep): int32 edges in the numpy path's order
    and the per-atom survival mask of the pruning (all True without it).
    With pruning, the edges index the kept atoms."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    bp = np.ascontiguousarray(bp, dtype=np.int32)
    n = len(bp)
    lib = load()
    cap = max(4096, _EDGES_PER_ATOM * n)
    while True:
        rows = np.empty(cap, np.int32)
        cols = np.empty(cap, np.int32)
        attrs = np.empty(cap, np.int32)
        keep = np.empty(n, np.uint8)
        count = lib.pvs_radius_edges(
            _ptr(xyz, _DP), _ptr(bp, _IP), n, float(inter_radius),
            float(intra_radius), int(bool(prune)), _ptr(rows, _IP),
            _ptr(cols, _IP), _ptr(attrs, _IP), cap, _ptr(keep, _BP))
        if count >= 0:
            return (rows[:count].copy(), cols[:count].copy(),
                    attrs[:count].copy(), keep.astype(bool))
        cap *= 4


def counting_argsort(ids: np.ndarray, max_id: int) -> np.ndarray:
    """``np.argsort(ids, kind='stable')`` as int32, for ids in
    [0, max_id], in O(len(ids) + max_id)."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    out = np.empty(len(ids), np.int32)
    if not len(ids):
        return out
    lo, hi = int(ids.min()), int(ids.max())
    if lo < 0 or hi > max_id:
        raise ValueError(f'ids span [{lo}, {hi}], outside [0, {max_id}]')
    load().pvs_counting_argsort(_ptr(ids, _IP), len(ids), int(max_id),
                                _ptr(out, _IP))
    return out


def lexsort_pairs(rows: np.ndarray, cols: np.ndarray,
                  max_id: int) -> np.ndarray:
    """``np.lexsort((cols, rows))`` as int32 (by row, then column, ties in
    their order) for ids in [0, max_id]: two stable counting sorts."""
    by_col = counting_argsort(cols, max_id)
    return by_col[counting_argsort(np.asarray(rows)[by_col], max_id)]


def native_symhalf(senders: np.ndarray, receivers: np.ndarray,
                   recv_perm: np.ndarray, edge_class: np.ndarray,
                   n_pad: int):
    """(half_senders, half_receivers, half_class_bits) of one collated
    edge list for the v3 wire format: uint16 [E/2], uint16 [E/2] and uint8
    [E/8], or None when the list is ineligible (``pvs_symhalf`` in
    ``graphops.cpp`` says when). ``wire._symhalf_numpy`` is its plain
    version."""
    e = len(senders)
    if e % 8 or not 0 <= n_pad <= 65535:
        return None
    senders = np.ascontiguousarray(senders, dtype=np.int32)
    receivers = np.ascontiguousarray(receivers, dtype=np.int32)
    recv_perm = np.ascontiguousarray(recv_perm, dtype=np.int32)
    edge_class = np.ascontiguousarray(edge_class, dtype=np.uint8)
    half_s = np.empty(e // 2, np.uint16)
    half_r = np.empty(e // 2, np.uint16)
    bits = np.empty(e // 8, np.uint8)
    n_up = load().pvs_symhalf(
        _ptr(senders, _IP), _ptr(receivers, _IP), _ptr(recv_perm, _IP),
        _ptr(edge_class, _BP), e, int(n_pad), _ptr(half_s, _HP),
        _ptr(half_r, _HP), _ptr(bits, _BP))
    if n_up < 0:
        return None
    return half_s, half_r, bits
