"""The port's host graph library (``pointvs_tpu_torch/native``) against
its numpy plain versions and the JAX package's struct helpers.

- ``make_box`` / ``generate_edges`` (the g++ library) equal
  ``make_box_numpy`` / ``generate_edges_numpy`` and JAX's
  ``fast_structs.box_np`` / ``edges_np`` array for array: kept rows and
  their order, edges, edge classes, pruned atoms. On seeded clouds (large
  enough for the library's cell grid, with far atoms for the pruning), on
  ``rec_0``/``lig_0`` and on the parsed 7zzp pair, over inter/intra radii
  and pruning on and off.
- ``counting_argsort`` equals ``np.argsort(kind='stable')``.
- The build: into the directory ``POINTVS_NATIVE_CACHE`` names (by
  default ``~/.cache/pointvs_tpu_torch/native``); two processes building
  into one empty directory both succeed; a source that does not compile
  raises with g++'s stderr.
- The dataset's graphs equal those of the numpy plain versions.
"""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pointvs_tpu.data import fast_structs
from pointvs_tpu_torch.data import dataset as dataset_mod
from pointvs_tpu_torch.data.preprocessing import (
    KEYS,
    concat_structs,
    generate_edges,
    generate_edges_numpy,
    make_box,
    make_box_numpy,
    read_struct,
)
from pointvs_tpu_torch.dataset_generation.types_to_parquet import \
    StructuralFileParser
from pointvs_tpu_torch.native import build as native

RESOURCES = Path(__file__).parent / 'resources'
REPO = Path(__file__).parent.parent


def _cloud(seed, n_lig=40, n_rec=260, far=6):
    """A ligand inside a receptor cloud, plus ``far`` receptor atoms well
    away from both (pruned)."""
    rng = np.random.RandomState(seed)
    lig = rng.rand(n_lig, 3) * 6 + 7
    rec = np.concatenate([rng.rand(n_rec, 3) * 20,
                          rng.rand(far, 3) * 3 + 60])
    xyz = np.concatenate([lig, rec])
    n = len(xyz)
    bp = np.concatenate([np.zeros(n_lig, np.int64),
                         np.ones(len(rec), np.int64)])
    return {'x': xyz[:, 0], 'y': xyz[:, 1], 'z': xyz[:, 2],
            'atomic_number': rng.choice([1, 6, 7, 8], n).astype(np.int64),
            'types': rng.randint(0, 11, n).astype(np.int64) + 11 * bp,
            'bp': bp}


def _parsed_7zzp():
    lig = StructuralFileParser('ligand').file_to_parquets(
        RESOURCES / '7zzp_lig_0.sdf')
    rec = StructuralFileParser('receptor').file_to_parquets(
        RESOURCES / '7zzp_rec_0.pdb')
    return concat_structs({k: rec[k].to_numpy() for k in KEYS},
                          {k: lig[k].to_numpy() for k in KEYS}, 11)


STRUCTS = {
    'cloud0': lambda: _cloud(0),
    'cloud1': lambda: _cloud(1, n_lig=12, n_rec=400),
    'rec0_lig0': lambda: concat_structs(
        read_struct(RESOURCES / 'rec_0.parquet'),
        read_struct(RESOURCES / 'lig_0.parquet'), 11),
    '7zzp': _parsed_7zzp,
}
RADII = [(4.0, 4.0), (4.0, 2.0), (6.0, 2.0)]


def _assert_structs_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize('radius', [6.0, 10.0])
@pytest.mark.parametrize('name', sorted(STRUCTS))
def test_box_matches_numpy_and_jax(name, radius):
    struct = STRUCTS[name]()
    got = make_box(struct, radius)
    _assert_structs_equal(got, make_box_numpy(struct, radius))
    _assert_structs_equal(got, fast_structs.box_np(struct, radius))
    assert 0 < len(got['bp']) < len(struct['bp'])


@pytest.mark.parametrize('prune', [False, True], ids=['keep', 'prune'])
@pytest.mark.parametrize('radii', RADII, ids=lambda r: f'{r[0]:g}-{r[1]:g}')
@pytest.mark.parametrize('name', sorted(STRUCTS))
def test_edges_match_numpy_and_jax(name, radii, prune):
    struct = STRUCTS[name]()
    if not name.startswith('cloud'):
        struct = make_box_numpy(struct, 10.0)
    got = generate_edges(struct, *radii, prune=prune)
    want = generate_edges_numpy(struct, *radii, prune=prune)
    _assert_structs_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert got[1].dtype == got[2].dtype == got[3].dtype == np.int32
    jax_struct, *jax_edges = fast_structs.edges_np(struct, *radii, prune)
    _assert_structs_equal(got[0], jax_struct)
    for g, w in zip(got[1:], jax_edges):
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) > 0
    if prune and name.startswith('cloud'):
        assert len(got[0]['bp']) < len(struct['bp'])   # far atoms pruned


def test_edges_grow_past_the_first_capacity(monkeypatch):
    """A dense cloud with more edges than the first capacity guess: the
    library reports the overflow and the wrapper retries larger."""
    monkeypatch.setattr(native, '_EDGES_PER_ATOM', 0)   # first cap 4096
    struct = _cloud(4, n_lig=60, n_rec=240, far=0)
    got = generate_edges(struct, 6.0, 6.0, prune=False)
    want = generate_edges_numpy(struct, 6.0, 6.0, prune=False)
    assert len(got[1]) > 4096
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('prune', [False, True])
def test_synthpharm_entities(prune):
    struct = dict(_cloud(3))
    struct['atom_id'] = np.where(struct['bp'] == 1, 1, 5)
    struct['bp'] = np.zeros_like(struct['bp'])   # replaced by atom_id
    got = generate_edges(struct, 4.0, 2.0, prune=prune, synthpharm=True)
    want = generate_edges_numpy(struct, 4.0, 2.0, prune=prune,
                                synthpharm=True)
    _assert_structs_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


ARGSORT_CASES = {
    'random': lambda rng: (rng.randint(0, 50, 3000), 50),
    'sorted_with_padding': lambda rng: (np.concatenate(
        [np.sort(rng.randint(0, 90, 500)), np.full(40, 100)]), 100),
    'all_equal': lambda rng: (np.full(77, 3), 3),
    'empty': lambda rng: (np.zeros(0, np.int64), 10),
    'single_id_range': lambda rng: (rng.randint(0, 2, 1000), 1),
}


@pytest.mark.parametrize('case', sorted(ARGSORT_CASES))
def test_counting_argsort_is_stable_argsort(case):
    ids, max_id = ARGSORT_CASES[case](np.random.RandomState(5))
    got = native.counting_argsort(ids, max_id)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.argsort(ids, kind='stable'))


@pytest.mark.parametrize('seed', [0, 1])
def test_lexsort_pairs_is_numpys_lexsort(seed):
    rng = np.random.RandomState(seed)
    rows, cols = rng.randint(0, 30, 2000), rng.randint(0, 30, 2000)
    got = native.lexsort_pairs(rows, cols, 29)
    np.testing.assert_array_equal(got, np.lexsort((cols, rows)))


def test_counting_argsort_refuses_ids_out_of_range():
    with pytest.raises(ValueError, match='outside'):
        native.counting_argsort(np.array([0, 5, 11]), 10)
    with pytest.raises(ValueError, match='outside'):
        native.counting_argsort(np.array([-1, 2]), 10)


_BUILD_IN = '''
from pointvs_tpu_torch.native import build
print(build.build())
'''


def test_two_processes_build_into_an_empty_directory(tmp_path):
    build_dir = tmp_path / 'build'
    env = dict(os.environ, POINTVS_NATIVE_CACHE=str(build_dir))
    procs = [subprocess.Popen([sys.executable, '-c', _BUILD_IN], cwd=REPO,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    built = sorted(p.name for p in build_dir.iterdir())
    assert built == [Path(paths.pop()).name]   # no temporary left behind


@pytest.mark.parametrize('cache', ['named', 'default'])
def test_the_library_lives_where_POINTVS_NATIVE_CACHE_says(
        tmp_path, monkeypatch, cache):
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    if cache == 'named':
        want = tmp_path / 'read_write' / 'native'
        monkeypatch.setenv('POINTVS_NATIVE_CACHE', str(want))
    else:
        want = tmp_path / 'home' / '.cache' / 'pointvs_tpu_torch' / 'native'
        monkeypatch.delenv('POINTVS_NATIVE_CACHE', raising=False)
    path = native.library_path()
    assert path.parent == want
    assert path.name.startswith('libgraphops-') and path.suffix == '.so'
    if cache == 'named':
        assert native.build() == path and path.exists()
        assert [p.name for p in want.iterdir()] == [path.name]
        assert ctypes.CDLL(str(path)).pvs_counting_argsort


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    broken = tmp_path / 'graphops.cpp'
    broken.write_text('extern "C" int pvs_box_filter( { }\n')
    monkeypatch.setattr(native, 'SRC', broken)
    monkeypatch.setenv('POINTVS_NATIVE_CACHE', str(tmp_path / 'build'))
    with pytest.raises(RuntimeError, match='(?s)g\\+\\+ failed.*error'):
        native.build()
    assert not list((tmp_path / 'build').iterdir())


def _numpy_graphs(monkeypatch):
    monkeypatch.setattr(dataset_mod, 'make_box', make_box_numpy)
    monkeypatch.setattr(dataset_mod, 'generate_edges', generate_edges_numpy)
    monkeypatch.setattr(dataset_mod, 'lexsort_pairs',
                        lambda rows, cols, _: np.lexsort((cols, rows)))


@pytest.mark.parametrize('prune', [False, True], ids=['keep', 'prune'])
def test_dataset_graphs_equal_the_numpy_path(tmp_path, monkeypatch, prune):
    types = tmp_path / 'set.types'
    types.write_text('1 -1 -1.0 rec_0.parquet lig_0.parquet\n'
                     '0 -1 -1.0 rec.parquet lig.parquet\n')
    kwargs = dict(radius=10, polar_hydrogens=False, edge_radius=4,
                  estimate_bonds=True, prune=prune)
    got = [dataset_mod.PointCloudDataset(RESOURCES, types, **kwargs)[i]
           for i in range(2)]
    _numpy_graphs(monkeypatch)
    want = [dataset_mod.PointCloudDataset(RESOURCES, types, **kwargs)[i]
            for i in range(2)]
    for g, w in zip(got, want):
        for field in ('node_feats', 'coords', 'senders', 'receivers',
                      'edge_attr'):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field), err_msg=field)
