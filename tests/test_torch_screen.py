"""Library screening in the port against the JAX package.

The screen's dataset (the port's ``PointCloudDataset``): on a library of
seeded poses of the test ligand in its pocket and the two test
complexes, every item has the JAX package's ``SharedReceptorDataset``
node features (array-equal), coordinates (within 1e-6), edge multiset
and receiver permutation, and the JAX ``PointCloudDataset``'s; its edges
are in (sender, receiver) lexical order. At the three radii of
``tests/test_shared_receptor.py`` and in each configuration the JAX
dataset takes its standard pipeline for (pruning, the whole-complex
rotation, the ``bp`` filter, ``edge_radius < 0``).
``_collect_ligands`` on a directory, a glob and one file, each absolute
and relative, a recursive glob, a size tie and a missing file gives the
reference's list, and the one-pass scan its size sort of it; the store
cache's key from the scan's fingerprints is the key that a stat of each
file gives, for the whole library and each stripe; a re-screen stats
each file once; ``single_item``'s batches equal the reference's.

The screen: ``pointvs_tpu_torch.screen.screen --device cpu`` against
``pointvs_tpu.screen.screen`` on the same run directory and a 5-ligand
library (three poses and two copies of one, so scores tie) at batch 2:
a pose run and a multitask ``--model_task both`` run (its newest
checkpoint, the affinity phase's, with the pose head), scores per ligand
within 1e-5, the CSV's columns and ranks; ``--attribute_top`` (the top
hits' attribution CSVs against the JAX screen's) and a
``--include_strain_info`` run (scored with dE = 0, as the JAX screen
does). Each refusal by name. ``num_devices=2`` (two spawned gloo ranks,
each a stripe of the library) on the resident, streaming and chunked
paths and with a strict-GraphNorm run (whose whole-batch statistics sum
over the ranks) against the JAX screen on 2 of the suite's XLA host
devices, within 1e-5, and the port's one-device CSV row for row. The
streaming screen in groups of POINTVS_SCREEN_GROUP=3 packed batches (five
batches: a group of 3 and one of 2), and scanned under
POINTVS_SCREEN_SCAN=1, gives the ungrouped scores exactly and the JAX
screen's within 1e-5.
"""
import csv
import os
import re
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from pointvs_tpu.data.dataset import PointCloudDataset as JaxDataset
from pointvs_tpu.data.shared_receptor import \
    SharedReceptorDataset as JaxSharedDataset
from pointvs_tpu.screen import _collect_ligands as jax_collect
from pointvs_tpu.screen import screen as jax_screen
from pointvs_tpu_torch import screen as port_screen
from pointvs_tpu_torch.data.dataset import PointCloudDataset
from pointvs_tpu_torch.main import main as port_main
from tests.setup_and_params import RESOURCES
from tests.test_torch_multitask import write_affinity_types

N_POSES = 3


def _rotation(rng, max_deg):
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    theta = np.deg2rad(rng.uniform(0, max_deg))
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def write_library(root: Path, n_poses=N_POSES, copies=2, seed=1):
    """Seeded rigid perturbations of the test ligand in its pocket, then
    ``copies`` byte copies of the first: ``root/lib/*.parquet``."""
    import pyarrow.parquet as pq
    rng = np.random.default_rng(seed)
    lig = pq.read_table(RESOURCES / 'lig_0.parquet')
    lib = root / 'lib'
    lib.mkdir(parents=True)
    xyz = np.stack([lig.column(c).to_numpy() for c in 'xyz'], axis=1)
    centre = xyz.mean(axis=0)
    for i in range(n_poses):
        new = ((xyz - centre) @ _rotation(rng, 40).T + centre
               + rng.standard_normal(3))
        table = lig
        for j, col in enumerate('xyz'):
            table = table.set_column(table.schema.get_field_index(col), col,
                                     [new[:, j]])
        pq.write_table(table, lib / f'pose_{i}.parquet')
    for i in range(copies):
        shutil.copy(lib / 'pose_0.parquet', lib / f'copy_{i}.parquet')
    return lib


@pytest.fixture(scope='module')
def library(tmp_path_factory):
    """(library dir, a types file of its poses against rec_0 and the two
    test complexes, its data root)."""
    root = tmp_path_factory.mktemp('screen_lib')
    lib = write_library(root)
    shutil.copy(RESOURCES / 'rec_0.parquet', lib / 'rec_0.parquet')
    shutil.copy(RESOURCES / 'rec.parquet', lib / 'rec.parquet')
    shutil.copy(RESOURCES / 'lig.parquet', lib / 'lig.parquet')
    lines = [f'{i % 2} -1 -1 rec_0.parquet {p.name}'
             for i, p in enumerate(sorted(lib.glob('pose_*.parquet')))]
    lines += ['1 -1 -1 rec.parquet lig.parquet',
              '0 -1 -1 rec_0.parquet copy_0.parquet']
    types = root / 'lib.types'
    types.write_text('\n'.join(lines) + '\n')
    return lib, types


def _edge_multiset(sample):
    cls = np.argmax(np.asarray(sample.edge_attr), axis=1)
    trip = np.stack([np.asarray(sample.senders),
                     np.asarray(sample.receivers), cls], axis=1)
    return sorted(map(tuple, trip.tolist()))


CASES = {
    'r6_e4': dict(radius=6, edge_radius=4, estimate_bonds=False),
    'r8_e4_bonds': dict(radius=8, edge_radius=4, estimate_bonds=True),
    'r4_e6': dict(radius=4, edge_radius=6, estimate_bonds=False),
    'prune': dict(radius=6, edge_radius=4, prune=True),
    'rotation': dict(radius=6, edge_radius=4, rot=True),
    'bp': dict(radius=6, edge_radius=4, bp=1),
    'no_edges': dict(radius=6, edge_radius=-1),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_items_match_jax_and_the_standard_pipeline(library, case):
    from pointvs_tpu_torch.data.single_item import \
        get_single_graph_for_inference
    lib, types = library
    common = dict(compact=True, polar_hydrogens=False,
                  model_task='classification', seed=3, **CASES[case])
    common.setdefault('rot', False)
    jax_ds = JaxSharedDataset(lib, types_fname=types, **common)
    jax_std = JaxDataset(lib, types_fname=types, **common)
    port = PointCloudDataset(lib, types, **common)
    assert len(port) == len(jax_std) == len(jax_ds) == N_POSES + 2
    for i in range(len(port)):
        got, wants = port[i], (jax_ds[i], jax_std[i])
        for want in wants:
            np.testing.assert_array_equal(got.node_feats,
                                          np.asarray(want.node_feats))
            np.testing.assert_allclose(got.coords, np.asarray(want.coords),
                                       atol=1e-6)
            assert _edge_multiset(got) == _edge_multiset(want)
        want = wants[0]
        s, r = got.senders, got.receivers
        if len(s) > 1:
            assert np.all((s[1:] > s[:-1])
                          | ((s[1:] == s[:-1]) & (r[1:] >= r[:-1])))
        batch = get_single_graph_for_inference(got)
        e = got.num_edges
        rb = batch.receivers[batch.recv_perm]
        assert np.all(rb[1:] >= rb[:-1])
        if want.recv_perm is not None:
            np.testing.assert_array_equal(batch.recv_perm[:e],
                                          np.asarray(want.recv_perm))
    if case == 'no_edges':
        assert port[0].num_edges == 0


def _size(path):
    """The JAX screen's size key: the file's size, 0 where it has none."""
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def _nested(lib, root):
    """Poses of ``lib`` copied into three directories under ``root``, a
    pose and its byte copy in two of them (a tie across directories)."""
    for rel, name in [('pose_0', 'pose_0'), ('a/pose_1', 'pose_1'),
                      ('a/b/pose_2', 'pose_2'), ('a/b/copy', 'copy_0')]:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(lib / f'{name}.parquet', root / f'{rel}.parquet')
    return str(root / '**' / '*.parquet')


COLLECT = {   # kind -> (the argument, from the library and a scratch
    # directory; whether it is relative to the library's parent; files)
    'dir': (lambda lib, tmp: str(lib), False, N_POSES + 5),
    'glob': (lambda lib, tmp: str(lib / 'pose_*.parquet'), False, N_POSES),
    'file': (lambda lib, tmp: str(lib / 'copy_1.parquet'), False, 1),
    'relative_dir': (lambda lib, tmp: lib.name, True, N_POSES + 5),
    'relative_glob': (lambda lib, tmp: f'{lib.name}/pose_*.parquet', True,
                      N_POSES),
    'recursive_glob': (_nested, False, 4),
    'size_tie': (lambda lib, tmp: str(lib / '[cp]o*_[01].parquet'), False,
                 4),
    'missing_file': (lambda lib, tmp: str(lib / 'absent.parquet'), False,
                     1),
}


@pytest.mark.parametrize('kind', sorted(COLLECT))
def test_collect_ligands_matches_jax(library, tmp_path, monkeypatch, kind):
    """The name-sorted list is the JAX package's, and the scan's order is
    the JAX screen's size sort of it (stable: ties keep name order)."""
    lib = library[0]
    make, relative, n = COLLECT[kind]
    arg = make(lib, tmp_path)
    if relative:
        monkeypatch.chdir(lib.parent)
    got = port_screen._collect_ligands(arg)
    assert got == jax_collect(arg)
    assert len(got) == n
    files, fingerprints, calls = port_screen._scan_library(
        arg, RESOURCES / 'rec_0.parquet')
    want = sorted(jax_collect(arg), key=_size)
    assert files == want and calls == n + 1
    assert [f[0] for f in fingerprints[1:]] == [_size(p) for p in want]
    if kind in ('size_tie', 'recursive_glob'):
        assert len(set(map(_size, want))) < n
    if kind == 'missing_file':
        assert fingerprints[1:] == [(0, 0)]


@pytest.mark.parametrize('relative', [False, True])
def test_stat_files_matches_a_stat_by_path(tmp_path, monkeypatch, relative):
    """One stat a file against its directory's descriptor gives what a
    stat by path gives, (0, 0) for a missing file and for one in a missing
    directory; relative paths against the working directory."""
    monkeypatch.chdir(tmp_path)
    paths = []
    for i in range(12):
        path = Path('a' if i % 3 else 'b', f'{i}.parquet')
        (tmp_path / path.parent).mkdir(exist_ok=True)
        (tmp_path / path).write_bytes(b'x' * i)
        paths.append(str(path if relative else tmp_path / path))
    paths.append(f'{tmp_path}/top.parquet' if not relative else 'top.parquet')
    (tmp_path / 'top.parquet').write_bytes(b'y')
    absent = ['a/absent', 'c/absent']
    paths += absent if relative else [f'{tmp_path}/{p}' for p in absent]
    fingerprints, calls = port_screen._stat_files(paths)
    assert calls == len(paths)
    want = [(st.st_size, st.st_mtime_ns) for st in map(os.stat, paths[:13])]
    assert fingerprints == want + [(0, 0), (0, 0)]


def _parent_store_cache_path(cache_dir, manifest, receptor, lig_files,
                             cmd_args, defaults):
    """The store cache's file as the screen named it when its key took a
    stat of each file itself (the formula that existing caches hold)."""
    import hashlib

    from pointvs_tpu_torch.data.device_dataset import STORE_FORMAT

    def fingerprint(path):
        try:
            st = os.stat(path)
            return st.st_size, st.st_mtime_ns
        except OSError:
            return 0, 0

    params = (manifest.read_text(),
              [fingerprint(p) for p in [receptor] + list(lig_files)],
              cmd_args.get('compact', True),
              cmd_args.get('radius', defaults['radius']),
              cmd_args.get('edge_radius', defaults['edge_radius']),
              cmd_args.get('estimate_bonds', defaults['estimate_bonds']),
              cmd_args.get('prune', False),
              cmd_args.get('use_atomic_numbers', False),
              cmd_args.get('hydrogens', False), STORE_FORMAT)
    digest = hashlib.sha1(repr(params).encode()).hexdigest()[:24]
    return Path(cache_dir) / f'torch_store_{digest}.bin'


@pytest.mark.parametrize('stripe', [None, 0, 1])
def test_store_cache_key_from_the_scan_matches_a_stat_a_file(
        library, tmp_path, stripe):
    """The key made from the scan's fingerprints names the file that a
    stat of each file names, for the whole library and each stripe of
    two ranks, so that caches users already hold are still hit."""
    lib = tmp_path / 'lib'
    shutil.copytree(library[0], lib)
    receptor = lib / 'rec_0.parquet'
    for i, path in enumerate(sorted(lib.iterdir())):
        os.utime(path, ns=(1_700_000_000_123_456_789 + i * 1_000_003,) * 2)
    files, fingerprints, _ = port_screen._scan_library(
        str(lib / '[cp]o*.parquet'), receptor)
    if stripe is not None:
        files = files[stripe::2]
        fingerprints = fingerprints[:1] + fingerprints[1:][stripe::2]
    manifest = tmp_path / 'stripe.types'
    manifest.write_text(''.join(f'{receptor} {lig}\n' for lig in files))
    args = (dict(radius=8, estimate_bonds=True),
            dict(radius=10, edge_radius=4, estimate_bonds=False))
    got = port_screen._store_cache_path(tmp_path, manifest, fingerprints,
                                        *args)
    assert got == _parent_store_cache_path(tmp_path, manifest, receptor,
                                           files, *args)


@pytest.mark.parametrize('pads', [(None, None), (512, 4096)],
                         ids=['buckets', 'given'])
def test_single_item_batches_match_jax(library, pads):
    from pointvs_tpu.data.single_item import \
        get_single_graph_for_inference as jax_single
    from pointvs_tpu.data.single_item import \
        graph_batch_from_arrays as jax_from_arrays
    from pointvs_tpu_torch.data.single_item import (
        get_single_graph_for_inference, graph_batch_from_arrays)
    lib, types = library
    common = dict(compact=True, polar_hydrogens=False, radius=6,
                  edge_radius=4, model_task='classification')
    sample = PointCloudDataset(lib, types, **common)[1]
    jax_sample = JaxDataset(lib, types_fname=types, **common)[1]
    n_pad, e_pad = pads
    pairs = [(get_single_graph_for_inference(sample, n_pad, e_pad),
              jax_single(jax_sample, n_pad, e_pad)),
             (graph_batch_from_arrays(
                 sample.node_feats, sample.coords, sample.senders,
                 sample.receivers, sample.edge_attr, y=1.0, n_pad=n_pad,
                 e_pad=e_pad),
              jax_from_arrays(
                  jax_sample.node_feats, jax_sample.coords,
                  jax_sample.senders, jax_sample.receivers,
                  jax_sample.edge_attr, y=1.0, n_pad=n_pad, e_pad=e_pad))]
    for got, want in pairs:
        assert got.graph_mask.shape == (1,)
        for name in ('node_feats', 'coords', 'node_mask', 'graph_id',
                     'senders', 'receivers', 'edge_attr', 'edge_mask',
                     'y', 'graph_mask', 'recv_perm'):
            np.testing.assert_array_equal(
                getattr(got, name), np.asarray(getattr(want, name)), name)


# ------------------------------------------------------------ screen
POSE_CLI = ['-ep', '1', '--layers', '2', '-k', '16', '-b', '2', '--compact',
            '--radius', '6', '--edge_radius', '4', '--estimate_bonds',
            '--egnn_attention', '--softmax_attention', '--device', 'cpu']


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """A pose run and a multitask --model_task both run, each trained one
    epoch by the port's CLI on the test complexes."""
    root = tmp_path_factory.mktemp('screen_runs')
    data = ['--train_data_root_pose', str(RESOURCES), '--train_types_pose',
            str(RESOURCES / 'test.types')]
    port_main(['egnn', str(root / 'pose')] + data + POSE_CLI)
    affinity = write_affinity_types(root / 'aff.types', n=4, seed=2)
    port_main(['multitask', str(root / 'multitask')] + data + [
        '--train_data_root_affinity', str(RESOURCES),
        '--train_types_affinity', str(affinity), '--model_task', 'both',
        '-ea', '1', '--final_softplus'] + POSE_CLI)
    return root


def _csv(path):
    with open(path, newline='', encoding='utf-8') as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize('run', ['pose', 'multitask'])
def test_screen_matches_jax(runs, library, tmp_path, run):
    lib = library[0]
    ligands = str(lib / '[pc]o*.parquet')
    want = jax_screen(runs / run, RESOURCES / 'rec_0.parquet', ligands,
                      output=str(tmp_path / 'jax.csv'), batch_size=2)
    got = port_screen.screen(runs / run, RESOURCES / 'rec_0.parquet',
                             ligands, output=str(tmp_path / 'port.csv'),
                             batch_size=2, device='cpu')
    rows = _csv(tmp_path / 'port.csv')
    assert list(rows[0]) == ['ligand', 'score', 'rank']
    assert [int(r['rank']) for r in rows] == list(range(1, 6))
    assert [float(r['score']) for r in rows] == sorted(
        (float(r['score']) for r in rows), reverse=True)
    by_ligand = {r['ligand']: float(r['score']) for r in rows}
    assert by_ligand == {r['ligand']: r['score'] for r in got.rows}
    jax_scores = dict(zip(want.ligand, want.score))
    assert sorted(by_ligand) == sorted(jax_scores)
    for lig, score in by_ligand.items():
        assert abs(score - jax_scores[lig]) <= 1e-5, lig
    copies = [by_ligand[str(lib / n)] for n in
              ('pose_0.parquet', 'copy_0.parquet', 'copy_1.parquet')]
    assert copies[0] == copies[1] == copies[2]
    assert len(set(by_ligand.values())) == N_POSES
    assert (tmp_path / 'port.types').read_text().count('\n') == 5
    assert set(got.seconds) == {'load', 'featurise', 'score', 'total'}
    assert got.path == 'resident'


def test_screen_cli_writes_the_ranked_csv(runs, library, tmp_path):
    out = tmp_path / 'hits.csv'
    result = port_screen.main([str(runs / 'pose'),
                               str(RESOURCES / 'rec_0.parquet'),
                               str(library[0] / 'pose_1.parquet'), '-o',
                               str(out), '-b', '4', '--device', 'cpu'])
    rows = _csv(out)
    assert len(rows) == len(result.rows) == 1
    assert rows[0]['rank'] == '1' and 0 <= float(rows[0]['score']) <= 1


def _run_with(runs, tmp_path, **cmd_args):
    run = tmp_path / 'run'
    shutil.copytree(runs / 'pose', run)
    saved = yaml.safe_load((run / 'cmd_args.yaml').read_text())
    saved.update(cmd_args)
    (run / 'cmd_args.yaml').write_text(yaml.dump(saved))
    return run


REFUSED = {
    'attribution_method': (dict(), dict(attribute_top=1,
                                        attribution='nope'), ValueError,
                           '--attribution must be one of'),
    'extended_atom_types': (dict(extended_atom_types=True), {}, ValueError,
                            '--extended_atom_types'),
    'synthpharm': (dict(synthpharm=True), {}, ValueError, '--synthpharm'),
    'pair_layout': (dict(model='siamese'), {}, ValueError, 'siamese'),
    'dense_layout': (dict(model='lie_conv'), {}, ValueError, 'lie_conv'),
}


@pytest.mark.parametrize('name', sorted(REFUSED))
def test_refusals_by_name(runs, library, tmp_path, monkeypatch, name):
    saved, kwargs, error, match = REFUSED[name]
    run = _run_with(runs, tmp_path, **saved)
    out = tmp_path / 'hits.csv'
    with pytest.raises(error, match=match):
        port_screen.screen(run, RESOURCES / 'rec_0.parquet',
                           str(library[0]), output=str(out), device='cpu',
                           **kwargs)
    assert not out.exists() and not out.with_suffix('.types').exists()


def test_cuda_without_a_gpu_raises(runs, library, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device cpu'):
        port_screen.main([str(runs / 'pose'),
                          str(RESOURCES / 'rec_0.parquet'),
                          str(library[0]), '-o', str(tmp_path / 'h.csv')])


@pytest.mark.parametrize('method', ['atom_masking', 'bond_masking',
                                    'edge_attention'])
def test_attribute_top_matches_jax(runs, library, tmp_path, method):
    """``--attribute_top 2``: the two best hits' attribution CSVs equal
    the JAX screen's (the scores within 2e-5, every other column
    exactly)."""
    ligands = str(library[0] / 'pose_*.parquet')   # no tied scores
    for name, fn, extra in (('jax', jax_screen, {}),
                            ('port', port_screen.screen,
                             {'device': 'cpu'})):
        fn(runs / 'pose', RESOURCES / 'rec_0.parquet', ligands,
           output=str(tmp_path / name / 'hits.csv'), batch_size=2,
           attribute_top=2, attribution=method, **extra)
    got_dir, want_dir = (tmp_path / name / 'top_hit_attributions'
                         for name in ('port', 'jax'))
    names = sorted(p.name for p in want_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == names
    assert len(names) == 2 and all(n.endswith(f'_{method}.csv')
                                   for n in names)
    for name in names:
        got, want = (pd.read_csv(d / name) for d in (got_dir, want_dir))
        assert list(got.columns) == list(want.columns)
        for col in want.columns:
            if col == 'attribution':
                np.testing.assert_allclose(got[col], want[col], atol=2e-5,
                                           rtol=0)
            else:
                np.testing.assert_array_equal(got[col], want[col])


@pytest.fixture(scope='module')
def strain_run(tmp_path_factory):
    """A run trained by the port's CLI with --include_strain_info."""
    root = tmp_path_factory.mktemp('screen_strain')
    types = root / 'strain.types'
    types.write_text(''.join(
        f'{i % 2} -1 -1.0 rec_0.parquet lig_0.parquet {3.5 + 4 * i:.1f} '
        f'0.{i + 1}\n' for i in range(4)))
    port_main(['egnn', str(root / 'run'), '--train_data_root_pose',
               str(RESOURCES), '--train_types_pose', str(types),
               '--include_strain_info'] + POSE_CLI)
    return root / 'run'


def test_strain_run_scores_with_zero_strain_like_jax(strain_run, library,
                                                     tmp_path):
    """A --include_strain_info run is scored with dE = 0, as the JAX
    screen scores it: the same scores within 1e-5."""
    ligands = str(library[0] / '[pc]o*.parquet')
    want = jax_screen(strain_run, RESOURCES / 'rec_0.parquet', ligands,
                      output=str(tmp_path / 'jax.csv'), batch_size=2)
    got = port_screen.screen(strain_run, RESOURCES / 'rec_0.parquet',
                             ligands, output=str(tmp_path / 'port.csv'),
                             batch_size=2, device='cpu')
    jax_scores = dict(zip(want.ligand, want.score))
    assert len(got.rows) == len(jax_scores) == 5
    for row in got.rows:
        assert abs(row['score'] - jax_scores[row['ligand']]) <= 1e-5


def _scores(result):
    return {r['ligand']: r['score'] for r in result.rows}


SCREEN_PATHS = {
    'streaming': (dict(POINTVS_SCREEN_DEVICE='0'), 'streaming'),
    'chunked_exact': (dict(POINTVS_SCREEN_CHUNK_MB='0.02',
                           POINTVS_CHUNK_COORDS16='0'), 'chunked'),
    'chunked_coords16': (dict(POINTVS_SCREEN_CHUNK_MB='0.02'), 'chunked'),
    'chunked_half': (dict(POINTVS_SCREEN_CHUNK_MB='0.02',
                          POINTVS_SCREEN_CHUNK_RAW='0'), 'chunked'),
}


@pytest.mark.parametrize('name', sorted(SCREEN_PATHS))
def test_screen_paths_match_jax(runs, library, tmp_path, monkeypatch, name):
    """The streaming and chunked paths of the port give the JAX screen's
    scores within 1e-5: the JAX package's resident scores, and with
    coords16 (lossy) its own chunked scores under the same variables. At
    0.02 MB the five poses go to the device in at least 3 chunks, scored
    in budget batches of at most 2 poses. Under
    POINTVS_SCREEN_CHUNK_RAW=0 the chunks carry half edge lists, and the
    CSV equals the port's resident screen's within 1e-5."""
    env, path = SCREEN_PATHS[name]
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setenv('POINTVS_SCREEN_MAX_BS', '2')
    plans = []

    def plan_chunks(*args, **kwargs):
        plans.append(real_plan(*args, **kwargs))
        return plans[-1]

    real_plan = port_screen.plan_chunks
    monkeypatch.setattr(port_screen, 'plan_chunks', plan_chunks)
    ligands = str(library[0] / '[pc]o*.parquet')
    got = port_screen.screen(runs / 'pose', RESOURCES / 'rec_0.parquet',
                             ligands, output=str(tmp_path / 'port.csv'),
                             batch_size=2, device='cpu')
    assert got.path == path and len(got.rows) == 5
    assert len(plans) == (path == 'chunked')
    assert all(len(ranges) >= 3 for ranges, _ in plans)
    assert all(spec.raw == (name != 'chunked_half') for _, spec in plans)
    if name != 'chunked_coords16':
        monkeypatch.delenv('POINTVS_SCREEN_CHUNK_MB', raising=False)
        monkeypatch.delenv('POINTVS_SCREEN_DEVICE', raising=False)
    want = jax_screen(runs / 'pose', RESOURCES / 'rec_0.parquet', ligands,
                      output=str(tmp_path / 'jax.csv'), batch_size=2)
    jax_scores = dict(zip(want.ligand, want.score))
    scores = _scores(got)
    assert sorted(scores) == sorted(jax_scores)
    for lig, score in scores.items():
        assert abs(score - jax_scores[lig]) <= 1e-5, lig
    if name == 'chunked_half':
        monkeypatch.delenv('POINTVS_SCREEN_CHUNK_RAW')
        resident = port_screen.screen(
            runs / 'pose', RESOURCES / 'rec_0.parquet', ligands,
            output=str(tmp_path / 'resident.csv'), batch_size=2,
            device='cpu')
        assert resident.path == 'resident'
        half_csv = pd.read_csv(tmp_path / 'port.csv')
        resident_csv = pd.read_csv(tmp_path / 'resident.csv')
        assert list(half_csv.ligand) == list(resident_csv.ligand)
        assert list(half_csv['rank']) == list(resident_csv['rank'])
        np.testing.assert_allclose(half_csv.score, resident_csv.score,
                                   rtol=0, atol=1e-5)


STREAM_GROUPS = {'grouped': {}, 'scanned': {'POINTVS_SCREEN_SCAN': '1'}}


@pytest.mark.parametrize('name', sorted(STREAM_GROUPS))
def test_grouped_streaming_screen_matches_ungrouped_and_jax(
        runs, library, tmp_path, monkeypatch, name):
    """The streaming screen's groups: five batches of one pose in groups of
    POINTVS_SCREEN_GROUP=3 (one copy each of 3 and 2 batches; under
    POINTVS_SCREEN_SCAN=1, which streams even with the resident store on,
    the short last group is padded to 3 by repeating its last buffer) give
    the ungrouped screen's scores exactly and the JAX screen's within
    1e-5."""
    ligands = str(library[0] / '[pc]o*.parquet')
    monkeypatch.setenv('POINTVS_SCREEN_DEVICE', '0')
    monkeypatch.setenv('POINTVS_SCREEN_GROUP', '1')
    one = port_screen.screen(runs / 'pose', RESOURCES / 'rec_0.parquet',
                             ligands, output=str(tmp_path / 'one.csv'),
                             batch_size=1, device='cpu')
    if name == 'scanned':
        monkeypatch.delenv('POINTVS_SCREEN_DEVICE')
    for var, value in STREAM_GROUPS[name].items():
        monkeypatch.setenv(var, value)
    monkeypatch.setenv('POINTVS_SCREEN_GROUP', '3')
    copies = []

    def upload(host, device):
        copies.append(len(host))
        return real_upload(host, device)

    real_upload = port_screen.upload
    monkeypatch.setattr(port_screen, 'upload', upload)
    grouped = port_screen.screen(runs / 'pose', RESOURCES / 'rec_0.parquet',
                                 ligands, output=str(tmp_path / 'g.csv'),
                                 batch_size=1, device='cpu')
    assert one.path == grouped.path == 'streaming'
    assert copies == ([3, 3] if name == 'scanned' else [3, 2])
    assert _scores(grouped) == _scores(one)
    for var in ('POINTVS_SCREEN_DEVICE', 'POINTVS_SCREEN_SCAN',
                'POINTVS_SCREEN_GROUP'):
        monkeypatch.delenv(var, raising=False)
    want = jax_screen(runs / 'pose', RESOURCES / 'rec_0.parquet', ligands,
                      output=str(tmp_path / 'jax.csv'), batch_size=1)
    jax_scores = dict(zip(want.ligand, want.score))
    scores = _scores(grouped)
    assert sorted(scores) == sorted(jax_scores)
    for lig, score in scores.items():
        assert abs(score - jax_scores[lig]) <= 1e-5, lig


def test_store_cache_reloads_and_invalidates(runs, tmp_path):
    """``--cache_dir`` keeps the built store: a second screen loads it
    (same scores, no new file), and a ligand rewritten at its path gives a
    new store and another score."""
    import pandas as pd
    lib = tmp_path / 'lib'
    lib.mkdir()
    shutil.copy(RESOURCES / 'lig_0.parquet', lib / 'lig.parquet')
    cache = tmp_path / 'cache'

    def run(tag):
        return port_screen.screen(
            runs / 'pose', RESOURCES / 'rec_0.parquet', str(lib),
            output=str(tmp_path / f'{tag}.csv'), batch_size=2,
            cache_dir=str(cache), device='cpu')

    first = run('a')
    stores = set(cache.glob('torch_store_*.bin'))
    assert len(stores) == 1 and first.path == 'resident'
    again = run('b')
    assert _scores(again) == _scores(first)
    assert set(cache.glob('torch_store_*.bin')) == stores
    frame = pd.read_parquet(lib / 'lig.parquet')
    # Not rigid: a rigid move would not change an E(3)-invariant score.
    frame['x'] = frame['x'] + np.linspace(0, 2.0, len(frame))
    frame.to_parquet(lib / 'lig.parquet')
    changed = run('c')
    assert len(set(cache.glob('torch_store_*.bin'))) == 2
    assert _scores(changed) != _scores(first)


def test_rescreen_stats_each_file_once(runs, tmp_path, monkeypatch):
    """A re-screen of 64 files from ``--cache_dir`` makes 65 stat calls
    on the library and the receptor, by path or by name against a
    directory descriptor (``os.stat`` and ``os.path.getsize``): one a file,
    as the screen's log line counts them."""
    lib = tmp_path / 'lib'
    lib.mkdir()
    for i in range(64):
        shutil.copy(RESOURCES / 'lig_0.parquet', lib / f'lig_{i:02d}.parquet')
    receptor = tmp_path / 'rec_0.parquet'
    shutil.copy(RESOURCES / 'rec_0.parquet', receptor)
    targets = {os.path.realpath(p) for p in [receptor, *lib.iterdir()]}
    job = dict(model_path=runs / 'pose', receptor=receptor,
               ligands=str(lib / 'lig_*.parquet'),
               output=str(tmp_path / 'hits.csv'), batch_size=32,
               cache_dir=str(tmp_path / 'cache'), device='cpu')
    port_screen.screen(**job)   # featurises the library, caches the store
    real_stat = os.stat
    counted, logged = [], []

    def target(path, dir_fd):
        path = os.fsdecode(os.fspath(path))
        if dir_fd is not None:
            path = os.path.join(os.readlink(f'/proc/self/fd/{dir_fd}'), path)
        return os.path.realpath(path)

    def stat(path, *, dir_fd=None, follow_symlinks=True):
        if not isinstance(path, int) and target(path, dir_fd) in targets:
            counted.append(path)
        return real_stat(path, dir_fd=dir_fd, follow_symlinks=follow_symlinks)

    def getsize(path):
        if target(path, None) in targets:
            counted.append(path)
        return real_stat(path).st_size

    monkeypatch.setattr(os, 'stat', stat)
    monkeypatch.setattr(os.path, 'getsize', getsize)
    monkeypatch.setattr(port_screen.LOG, 'info', logged.append)
    result = port_screen.screen(**job)
    monkeypatch.undo()
    assert result.path == 'resident' and len(result.rows) == 64
    assert len(counted) == 65
    line = next(m for m in logged if m.startswith('Screening 64 ligands'))
    assert int(re.search(r'\((\d+) stat calls', line).group(1)) == 65


SCREEN_DP = {   # name -> (environment, ligand glob, strict GraphNorm)
    'resident': ({}, '[pc]o*.parquet', False),
    'streaming': (dict(POINTVS_SCREEN_DEVICE='0'), '[pc]o*.parquet', False),
    'chunked': (dict(POINTVS_SCREEN_CHUNK_MB='0.02',
                     POINTVS_CHUNK_COORDS16='0'), '[pc]o*.parquet', False),
    # 4 poses at batch 2: no partial batch, whose placeholder row the
    # reference fills with one real node.
    'strict_graphnorm': ({}, '[pc]o*_[01].parquet', True),
}


@pytest.mark.parametrize('name', sorted(SCREEN_DP))
def test_screen_two_ranks_match_jax(runs, library, tmp_path, monkeypatch,
                                    name):
    env, pattern, strict = SCREEN_DP[name]
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    run = runs / 'pose'
    if strict:
        run = tmp_path / 'strict'
        port_main(['egnn', str(run), '--train_data_root_pose',
                   str(RESOURCES), '--train_types_pose',
                   str(RESOURCES / 'test.types'), '--graphnorm',
                   '--strict_graphnorm'] + POSE_CLI)
        kwargs = yaml.safe_load((run / 'model_kwargs.yaml').read_text())
        assert kwargs['graphnorm'] and kwargs['graphnorm_whole_batch']
    ligands = str(library[0] / pattern)
    two = port_screen.screen(run, RESOURCES / 'rec_0.parquet', ligands,
                             output=str(tmp_path / 'two.csv'), batch_size=2,
                             num_devices=2, device='cpu')
    one = port_screen.screen(run, RESOURCES / 'rec_0.parquet', ligands,
                             output=str(tmp_path / 'one.csv'), batch_size=2,
                             device='cpu')
    assert two.path == one.path
    got, want = _csv(tmp_path / 'two.csv'), _csv(tmp_path / 'one.csv')
    assert [r['ligand'] for r in got] == [r['ligand'] for r in want]
    for g, w in zip(got, want):
        assert abs(float(g['score']) - float(w['score'])) <= 1e-6
    assert (tmp_path / 'two.types').read_text() == \
        (tmp_path / 'one.types').read_text()
    for var in env:
        monkeypatch.delenv(var)
    ref = jax_screen(run, RESOURCES / 'rec_0.parquet', ligands,
                     output=str(tmp_path / 'jax.csv'), batch_size=2,
                     num_devices=2)
    jax_scores = dict(zip(ref.ligand, ref.score))
    scores = _scores(two)
    assert sorted(scores) == sorted(jax_scores)
    for lig, score in scores.items():
        assert abs(score - jax_scores[lig]) <= 1e-5, lig
