"""The port's dataset-generation tools against the JAX package's, on the
CPU: the same inputs through both, the outputs compared.

- ``synthetic_affinity``: the five cases of ``test_synthetic_affinity.py``
  (contact scores on the resource pair, rotated, pulled out of the pocket
  and retyped; the pK map; a written types file), equal to JAX's.
- ``replicate_poses``: a training set and a screen library from a small
  tree laid out from ``tests/resources``, the same ``--seed``: types files
  and file names equal, coordinates within 1e-12.
- ``data/gninatypes``: a ``.gninatypes`` file written from seeded arrays
  (``struct.pack('fffi', ...)``) converted by both; equal frames.
- ``generate_types_file``: RMSDs without ``obrms`` on docked copies of
  ``7zzp_lig_0.sdf``, the PDBBind indexes, every mode of
  ``generate_types_str`` and ``main`` on a written tree: equal text.
- ``dir_based_to_types``, ``planar_check``, ``split_by_cdhit_output``:
  written layouts, seeded frames and a written ``.clstr``: equal results.
- ``protein_clustering``: the FASTA filter and the decontamination on
  written files; ``main`` with ``cd-hit-2d`` stubbed.
- ``ligand_clustering``, ``strain_energy``: without RDKit both packages
  fail alike, naming it.
- Each tool's CLI: ``--help`` exits 0 with the reference's usage line.
"""
import importlib
import random
import shutil
import struct
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from pointvs_tpu.data import gninatypes as jax_gninatypes
from pointvs_tpu.data.preprocessing import random_rotation_matrix
from pointvs_tpu.dataset_generation import dir_based_to_types as jax_dirtypes
from pointvs_tpu.dataset_generation import generate_types_file as jax_gtf
from pointvs_tpu.dataset_generation import ligand_clustering as jax_ligclust
from pointvs_tpu.dataset_generation import planar_check as jax_planar
from pointvs_tpu.dataset_generation import protein_clustering as jax_protclust
from pointvs_tpu.dataset_generation import replicate_poses as jax_replicate
from pointvs_tpu.dataset_generation import split_by_cdhit_output as jax_cdhit
from pointvs_tpu.dataset_generation import strain_energy as jax_strain
from pointvs_tpu.dataset_generation import synthetic_affinity as jax_synth
from pointvs_tpu_torch.data import gninatypes
from pointvs_tpu_torch.data.types_files import parse_regression_types
from pointvs_tpu_torch.dataset_generation import (
    dir_based_to_types,
    generate_types_file,
    ligand_clustering,
    planar_check,
    protein_clustering,
    replicate_poses,
    split_by_cdhit_output,
    strain_energy,
    synthetic_affinity,
)

RESOURCES = Path(__file__).parent / 'resources'
SEED = 16


def _frames():
    return (pd.read_parquet(RESOURCES / 'rec_0.parquet'),
            pd.read_parquet(RESOURCES / 'lig_0.parquet'))


def _moved(rec, lig, case):
    if case == 'rotated':
        rng = np.random.RandomState(0)
        m, t = random_rotation_matrix(rng), rng.normal(size=3) * 10
        rec, lig = rec.copy(), lig.copy()
        for df in (rec, lig):
            df[['x', 'y', 'z']] = df[['x', 'y', 'z']].to_numpy() @ m + t
    elif case == 'pulled':
        lig = lig.copy()
        lig[['x', 'y', 'z']] += 5.0
    elif case == 'retyped':
        lig = lig.copy()
        lig['types'] = (lig['types'].to_numpy() + 1) % 14
    return rec, lig


# -- synthetic_affinity ------------------------------------------------ #
@pytest.mark.parametrize('case', ['resource', 'rotated', 'pulled',
                                  'retyped'])
def test_contact_score_equals_jax(case):
    rec, lig = _frames()
    base = synthetic_affinity.contact_score(rec, lig)
    assert base > 0 and base == synthetic_affinity.contact_score(rec, lig)
    rec, lig = _moved(rec, lig, case)
    got = synthetic_affinity.contact_score(rec, lig)
    assert got == jax_synth.contact_score(rec, lig)
    if case == 'rotated':
        assert got == pytest.approx(base, rel=1e-9)
    elif case != 'resource':
        assert got != pytest.approx(base, rel=1e-3)


def test_scores_to_pk_equals_jax():
    s = np.array([0.0, 1.0, 10.0, 1e6])
    pk = synthetic_affinity.scores_to_pk(s, s0=10.0, pk_max=12.0)
    np.testing.assert_array_equal(pk, jax_synth.scores_to_pk(s, 10.0, 12.0))
    assert (pk >= 0).all() and (pk < 12).all() and (np.diff(pk) > 0).all()
    assert pk[2] == pytest.approx(6.0)


@pytest.mark.parametrize('s0', [None, 3.5])
def test_make_types_writes_jaxs_file(tmp_path, s0):
    args = (RESOURCES, RESOURCES / 'test.types')
    got = synthetic_affinity.make_types(*args, tmp_path / 'port.types', s0=s0)
    want = jax_synth.make_types(*args, tmp_path / 'jax.types', s0=s0)
    assert got.read_bytes() == want.read_bytes()
    entries = parse_regression_types(RESOURCES, got)
    assert len(entries.ligands) == 2
    assert entries.pki[0] == -1 and entries.ic50[0] == -1
    if s0 is None:   # one pose twice: s0 = median(S) -> pk_max / 2
        assert entries.pkd[0] == entries.pkd[1] == pytest.approx(6.0,
                                                                 abs=1e-3)


# -- replicate_poses --------------------------------------------------- #
@pytest.fixture(scope='module')
def source_tree(tmp_path_factory):
    """receptors/rec_0.parquet, ligands/rec_0_{actives,decoys}/lig_*.parquet
    and a types file over them."""
    root = tmp_path_factory.mktemp('source')
    (root / 'receptors').mkdir()
    shutil.copy(RESOURCES / 'rec_0.parquet', root / 'receptors')
    for sub, name in (('rec_0_actives', 'lig_0'), ('rec_0_decoys', 'lig_1')):
        (root / 'ligands' / sub).mkdir(parents=True)
        shutil.copy(RESOURCES / 'lig_0.parquet',
                    root / 'ligands' / sub / f'{name}.parquet')
    (root / 'src.types').write_text(
        '1 -1 -1.0 receptors/rec_0.parquet '
        'ligands/rec_0_actives/lig_0.parquet\n'
        '0 -1 -1.0 receptors/rec_0.parquet '
        'ligands/rec_0_decoys/lig_1.parquet\n')
    return root


def _coords(path):
    return pd.read_parquet(path)[['x', 'y', 'z']].to_numpy()


@pytest.mark.parametrize('mode', ['train', 'screen'])
def test_replicate_poses_equals_jax(tmp_path, source_tree, mode):
    outs = {}
    for name, module in (('port', replicate_poses), ('jax', jax_replicate)):
        out = tmp_path / name
        if mode == 'train':
            module.main(['train', str(source_tree),
                         str(source_tree / 'src.types'), str(out),
                         '--copies', '3', '--seed', str(SEED)])
        else:
            module.main(['screen', str(source_tree), 'rec_0', str(out),
                         '--n_poses', '5', '--seed', str(SEED)])
        outs[name] = out
    files = {k: sorted(p.relative_to(v) for p in v.rglob('*.parquet'))
             for k, v in outs.items()}
    assert files['port'] == files['jax']
    assert len(files['port']) == (6 if mode == 'train' else 5)
    if mode == 'train':
        assert ((outs['port'] / 'scale.types').read_bytes()
                == (outs['jax'] / 'scale.types').read_bytes())
        assert (outs['port'] / 'receptors').resolve() == (
            source_tree / 'receptors')
    src = _coords(RESOURCES / 'lig_0.parquet')
    for rel in files['port']:
        got, want = _coords(outs['port'] / rel), _coords(outs['jax'] / rel)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert not np.allclose(got, src)   # every copy really moved
        np.testing.assert_allclose(   # rigid: pairwise distances kept
            np.linalg.norm(got[:, None] - got[None], axis=-1),
            np.linalg.norm(src[:, None] - src[None], axis=-1), atol=1e-9)


# -- data/gninatypes --------------------------------------------------- #
@pytest.mark.parametrize('structure_type', ['receptor', 'ligand'])
def test_gninatypes_cli_equals_jax(tmp_path, structure_type):
    rng = np.random.RandomState(SEED)
    xyz = rng.normal(scale=8, size=(37, 3)).astype(np.float32)
    types = rng.randint(0, 14, size=37)
    src = tmp_path / 'src' / 'target'
    src.mkdir(parents=True)
    with open(src / 'pose_0.gninatypes', 'wb') as f:
        for (x, y, z), t in zip(xyz, types):
            f.write(struct.pack('fffi', x, y, z, t))
    frames = {}
    for name, module in (('port', gninatypes), ('jax', jax_gninatypes)):
        module.main([str(tmp_path / 'src'), str(tmp_path / name),
                     structure_type])
        frames[name] = pd.read_parquet(
            tmp_path / name / 'target' / 'pose_0.parquet')
    pd.testing.assert_frame_equal(frames['port'], frames['jax'])
    np.testing.assert_array_equal(frames['port'][['x', 'y', 'z']], xyz)
    offset = 14 if structure_type == 'receptor' else 0
    np.testing.assert_array_equal(frames['port']['types'], types + offset)


def test_gninatypes_type_map_equals_jax():
    assert gninatypes.get_type_map() == jax_gninatypes.get_type_map()


# -- generate_types_file ----------------------------------------------- #
def _docked_sdf(path, n_poses, seed):
    """``n_poses`` seeded perturbations of the 7zzp ligand in one sdf."""
    lines = (RESOURCES / '7zzp_lig_0.sdf').read_text().split('$$$$')[0] \
        .rstrip('\n').splitlines()
    n_atoms = int(lines[3][:3])
    rng = np.random.RandomState(seed)
    blocks = []
    for _ in range(n_poses):
        out = list(lines)
        for i in range(4, 4 + n_atoms):
            xyz = np.array([float(out[i][k:k + 10]) for k in (0, 10, 20)])
            xyz += rng.normal(scale=1.2, size=3)
            out[i] = ''.join(f'{c:10.4f}' for c in xyz) + out[i][30:]
        blocks.append('\n'.join(out) + '\n$$$$\n')
    path.write_text(''.join(blocks))
    return path


@pytest.fixture(scope='module')
def pdbbind_tree(tmp_path_factory):
    """Targets with a receptor, a crystal pose and docked poses; a target
    with actives and inactives; the two PDBBind index layouts."""
    root = tmp_path_factory.mktemp('pdbbind')
    for pdbid, n_docked in (('1abc', 4), ('2xyz', 3)):
        target = root / 'tree' / pdbid
        target.mkdir(parents=True)
        (target / f'{pdbid}_receptor.pdb').write_text('')
        shutil.copy(RESOURCES / '7zzp_lig_0.sdf', target / f'{pdbid}_ligand.sdf')
        _docked_sdf(target / f'{pdbid}_docked.sdf', n_docked, SEED + n_docked)
    screen = root / 'screen' / '3def'
    screen.mkdir(parents=True)
    (screen / '3def_receptor.pdb').write_text('')
    _docked_sdf(screen / 'actives.sdf', 2, SEED)
    _docked_sdf(screen / 'inactives.sdf', 3, SEED + 1)
    (root / 'index_2020.txt').write_text(
        '# ' + '=' * 70 + '\n'
        '# List of the protein-ligand complexes with known binding data\n'
        '# PDB code, resolution, release year, -logKd/Ki, Kd/Ki, reference, '
        'ligand name\n'
        '1abc  2.20  2012   6.40  Kd=400nM      // 1abc.pdf (NLG)\n'
        '2xyz  1.90  2015   4.10  IC50=79uM     // 2xyz.pdf (ABC)\n'
        '9zzz  2.50  2001   3.00  Ki=1mM        // 9zzz.pdf (ZZZ)\n')
    (root / 'index_2016.csv').write_text(
        'ID,PDB code,Subset,Affinity Data,pKd pKi pIC50,Ligand Name\n'
        '1,1abc,refined,Ki=12nM,7.92,NLG\n'
        '2,2xyz,general,Kd~3uM,5.52,ABC\n')
    return root


def test_get_rmsd_without_obrms_equals_jax(pdbbind_tree, monkeypatch):
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    target = pdbbind_tree / 'tree' / '1abc'
    args = (target / '1abc_ligand.sdf', target / '1abc_docked.sdf')
    got = generate_types_file.get_rmsd(*args)
    assert got == jax_gtf.get_rmsd(*args)
    assert len(got) == 4 and all(r > 0 for r in got)
    assert generate_types_file.get_rmsd(args[0], args[0]) == [0.0]
    intra = generate_types_file.get_intra_rmsd(args[1])
    assert intra == jax_gtf.get_intra_rmsd(args[1])
    assert sorted(intra) == [(i, j) for i in range(4) for j in range(i + 1, 4)]


@pytest.mark.parametrize('layout', ['index_2020.txt', 'index_2016.csv'])
def test_pdbbind_affinities_equal_jax(pdbbind_tree, layout):
    got = generate_types_file.extract_pdbbind_affinities(
        pdbbind_tree / layout)
    pd.testing.assert_frame_equal(
        got, jax_gtf.extract_pdbbind_affinities(pdbbind_tree / layout))
    if layout == 'index_2020.txt':
        assert list(got.pdbid) == ['1abc', '2xyz', '9zzz']
        assert list(got.metric) == ['pkd', 'pic50', 'pki']


TYPES_MODES = {
    'docked': dict(tree='tree', pdb_exp=r'.*_receptor\.pdb',
                   crystal_exp=r'.*_ligand\.sdf',
                   docked_exp=r'.*_docked\.sdf'),
    'actives': dict(tree='screen', pdb_exp=r'.*_receptor\.pdb',
                    active_exp=r'actives\.sdf',
                    inactive_exp=r'inactives\.sdf'),
    'affinity': dict(tree='tree', pdb_exp=r'.*_receptor\.pdb',
                     crystal_exp=r'.*_ligand\.sdf'),
}


@pytest.mark.parametrize('mode', sorted(TYPES_MODES))
def test_generate_types_str_equals_jax(pdbbind_tree, monkeypatch, mode):
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    kwargs = dict(TYPES_MODES[mode])
    tree = pdbbind_tree / kwargs.pop('tree')
    if mode == 'affinity':
        adf = generate_types_file.extract_pdbbind_affinities(
            pdbbind_tree / 'index_2020.txt')
        kwargs['affinity_dict'] = {p: (a, m) for p, a, m in zip(
            adf.pdbid, adf.affinity, adf.metric)}
    for target in sorted(p for p in tree.iterdir()):
        got = generate_types_file.generate_types_str(target, **kwargs)
        assert got == jax_gtf.generate_types_str(target, **kwargs)
        assert got.count(target.name) >= 2
    assert generate_types_file.generate_types_str(
        tree / target.name, r'nothing\.pdb') == -1


@pytest.mark.parametrize('split_sdfs', [False, True], ids=['joined', 'split'])
def test_generate_types_file_cli_equals_jax(tmp_path, pdbbind_tree,
                                            monkeypatch, split_sdfs):
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    flags = ['-r', r'.*_receptor\.pdb', '-x', r'.*_ligand\.sdf',
             '-d', r'.*_docked\.sdf'] + (['-s'] if split_sdfs else [])
    texts = {}
    for name, module in (('port', generate_types_file), ('jax', jax_gtf)):
        out = tmp_path / name / 'types'
        module.main([str(pdbbind_tree / 'tree'), str(out), *flags])
        texts[name] = (out / f'{name}.types').read_bytes()
    assert texts['port'] == texts['jax']
    # Crystal + docked rows of two targets; without -s the reference joins
    # the first target's last row to the next target's first, as here.
    assert len(texts['port'].splitlines()) == 2 + 4 + 3 - (not split_sdfs)


# -- dir_based_to_types, planar_check, split_by_cdhit_output ----------- #
CLSTR = ('>Cluster 0\n0\t300aa, >1abc_A... *\n1\t290aa, >2def_B... at 95%\n'
         '>Cluster 1\n0\t250aa, >3ghi_A... *\n1\t250aa, >1abc_C... at 91%\n'
         '>Cluster 2\n0\t120aa, >4jkl_A... *\n'
         '>Cluster 3\n0\t220aa, >5mno_A... *\n1\t210aa, >6pqr_A... at 93%\n'
         '>Cluster 4\n0\t90aa, >7stu_B... *\n')


def _layout(root, with_rmsds):
    root.mkdir()
    (root / 'receptors').mkdir()
    for rec in ('rec0', 'rec1'):
        shutil.copy(RESOURCES / 'rec_0.parquet',
                    root / 'receptors' / f'{rec}.parquet')
        for kind in ('actives', 'decoys'):
            sub = root / 'ligands' / f'{rec}_{kind}'
            sub.mkdir(parents=True)
            for i in range(2):
                shutil.copy(RESOURCES / 'lig_0.parquet',
                            sub / f'{rec}_{kind}_{i}.parquet')
    if with_rmsds:
        (root / 'rmsd_info.yaml').write_text(
            'rec0:\n  docked_wrt_crystal:\n    0: 0.5\n    1: 3.25\n')
    return root


def _planar_frames(tmp_path):
    rng = np.random.RandomState(SEED)
    flat = rng.normal(scale=5, size=(40, 3))
    flat[:, 2] = 1e-5 * rng.normal(size=40)
    m = random_rotation_matrix(rng)
    frames = {'flat': flat @ m, 'bulky': rng.normal(scale=5, size=(40, 3)),
              'three_atoms': rng.normal(size=(3, 3))}
    paths = {}
    for name, xyz in frames.items():
        paths[name] = tmp_path / f'{name}.parquet'
        pd.DataFrame(xyz, columns=['x', 'y', 'z']).to_parquet(paths[name])
    return paths


@pytest.mark.parametrize('case', ['dir_types', 'dir_types_rmsd', 'planar',
                                  'cdhit_graph', 'cdhit_split',
                                  'cdhit_cli'])
def test_small_tools_equal_jax(tmp_path, monkeypatch, case):
    if case.startswith('dir_types'):
        root = _layout(tmp_path / 'set', case.endswith('rmsd'))
        got = dir_based_to_types.directory_to_types(root)
        assert got == jax_dirtypes.directory_to_types(root)
        assert len(got.splitlines()) == 8 and got.startswith('1 ')
        dir_based_to_types.main([str(root), '-o', str(tmp_path / 'port')])
        assert (tmp_path / 'port.types').read_text() == got
        if case.endswith('rmsd'):
            assert ' 3.25 receptors/rec0.parquet' in got
    elif case == 'planar':
        paths = _planar_frames(tmp_path)
        got = {k: planar_check.check_parquet(p) for k, p in paths.items()}
        assert got == {k: jax_planar.check_parquet(p)
                       for k, p in paths.items()}
        assert got == {'flat': True, 'bulky': False, 'three_atoms': True}
        planar_check.main([str(tmp_path)])
    elif case.startswith('cdhit'):
        (tmp_path / 'set.out.clstr').write_text(CLSTR)
        graph = split_by_cdhit_output.cdhit_output_to_graph(
            tmp_path / 'set.out.clstr')
        want = jax_cdhit.cdhit_output_to_graph(tmp_path / 'set.out.clstr')
        assert graph == want
        assert split_by_cdhit_output.bfs(graph, '2def') == {
            '1abc', '2def', '3ghi'}
        if case == 'cdhit_split':
            for seed in (0, 1, 2):
                got = split_by_cdhit_output.generate_split(graph, 0.6, seed)
                assert got == jax_cdhit.generate_split(want, 0.6, seed)
                assert got.train | got.val == set(graph)
                assert len(got.val) >= 0.4 * len(graph)
                for node in got.val:   # no cluster straddles the split
                    assert not set(graph[node]) & got.train
        elif case == 'cdhit_cli':
            # The CLI draws unseeded: seed both packages' draws alike.
            seeded = random.Random
            monkeypatch.setattr(random, 'Random',
                                lambda seed=None: seeded(SEED))
            texts = {}
            for name, module in (('port', split_by_cdhit_output),
                                 ('jax', jax_cdhit)):
                (tmp_path / name).mkdir()
                monkeypatch.chdir(tmp_path / name)
                module.main([str(tmp_path / 'set.out.clstr'), '0.5'])
                texts[name] = [(tmp_path / name / f'set.{s}').read_text()
                               for s in ('train', 'test')]
            assert texts['port'] == texts['jax']


# -- protein_clustering ------------------------------------------------ #
FASTA = ('>101M_1 mol:protein length:154  MYOGLOBIN\nMVLSEGEWQLVLHVWAKVEAD\n'
         '>102L_1 mol:protein length:165  T4 LYSOZYME\nMNIFEMLRIDEGLRLKIYKDT\n'
         '>1ABC_1 mol:protein length:99  SOMETHING\nMKTAYIAKQRQISFVKSHFSR\n'
         '>2DEF_2 mol:protein length:50  OTHER\nGSHMLEDPVDAFQLGRRPLLQ\n')


@pytest.fixture
def clustering_inputs(tmp_path):
    (tmp_path / 'all.fasta').write_text(FASTA)
    (tmp_path / 'train_ids').write_text('101m\n1abc\n2DEF\n')
    (tmp_path / 'test_ids').write_text('102l\n')
    (tmp_path / 'train.types').write_text(
        '1 -1 1abc/1abc_receptor.parquet 1abc/1abc_ligand_0.parquet\n'
        '0 -1 101m/101m_receptor.parquet 101m/101m_ligand_0.parquet\n'
        '1 -1 2DEF/2def_receptor.parquet 2DEF/2def_ligand_0.parquet\n')
    return tmp_path


@pytest.mark.parametrize('case', ['filter_fasta', 'decontaminate', 'main'])
def test_protein_clustering_equals_jax(clustering_inputs, monkeypatch, case):
    d = clustering_inputs
    if case == 'filter_fasta':
        protein_clustering.filter_fasta_file(d / 'all.fasta', d / 'train_ids',
                                             d / 'port.fasta')
        jax_protclust.filter_fasta_file(d / 'all.fasta', d / 'train_ids',
                                        d / 'jax.fasta')
        got = (d / 'port.fasta').read_text()
        assert got == (d / 'jax.fasta').read_text()
        assert [l[1:5] for l in got.splitlines() if l.startswith('>')] == [
            '101M', '1ABC', '2DEF']
    elif case == 'decontaminate':
        for name, module in (('port', protein_clustering),
                             ('jax', jax_protclust)):
            module.decontaminate_types(d / 'train.types', {'1abc', '2def'},
                                       d / f'{name}.types')
        got = (d / 'port.types').read_text()
        assert got == (d / 'jax.types').read_text()
        assert got.splitlines() == [
            '0 -1 101m/101m_receptor.parquet 101m/101m_ligand_0.parquet']
    else:
        # No cd-hit-2d here: the stub writes the clusters it would find
        # and records the command.
        monkeypatch.setattr(shutil, 'which', lambda name: '/bin/' + name)
        commands = {}
        texts = {}
        for name, module in (('port', protein_clustering),
                             ('jax', jax_protclust)):
            out = d / name

            def cd_hit(cmd, out=out, name=name, **_):
                commands[name] = cmd.replace(str(out), 'OUT')
                (out / 'cdhit_output.clstr').write_text(
                    '>Cluster 0\n0\t165aa, >102L_1... *\n'
                    '1\t154aa, >101m_1... at 92%\n')

            monkeypatch.setattr(module, 'execute_cmd', cd_hit)
            module.main([str(d / 'all.fasta'), str(d / 'test_ids'),
                         str(d / 'train_ids'), str(out),
                         str(d / 'train.types'), '-t', '0.8'])
            texts[name] = [(out / f).read_text() for f in (
                'train.fasta', 'test.fasta', 'train_unbiased.types')]
        assert commands['port'] == commands['jax']
        assert '-c 0.8' in commands['port']
        assert texts['port'] == texts['jax']
        assert '101m' not in texts['port'][2].lower()


# -- RDKit-gated tools ------------------------------------------------- #
RDKIT_CALLS = {
    'ligand_fingerprint': lambda m: m.get_fingerprint(None),
    'ligand_similar_pairs': lambda m: m.find_similar_pairs({}, {}),
    'ligand_main': lambda m: m.main(['tree', 'test_ids', 'a.types',
                                     'b.types']),
    'strain_delta_E': lambda m: m.find_delta_E('poses.sdf'),
    'strain_main': lambda m: m.main(['root', 'a.types']),
}


@pytest.mark.parametrize('call', sorted(RDKIT_CALLS))
def test_rdkit_tools_fail_by_name_like_jax(call):
    port, ref = ((ligand_clustering, jax_ligclust)
                 if call.startswith('ligand') else
                 (strain_energy, jax_strain))
    assert not port.HAVE_RDKIT and not ref.HAVE_RDKIT
    errors = []
    for module in (port, ref):
        with pytest.raises((ImportError, SystemExit)) as info:
            RDKIT_CALLS[call](module)
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1])
    assert str(errors[0]) == str(errors[1])
    assert 'RDKit' in str(errors[0])


# -- the CLIs ---------------------------------------------------------- #
TOOLS = ('data.gninatypes', 'dataset_generation.synthetic_affinity',
         'dataset_generation.replicate_poses',
         'dataset_generation.generate_types_file',
         'dataset_generation.dir_based_to_types',
         'dataset_generation.planar_check',
         'dataset_generation.split_by_cdhit_output',
         'dataset_generation.protein_clustering',
         'dataset_generation.ligand_clustering',
         'dataset_generation.strain_energy')


@pytest.mark.parametrize('tool', TOOLS)
def test_cli_help_has_jaxs_usage(tool, capsys):
    usage = []
    for package in ('pointvs_tpu_torch', 'pointvs_tpu'):
        module = importlib.import_module(f'{package}.{tool}')
        with pytest.raises(SystemExit) as info:
            module.main(['--help'])
        assert info.value.code == 0
        text = capsys.readouterr().out
        usage.append(text.split('\n\n')[0])
    assert usage[0].startswith('usage:') and usage[0] == usage[1]
