"""Structure parsing in the port (``dataset_generation/chem.py``,
``types_to_parquet.py``) against the JAX package.

Mirrors the six cases of ``tests/test_structure_parsing.py``: for each,
the port's result equals the JAX package's, column by column (the frames
of ``7zzp_lig_0.sdf`` and ``7zzp_rec_0.pdb``, the typing of each residue
atom, the parquet round trip, the dataset built on the parquets). Also:
MOL2 parsing, ``parse_types_mp`` / ``main`` over a types file,
``download_pdb_file`` from its cache with the fetch stubbed out, and the
structure files served (``--input_suffix``: the port's serving CLI on
the 7zzp PDB with its SDF or MOL2 ligand against the JAX serving CLI on
the JAX parser's parquets of them, within 1e-5) and trained (as on the
parquets, exactly).
"""
import urllib.request
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from pointvs_tpu.dataset_generation import chem as jax_chem
from pointvs_tpu.dataset_generation.types_to_parquet import \
    StructuralFileParser as JaxParser
from pointvs_tpu.dataset_generation.types_to_parquet import \
    parse_types_mp as jax_parse_types_mp
from pointvs_tpu_torch.dataset_generation import chem
from pointvs_tpu_torch.dataset_generation.types_to_parquet import (
    StructuralFileParser,
    main,
)

RESOURCES = Path(__file__).parent / 'resources'
LIG_SDF = RESOURCES / '7zzp_lig_0.sdf'
REC_PDB = RESOURCES / '7zzp_rec_0.pdb'


def assert_frames_equal(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        assert got[col].dtype == want[col].dtype, col
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      want[col].to_numpy(), err_msg=col)


@pytest.fixture(scope='module')
def receptor_frames():
    return (StructuralFileParser('receptor').file_to_parquets(REC_PDB),
            JaxParser('receptor').file_to_parquets(REC_PDB))


@pytest.mark.parametrize('extended', [False, True])
@pytest.mark.parametrize('mol_type', ['ligand', 'receptor'])
def test_type_map_matches_jax(mol_type, extended):
    got = StructuralFileParser(mol_type, extended)
    want = JaxParser(mol_type, extended)
    assert got.n_features == want.n_features == (18 if extended else 11)
    assert dict(got.type_map) == dict(want.type_map)


@pytest.mark.parametrize('extended', [False, True])
def test_sdf_frame_matches_jax(extended):
    got = StructuralFileParser('ligand', extended).file_to_parquets(LIG_SDF)
    want = JaxParser('ligand', extended).file_to_parquets(LIG_SDF)
    assert_frames_equal(got, want)
    assert len(got) == 9 and (got.bp == 0).all()
    aromatic_c = got[(got.atomic_number == 6) & got.types.isin([2, 3])]
    assert len(aromatic_c) >= 4


def test_pdb_frame_matches_jax(receptor_frames):
    got, want = receptor_frames
    assert_frames_equal(got, want)
    assert (got.bp == 1).all()


def test_pdb_residue_typing_matches_jax(receptor_frames):
    got_df, _ = receptor_frames
    mol = chem.parse_pdb(REC_PDB)
    jax_mol = jax_chem.parse_pdb(REC_PDB)
    assert [(a.element, a.name, a.residue_name, a.is_aromatic, a.implicit_h)
            for a in mol.atoms] == [
        (a.element, a.name, a.residue_name, a.is_aromatic, a.implicit_h)
        for a in jax_mol.atoms]
    assert sorted(mol.bonds) == sorted(jax_mol.bonds)
    heavy = [a for a in mol.atoms
             if a.element != 1 and a.residue_name.lower() != 'hoh']
    assert len(heavy) == len(got_df)
    by_case = {}
    for row, atom in enumerate(heavy):
        by_case.setdefault((atom.residue_name, atom.name),
                           int(got_df.types.iloc[row]))
    assert by_case[('GLY', 'N')] == 5 and by_case[('PRO', 'N')] == 4
    assert by_case[('GLY', 'O')] == 6 and by_case[('SER', 'OG')] == 7
    assert by_case[('TYR', 'OH')] == 7 and by_case[('PHE', 'CG')] == 2
    assert by_case[('TYR', 'CZ')] == 3 and by_case[('ALA', 'CB')] == 0
    assert by_case[('ALA', 'C')] == 1


def test_waters_excluded():
    mol = chem.parse_pdb(REC_PDB)
    assert not any(a.residue_name.lower() == 'hoh' for a in mol.atoms)
    assert len(mol.atoms) == len(jax_chem.parse_pdb(REC_PDB).atoms)


def test_parquet_roundtrip_matches_jax(tmp_path):
    StructuralFileParser('ligand').file_to_parquets(
        LIG_SDF, tmp_path / 'port', 'lig.parquet', add_polar_hydrogens=False)
    JaxParser('ligand').file_to_parquets(
        LIG_SDF, tmp_path / 'jax', 'lig.parquet', add_polar_hydrogens=False)
    got = pd.read_parquet(tmp_path / 'port' / 'lig.parquet')
    assert_frames_equal(got, pd.read_parquet(tmp_path / 'jax' /
                                             'lig.parquet'))
    assert got.dtypes['x'] == np.float64 and got.dtypes['types'] == np.int64
    with pytest.raises(RuntimeError, match='end in .parquet'):
        StructuralFileParser('ligand').file_to_parquets(
            LIG_SDF, tmp_path, 'lig.csv')


def test_feature_pipeline_matches_jax(tmp_path):
    """Raw SDF/PDB -> parquet -> the datasets of both packages -> equal
    samples."""
    from pointvs_tpu.data.dataset import PointCloudDataset as JaxDataset
    from pointvs_tpu_torch.data.dataset import PointCloudDataset
    StructuralFileParser('ligand').file_to_parquets(
        LIG_SDF, tmp_path, 'lig.parquet', add_polar_hydrogens=False)
    StructuralFileParser('receptor').file_to_parquets(
        REC_PDB, tmp_path, 'rec.parquet', add_polar_hydrogens=False)
    types = tmp_path / 'test.types'
    types.write_text('1 -1 -1.0 rec.parquet lig.parquet\n')
    kwargs = dict(radius=6, polar_hydrogens=False, compact=True,
                  edge_radius=4, estimate_bonds=True)
    got = PointCloudDataset(tmp_path, types, **kwargs)[0]
    want = JaxDataset(tmp_path, types_fname=types, **kwargs)[0]
    assert got.num_nodes > 9 and got.num_edges > 0
    assert got.node_feats.shape[1] == 12
    for field in ('node_feats', 'coords', 'edge_attr'):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    got_edges = sorted(zip(got.senders.tolist(), got.receivers.tolist()))
    want_edges = sorted(zip(np.asarray(want.senders).tolist(),
                            np.asarray(want.receivers).tolist()))
    assert got_edges == want_edges


def _mol2_from_sdf(path: Path, out: Path) -> Path:
    """A MOL2 copy of the first molecule of an SDF (atoms, bonds)."""
    mol = jax_chem.parse_sdf(path)[0]
    lines = ['@<TRIPOS>MOLECULE', 'lig', f'{len(mol.atoms)} '
             f'{len(mol.bonds)} 0 0 0', 'SMALL', 'NO_CHARGES', '',
             '@<TRIPOS>ATOM']
    for i, a in enumerate(mol.atoms, start=1):
        sym = jax_chem.Z_TO_SYMBOL[a.element]
        kind = f'{sym}.ar' if a.is_aromatic else f'{sym}.3'
        lines.append(f'{i} {sym}{i} {a.x:.4f} {a.y:.4f} {a.z:.4f} {kind} '
                     f'1 LIG1 0.0')
    lines.append('@<TRIPOS>BOND')
    for i, (s, t, order) in enumerate(mol.bonds, start=1):
        lines.append(f'{i} {s + 1} {t + 1} {"ar" if order == 4 else order}')
    out.write_text('\n'.join(lines) + '\n')
    return out


def test_mol2_frame_matches_jax(tmp_path):
    mol2 = _mol2_from_sdf(LIG_SDF, tmp_path / 'lig.mol2')
    got = StructuralFileParser('ligand').file_to_parquets(mol2)
    assert_frames_equal(got, JaxParser('ligand').file_to_parquets(mol2))
    assert len(got) == 9
    with pytest.raises(ValueError, match='Unsupported'):
        chem.read_molecules(tmp_path / 'lig.xyz')


def _write_inputs(root: Path):
    """The 7zzp pair under the names a types file's entries map to."""
    root.mkdir()
    (root / '7zzp_rec.pdb').write_text(REC_PDB.read_text())
    (root / '7zzp_lig.sdf').write_text(LIG_SDF.read_text())
    types = root / 'set.types'
    types.write_text('1 -1 -1.0 7zzp_rec_0.parquet 7zzp_lig_0.parquet\n')
    return types


def test_types_file_conversion_matches_jax(tmp_path):
    types = _write_inputs(tmp_path / 'in')
    main([str(types), str(tmp_path / 'port'), str(tmp_path / 'in')])
    jax_parse_types_mp(types, tmp_path / 'in', tmp_path / 'jax')
    for name in ('7zzp_rec_0.parquet', '7zzp_lig_0.parquet'):
        assert_frames_equal(pd.read_parquet(tmp_path / 'port' / name),
                            pd.read_parquet(tmp_path / 'jax' / name))


def test_download_reads_the_cache_without_the_network(tmp_path,
                                                      monkeypatch):
    cache = tmp_path / 'pdbcache'
    cache.mkdir()
    (cache / '1abc.pdb').write_text('HEADER    FAKE\nEND\n')
    monkeypatch.setenv('POINTVS_PDB_CACHE', str(cache))

    def no_network(*args, **kwargs):
        raise AssertionError('network touched despite a cache hit')
    monkeypatch.setattr(urllib.request, 'urlopen', no_network)
    out = StructuralFileParser.download_pdb_file('1ABC', tmp_path / 'run')
    assert out == tmp_path / 'run' / 'receptor.pdb'
    assert out.read_text().startswith('HEADER    FAKE')
    with pytest.raises(RuntimeError, match='Unknown protein'):
        StructuralFileParser.download_pdb_file('12345', tmp_path / 'x')


def test_download_fetches_once_into_the_cache(tmp_path, monkeypatch):
    monkeypatch.setenv('POINTVS_PDB_CACHE', str(tmp_path / 'cache'))
    fetched = []

    class Response:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read(self):
            return b'HEADER    FETCHED\nEND\n'

    def fake_urlopen(url, timeout):
        fetched.append(url)
        return Response()
    monkeypatch.setattr(urllib.request, 'urlopen', fake_urlopen)
    for run in ('a', 'b'):
        out = StructuralFileParser.download_pdb_file('2XYZ', tmp_path / run)
        assert out.read_text().startswith('HEADER    FETCHED')
    assert fetched == ['https://files.rcsb.org/download/2xyz.pdb']


# ---------------------------------------- serving on structure files
POSE_FLAGS = ['--layers', '2', '-k', '16', '-b', '2', '--compact',
              '--radius', '6', '--edge_radius', '4', '--estimate_bonds',
              '--egnn_attention', '--softmax_attention', '--prefetch', '0',
              '--device', 'cpu']


@pytest.fixture(scope='module')
def pose_run(tmp_path_factory):
    from pointvs_tpu_torch.main import main as port_main
    root = tmp_path_factory.mktemp('structure_run') / 'run'
    port_main(['egnn', str(root), '--train_data_root_pose', str(RESOURCES),
               '--train_types_pose', str(RESOURCES / 'test.types'), '-ep',
               '1'] + POSE_FLAGS)
    return root


@pytest.fixture(scope='module')
def structure_sets(tmp_path_factory):
    """The 7zzp pair as PDB + SDF and PDB + MOL2 types files, and the
    same complexes as parquets written by the JAX package's parser."""
    root = tmp_path_factory.mktemp('structures')
    (root / 'rec.pdb').write_text(REC_PDB.read_text())
    (root / 'lig.sdf').write_text(LIG_SDF.read_text())
    _mol2_from_sdf(LIG_SDF, root / 'lig.mol2')
    for name in ('rec', 'lig'):
        parser = JaxParser('receptor' if name == 'rec' else 'ligand')
        parser.file_to_parquets(root / ('rec.pdb' if name == 'rec'
                                        else 'lig.sdf'),
                                root, f'{name}.parquet')
    for suffix in ('sdf', 'mol2', 'parquet'):
        rec = 'rec.parquet' if suffix == 'parquet' else 'rec.pdb'
        (root / f'{suffix}.types').write_text(
            f'1 -1 -1.0 {rec} lig.{suffix}\n0 -1 -1.0 {rec} lig.{suffix}\n')
    return root


@pytest.mark.parametrize('ligand', ['sdf', 'mol2'])
def test_serving_structure_files_matches_jax(pose_run, structure_sets,
                                             ligand):
    """``--input_suffix`` inputs: the port's serving CLI reads the PDB and
    the SDF/MOL2 files and scores them as the JAX serving CLI scores the
    JAX parser's parquets of them (within 1e-5). The JAX serving CLI
    stops on the structure files themselves: its dataset reads every
    path as parquet (ROADMAP.md, Queue 3)."""
    from pointvs_tpu.inference import main as jax_inference
    from pointvs_tpu_torch import inference
    from tests.test_torch_strain import jax_serving_scores
    root = structure_sets
    want = jax_serving_scores(pose_run, root / 'parquet.types', root)
    served = inference.main([str(pose_run), str(root / f'{ligand}.types'),
                             str(root), '--device', 'cpu',
                             '--output_fname', f'{ligand}.txt'])
    assert len(served.val_scores) == 2
    np.testing.assert_allclose(served.val_scores, want, atol=1e-5, rtol=0)
    with pytest.raises(Exception, match='[Pp]arquet'):
        jax_inference([str(pose_run), str(root / f'{ligand}.types'),
                       str(root), '--num_devices', '1', '--output_fname',
                       'jax.txt'])


def test_training_on_structure_files_equals_the_parquet_run(structure_sets,
                                                            tmp_path):
    """``main --input_suffix sdf`` trains on the PDB/SDF pair exactly as
    on the parser's parquets of it (losses and validation scores equal),
    and ``resume_training`` continues it."""
    from pointvs_tpu_torch.main import main as port_main
    from pointvs_tpu_torch.resume_training import main as resume_main
    root = structure_sets
    runs = {}
    for suffix in ('sdf', 'parquet'):
        types = str(root / f'{suffix}.types')
        runs[suffix] = port_main(
            ['egnn', str(tmp_path / suffix), '--train_data_root_pose',
             str(root), '--train_types_pose', types,
             '--test_data_root_pose', str(root), '--test_types_pose', types,
             '--input_suffix', suffix, '-ep', '2'] + POSE_FLAGS)
    np.testing.assert_array_equal(runs['sdf'].train_losses,
                                  runs['parquet'].train_losses)
    np.testing.assert_array_equal(runs['sdf'].val_scores,
                                  runs['parquet'].val_scores)
    import yaml
    cmd = tmp_path / 'sdf' / 'cmd_args.yaml'
    args = yaml.safe_load(cmd.read_text())
    assert args['input_suffix'] == 'sdf'
    args['epochs_pose'] = 3
    cmd.write_text(yaml.dump(args))
    assert resume_main([str(tmp_path / 'sdf'), '--device', 'cpu']
                       ).p_epoch == 3
