"""The port's attribution driver and entry points against the JAX
package, on a 2-layer model trained by the port's CLI that both packages
load: ``attribute`` on parquet and on PDB/SDF inputs writes the JAX
package's score CSV (within 2e-5), labelled CSV and B-factor PDB (line
for line); the ``main`` CLI; ``--pdbid`` from the download cache with
the fetch stubbed out; the card refused without one; the average
precision against scikit-learn's; ``multiple_ligands`` and the
interaction labels against JAX's.
"""
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from pointvs_tpu_torch.attribution.attribution import attribute, main
from pointvs_tpu_torch.main import main as port_main
from tests.setup_and_params import RESOURCES

MASK_TOL = 2e-5


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """A 2-layer model trained 1 epoch by the port's CLI (with node and
    softmax edge attention), which both packages load."""
    root = tmp_path_factory.mktemp('attr_run') / 'run'
    port_main(['egnn', str(root), '--train_data_root_pose', str(RESOURCES),
               '--train_types_pose', str(RESOURCES / 'test.types'),
               '--layers', '2', '-k', '16', '-ep', '1', '-b', '2',
               '--compact', '--egnn_attention', '--node_attention',
               '--softmax_attention', '--prefetch', '0', '--device', 'cpu'])
    return root


INPUTS = {
    'parquet': (RESOURCES / 'rec_0.parquet', RESOURCES / 'lig_0.parquet', 6),
    'pdb_sdf': (RESOURCES / '7zzp_rec_0.pdb', RESOURCES / '7zzp_lig_0.sdf',
                8),
}


def _assert_csv_close(got: Path, want: Path, tol: float):
    g, w = pd.read_csv(got), pd.read_csv(want)
    assert list(g.columns) == list(w.columns) and len(g) == len(w)
    for col in w.columns:
        if col == 'attribution':
            np.testing.assert_allclose(g[col], w[col], atol=tol, rtol=0)
        else:
            np.testing.assert_array_equal(g[col], w[col], err_msg=col)


@pytest.mark.parametrize('method', ['atom_masking', 'bond_masking', 'cam',
                                    'edge_attention'])
@pytest.mark.parametrize('inputs', sorted(INPUTS))
def test_attribute_matches_jax(run, tmp_path, inputs, method):
    from pointvs_tpu.attribution.attribution import attribute as jax_attr
    rec, lig, radius = INPUTS[inputs]
    want = jax_attr(method, run, tmp_path / 'jax', rec=rec, lig=lig,
                    radius=radius, edge_radius=4)
    got = attribute(method, run, tmp_path / 'port', rec=rec, lig=lig,
                    radius=radius, edge_radius=4, device='cpu')
    assert len(got) == len(want) > 9
    _assert_csv_close(tmp_path / 'port' / f'{method}_scores.csv',
                      tmp_path / 'jax' / f'{method}_scores.csv', MASK_TOL)
    labelled = [d / f'{method}_labelled.csv' for d in
                (tmp_path / 'port', tmp_path / 'jax')]
    assert labelled[0].exists() == labelled[1].exists()
    if labelled[1].exists():
        _assert_csv_close(*labelled, MASK_TOL)
    if inputs == 'pdb_sdf':
        got_pdb, want_pdb = [
            (d / f'{method}_bfactors.pdb').read_text().splitlines()
            for d in (tmp_path / 'port', tmp_path / 'jax')]
        assert got_pdb == want_pdb


def test_attribution_cli(run, tmp_path):
    scored = main(['node_attention', str(run), str(tmp_path), '--rec',
                   str(INPUTS['pdb_sdf'][0]), '--lig',
                   str(INPUTS['pdb_sdf'][1]), '--radius', '8',
                   '--estimate_bonds', '--device', 'cpu'])
    assert (tmp_path / 'node_attention_scores.csv').exists()
    lo = scored.attribution.min() - 0.011
    hi = scored.attribution.max() + 0.011
    stamped = 0
    for line in (tmp_path / 'node_attention_bfactors.pdb').read_text() \
            .splitlines():
        if line.startswith(('ATOM', 'HETATM')) and lo <= float(
                line[60:66]) <= hi:
            stamped += 1
    assert stamped > 10
    with pytest.raises(ValueError, match='method must be one of'):
        attribute('nope', run, tmp_path, rec='r', lig='l', device='cpu')
    with pytest.raises(ValueError, match='--pdbid or both'):
        attribute('cam', run, tmp_path, rec=None, lig='l', device='cpu')


def test_attribute_by_pdbid_reads_the_cache(run, tmp_path, monkeypatch):
    import urllib.request
    cache = tmp_path / 'cache'
    cache.mkdir()
    (cache / '7zzp.pdb').write_text(INPUTS['pdb_sdf'][0].read_text())
    monkeypatch.setenv('POINTVS_PDB_CACHE', str(cache))

    def no_network(*args, **kwargs):
        raise AssertionError('network touched despite a cache hit')
    monkeypatch.setattr(urllib.request, 'urlopen', no_network)
    scored = attribute('cam', run, tmp_path / 'out', pdbid='7ZZP',
                       lig=INPUTS['pdb_sdf'][1], radius=8, device='cpu')
    assert (tmp_path / 'out' / '7ZZP' / 'receptor.pdb').exists()
    assert (tmp_path / 'out' / 'cam_bfactors.pdb').exists()
    assert len(scored) > 9


def test_cuda_without_a_gpu_raises(run, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device cpu'):
        main(['cam', str(run), str(tmp_path), '--rec',
              str(INPUTS['parquet'][0]), '--lig', str(INPUTS['parquet'][1])])


def test_average_precision_matches_scikit_learn():
    from sklearn.metrics import average_precision_score
    from pointvs_tpu_torch.attribution.plip_subclasses import \
        average_precision
    rng = np.random.RandomState(4)
    for _ in range(5):
        labels = rng.randint(0, 2, 40)
        scores = np.round(rng.randn(40), 1)   # with ties
        assert average_precision(labels, scores) == pytest.approx(
            average_precision_score(labels, scores), abs=1e-12)


def test_multiple_ligands_match_jax(run, tmp_path):
    from pointvs_tpu.attribution.multiple_ligands import main as jax_multi
    from pointvs_tpu_torch.attribution.multiple_ligands import main as multi
    ligs = [str(RESOURCES / 'lig_0.parquet'), str(RESOURCES / 'lig.parquet')]
    args = [str(run), str(RESOURCES / 'rec_0.parquet')] + ligs + [
        '--attribution', 'bond_masking', '--radius', '6']
    jax_multi(args + ['-o', str(tmp_path / 'jax')])
    got = multi(args + ['-o', str(tmp_path / 'port'), '--device', 'cpu'])
    want = pd.read_csv(tmp_path / 'jax' / 'protein_atom_ranks.csv')
    assert list(got.columns) == list(want.columns)
    assert (got.n_complexes == 2).all() and len(got) == len(want)
    assert list(got['rank']) == list(range(1, len(got) + 1))
    assert got.mean_attribution.is_monotonic_decreasing
    # Atoms whose means tie may come in another order: compare by atom.
    key = ['x', 'y', 'z']
    merged = got.merge(want, on=key, suffixes=('', '_jax'))
    assert len(merged) == len(want)
    np.testing.assert_allclose(merged.mean_attribution,
                               merged.mean_attribution_jax, atol=MASK_TOL,
                               rtol=0)


def test_interaction_labels_match_jax():
    """The geometric labeller and the PLIP-free featurisation of
    interaction maps, on the 7zzp pocket, equal the JAX package's."""
    from pointvs_tpu.attribution import interaction_parser as jax_ip
    from pointvs_tpu.dataset_generation import chem as jax_chem
    from pointvs_tpu_torch.attribution import interaction_parser as ip
    from pointvs_tpu_torch.dataset_generation import chem
    from pointvs_tpu_torch.attribution.attribution import pocket_graph
    from pointvs_tpu_torch.utils import coords_to_string
    rec, lig, radius = INPUTS['pdb_sdf']
    struct = pd.DataFrame(pocket_graph(rec, lig, radius)[0])
    pocket, ligand = struct[struct.bp == 1], struct[struct.bp == 0]
    got = ip.geometric_interactions(pocket, ligand)
    want = jax_ip.geometric_interactions(pocket, ligand)
    pd.testing.assert_frame_equal(got, want)
    assert got[['hbd', 'hba', 'pistacking']].to_numpy().any()
    mol = chem.parse_sdf(lig)[0]
    key = coords_to_string((mol.atoms[0].x, mol.atoms[0].y, mol.atoms[0].z))
    maps = {'lig_acceptors': {key: 1}, 'lig_donors': {}, 'pi_stacking':
            {key: 2}}
    got = ip.StructuralInteractionParser('ligand').featurise_interaction(
        mol, maps)
    want = jax_ip.StructuralInteractionParser(
        'ligand').featurise_interaction(jax_chem.parse_sdf(lig)[0], maps)
    pd.testing.assert_frame_equal(got, want)
    assert got.hba.sum() == 1 and got.pistacking.sum() == 2
