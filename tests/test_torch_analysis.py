"""The port's analysis tail against the JAX package's: the average
precision of attributions on synthetic pharmacophores
(``synthpharm_atomic_auc``) and pose selection (``pose_selection``,
``ranking``), on one 2-layer k=16 model trained by the port's CLI on the
CPU that both packages load.

The synthetic-pharmacophore set is three complexes written from the test
complex (its ligand and the 40 receptor atoms closest to it, types drawn
from the seed), two of them labelled, with labelled atoms drawn from the
seed. The APs are held within 1e-6 of JAX's (scikit-learn's
``average_precision_score``), the baselines and first-hit ranks equal.
Pose selection reads a predictions file that the port's serving CLI
wrote for two targets of six seeded poses each, and a tree of smina
``docked_poses.sdf`` files; its rankings and TopN equal JAX's.
"""
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import yaml

from pointvs_tpu_torch.main import main as port_main
from tests.setup_and_params import RESOURCES

SEED = 14


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """A 2-layer model trained 1 epoch by the port's CLI (with node and
    softmax edge attention), which both packages load."""
    root = tmp_path_factory.mktemp('analysis_run') / 'run'
    port_main(['egnn', str(root), '--train_data_root_pose', str(RESOURCES),
               '--train_types_pose', str(RESOURCES / 'test.types'),
               '--layers', '2', '-k', '16', '-ep', '1', '-b', '2',
               '--compact', '--egnn_attention', '--node_attention',
               '--softmax_attention', '--prefetch', '0', '--device', 'cpu'])
    return root


def _xyz(table):
    return np.stack([table.column(c).to_numpy() for c in 'xyz'], 1)


def write_labelled_synthpharm_set(root, n=3, rec_atoms=40, seed=SEED):
    """``root/data`` with ``rec<i>.parquet``, ``lig<i>.parquet`` and
    ``sp.types``, and beside it ``labels.yaml`` (complexes 0 and 2) and
    ``atomic_labels.yaml`` (3 ligand and 4 receptor atoms of each
    labelled complex, as ``coords_to_string`` keys of the item's
    coordinates); returns the types file."""
    from pointvs_tpu_torch.data.dataset import SynthPharmDataset
    from pointvs_tpu_torch.data.preprocessing import \
        SYNTH_PHARM_ATOMIC_NUMBERS
    from pointvs_tpu_torch.utils import coords_to_string
    rng = np.random.default_rng(seed)
    data = root / 'data'
    data.mkdir(parents=True)
    lig = pq.read_table(RESOURCES / 'lig_0.parquet')
    rec = pq.read_table(RESOURCES / 'rec_0.parquet')
    dist = np.sqrt(((_xyz(rec)[:, None] - _xyz(lig)[None]) ** 2).sum(-1))
    rec = rec.take(np.sort(np.argsort(dist.min(1))[:rec_atoms]))
    lines = []
    for i in range(n):
        for kind, table, types, bp in (
                ('lig', lig, rng.choice(SYNTH_PHARM_ATOMIC_NUMBERS,
                                        lig.num_rows), 0),
                ('rec', rec, rng.integers(0, 3, rec.num_rows), 1)):
            cols = {c: table.column(c) for c in 'xyz'}
            cols['type'] = pa.array(types.astype(np.int64))
            cols['bp'] = pa.array(np.full(table.num_rows, bp, np.int64))
            pq.write_table(pa.table(cols), data / f'{kind}{i}.parquet')
        lines.append(f'{i % 2} -1 0.5 rec{i}.parquet lig{i}.parquet')
    types = data / 'sp.types'
    types.write_text('\n'.join(lines) + '\n')
    labelled = {0: 1, 1: 0, 2: 1}
    ds = SynthPharmDataset(data, types, compact=True, polar_hydrogens=False)
    atomic = {}
    for i, flag in labelled.items():
        if not flag:
            continue
        item = ds[i]
        bp = item.node_feats[:, :3].sum(1) > 0
        picks = np.r_[rng.choice(np.flatnonzero(~bp), 3, replace=False),
                      rng.choice(np.flatnonzero(bp), 4, replace=False)]
        atomic[i] = [coords_to_string(item.coords[j]) for j in picks]
    (root / 'labels.yaml').write_text(yaml.dump(labelled))
    (root / 'atomic_labels.yaml').write_text(yaml.dump(atomic))
    return types


def test_synthpharm_stats_match_jax(run, tmp_path):
    from pointvs_tpu.analysis.synthpharm_atomic_auc import \
        get_stats_from_dir as jax_stats
    from pointvs_tpu.attribution.attribution_fns import \
        ATTRIBUTION_FNS as JAX_FNS
    from pointvs_tpu_torch.analysis.synthpharm_atomic_auc import main
    types = write_labelled_synthpharm_set(tmp_path / 'sp')
    want = jax_stats(run, types.parent, types, JAX_FNS['atom_masking'])
    got = main([str(run), str(types.parent), str(types), '--output_dir',
                str(tmp_path / 'out'), '--device', 'cpu'])
    assert (tmp_path / 'out' / 'rank_histogram.png').exists()
    lig_rand, lig_ap, rec_rand, rec_ap, lig_pos, rec_pos = got
    assert len(lig_ap) == len(rec_ap) == 2
    assert lig_rand == want[0] and rec_rand == want[2]
    np.testing.assert_allclose(lig_ap, want[1], atol=1e-6, rtol=0)
    np.testing.assert_allclose(rec_ap, want[3], atol=1e-6, rtol=0)
    assert lig_pos == want[4] and rec_pos == want[5]
    assert np.all(np.asarray(lig_ap + rec_ap) > 0)


def test_label_df_matches_jax():
    from pointvs_tpu.analysis.synthpharm_atomic_auc import \
        label_df as jax_label
    from pointvs_tpu.utils import PositionDict as JaxPositions
    from pointvs_tpu_torch.analysis.synthpharm_atomic_auc import label_df
    from pointvs_tpu_torch.utils import PositionDict, coords_to_string
    rng = np.random.default_rng(SEED)
    df = pd.DataFrame((rng.normal(size=(20, 3)) * 10).astype(np.float32),
                      columns=['x', 'y', 'z'])
    keys = {coords_to_string(c): True for c in df.to_numpy()[::3]}
    got = label_df(df, PositionDict(keys))
    pd.testing.assert_frame_equal(got, jax_label(df, JaxPositions(keys)))
    assert got.y_true.sum() == 7


POSES = 6


def write_served_poses(root, seed=SEED):
    """Two targets (``rec_0``, ``rec_1``, the test receptor) of POSES
    seeded rigid copies of the test ligand each, a types file and the
    rmsd yaml ``parse_results`` reads (each pose's RMSD from the ligand,
    keyed by the receptor stem and the number after the ligand name's
    last underscore)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    lig = pq.read_table(RESOURCES / 'lig_0.parquet')
    xyz = _xyz(lig)
    centre = xyz.mean(0)
    lines, rmsds = [], {}
    for target in ('rec_0', 'rec_1'):
        (root / f'{target}.parquet').write_bytes(
            (RESOURCES / 'rec_0.parquet').read_bytes())
        rmsds[target] = {'docked_wrt_crystal': {}}
        for i in range(POSES):
            theta = rng.uniform(0, np.pi / (1 + 3 * (i % 2)))
            c, s = np.cos(theta), np.sin(theta)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            new = (xyz - centre) @ rot.T + centre + rng.normal(size=3)
            table = lig
            for j, col in enumerate('xyz'):
                table = table.set_column(
                    table.schema.get_field_index(col), col, [new[:, j]])
            name = f'{target}_lig_{i}.parquet'
            pq.write_table(table, root / name)
            rmsd = float(np.sqrt(((new - xyz) ** 2).sum(1).mean()))
            rmsds[target]['docked_wrt_crystal'][i] = rmsd
            lines.append(f'{int(rmsd < 2)} -1 {rmsd:.3f} {target}.parquet '
                         f'{name}')
    (root / 'poses.types').write_text('\n'.join(lines) + '\n')
    (root / 'rmsd.yaml').write_text(yaml.dump(rmsds))
    return root / 'poses.types', root / 'rmsd.yaml'


def write_docked_tree(root, seed=SEED):
    """``root/<pdbid>/docked_poses.sdf`` of 9 poses with
    ``minimizedAffinity`` records for two targets, and their RMSDs."""
    rng = np.random.default_rng(seed + 1)
    rmsds = {}
    for pdbid in ('1abc', '2xyz'):
        (root / pdbid).mkdir(parents=True)
        energies = rng.normal(-7, 1.5, 9).round(3)
        blocks = [f'pose{i}\n\n\n  0  0  0  0  0  0  0  0  0  0999 V2000\n'
                  f'M  END\n> <minimizedAffinity>\n{e}\n\n$$$$\n'
                  for i, e in enumerate(energies)]
        (root / pdbid / 'docked_poses.sdf').write_text(''.join(blocks))
        rmsds[pdbid] = {'docked_wrt_crystal': dict(enumerate(
            rng.uniform(0.5, 6, 9).round(3).tolist()))}
    return rmsds


@pytest.fixture(scope='module')
def served(run, tmp_path_factory):
    """The port's serving CLI on the two targets' poses: (predictions
    file, rmsd yaml)."""
    from pointvs_tpu_torch import inference
    root = tmp_path_factory.mktemp('served')
    types, rmsd_yaml = write_served_poses(root / 'poses')
    inference.main([str(run), str(types), str(types.parent),
                    '--output_fname', 'served.txt', '--device', 'cpu'])
    preds = run / 'pose_served.txt'
    assert len(preds.read_text().splitlines()) == 2 * POSES
    return preds, rmsd_yaml


def _assert_rankings_equal(got, want):
    assert len(got.sorted_scores_and_rmsds) == \
        len(want.sorted_scores_and_rmsds) > 0
    for g, w in zip(got.sorted_scores_and_rmsds,
                    want.sorted_scores_and_rmsds):
        np.testing.assert_array_equal(g, w)
    for n in range(1, 11):
        assert got.get_top_n(n) == want.get_top_n(n)
        assert got.get_top_n(n, 1.0) == want.get_top_n(n, 1.0)
    assert str(got) == str(want) and repr(got) == repr(want)


def test_pose_selection_on_served_predictions(served):
    from pointvs_tpu.analysis.pose_selection import \
        parse_results as jax_parse
    from pointvs_tpu_torch.analysis.pose_selection import parse_results
    preds, rmsd_yaml = served
    got = parse_results(preds, rmsd_info_fname=rmsd_yaml)
    _assert_rankings_equal(got, jax_parse(preds, rmsd_info_fname=rmsd_yaml))
    assert [len(r) for r in got.sorted_scores_and_rmsds] == [POSES] * 2
    assert got.get_top_n(POSES) == 1.0


def test_pose_selection_on_docked_sdf_tree(tmp_path):
    from pointvs_tpu.analysis import pose_selection as jax_ps
    from pointvs_tpu_torch.analysis import pose_selection as ps
    rmsds = write_docked_tree(tmp_path / 'docked')
    sdf = tmp_path / 'docked' / '1abc' / 'docked_poses.sdf'
    assert ps.extract_energies(sdf) == jax_ps.extract_energies(sdf)
    assert len(ps.extract_energies(sdf)) == 9
    got = ps.parse_results(tmp_path / 'docked', rmsd_info=rmsds)
    _assert_rankings_equal(
        got, jax_ps.parse_results(tmp_path / 'docked', rmsd_info=rmsds))
    with pytest.raises(FileNotFoundError):
        ps.parse_results(tmp_path / 'nothing', rmsd_info=rmsds)


def test_pose_selection_cli_and_prune_match_jax(served, tmp_path):
    from pointvs_tpu.analysis import pose_selection as jax_ps
    from pointvs_tpu_torch.analysis import pose_selection as ps
    preds, rmsd_yaml = served
    runs = tmp_path / 'runs'
    for name, files in (('a', ['predictions_1.txt', 'predictions_3.txt',
                               'predictions_x.txt']),
                        ('b', ['predictions_2.txt', 'predictions.txt'])):
        (runs / name).mkdir(parents=True)
        for fname in files:
            (runs / name / fname).write_text(preds.read_text())
    fnames = sorted(runs.glob('*/predictions*.txt'))
    assert sorted(ps.prune_preds(fnames)) == \
        sorted(jax_ps.prune_preds(fnames)) == \
        [runs / 'a' / 'predictions_3.txt', runs / 'b' / 'predictions.txt']
    args = [str(rmsd_yaml), str(runs), '-g', '-n', '5']
    jax_ps.main(args + ['--output', str(tmp_path / 'jax.png')])
    got = ps.main(args + ['--output', str(tmp_path / 'port.png')])
    assert sorted(got) == ['a', 'b']
    want = jax_ps.parse_results(runs / 'a' / 'predictions_3.txt',
                                rmsd_info_fname=rmsd_yaml)
    _assert_rankings_equal(got['a'], want)
    assert (tmp_path / 'port.png').exists() and \
        (tmp_path / 'jax.png').exists()


def test_ranking_matches_jax():
    from pointvs_tpu.analysis.ranking import Ranking as JaxRanking
    from pointvs_tpu_torch.analysis.ranking import Ranking
    rng = np.random.default_rng(SEED)
    lists = [np.column_stack([rng.integers(0, 2, k), np.sort(
        rng.random(k))[::-1], rng.uniform(0, 5, k)]) for k in (3, 7, 12)]
    got, want = Ranking('x', lists), JaxRanking('x', lists)
    for n in range(1, 13):
        for threshold in (0.5, 2.0, 4.0):
            assert got.get_top_n(n, threshold) == \
                want.get_top_n(n, threshold)
    assert got.get_mean_top_ranked_rmsd() == \
        want.get_mean_top_ranked_rmsd()
    assert repr(got) == repr(want)
    assert Path(got.fname) == Path('x')
