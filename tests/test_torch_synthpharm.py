"""The port's ``SynthPharmDataset`` (``--synthpharm``) against the JAX
package's.

The data: a synthetic-pharmacophore set written in ``tmp_path`` from the
test complex (its coordinates, a seeded 300-atom cut of the receptor),
each file with ``x, y, z``, ``type`` (a ligand atom's atomic number drawn
from the nine of the pharmacophore classes, a receptor atom's class
0..2) and ``bp``.

Gates: items array-equal to JAX's (features, coordinates, edges and their
classes, labels) under the edge settings and the ``no_receptor`` and
``bp`` filters; loader batches array-equal over 2 epochs of weighted
sampling; the training CLI (``--synthpharm --compact``, 2 epochs) from
one ``.pt`` against JAX's within atol 1e-4 / rtol 1e-5, the trajectory
gate, and its predictions within 1.1e-3 (three printed decimals).
``--synth_pharm`` / ``-p`` is recorded in ``cmd_args.yaml`` and changes
nothing else, as in the JAX CLI. Without ``--compact`` the dataset's
``feature_dim`` (22) is not its features' width (12): the JAX CLI stops
at its first training step (flax's parameter shape check), and the port
stops there too, with a ``ValueError`` naming both widths, both leaving
the same run-directory files. The serving CLI scores a synthpharm run
with ``SynthPharmDataset``, to the run's validation rows.
"""
import json

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
import yaml

from pointvs_tpu.data.dataset import SynthPharmDataset as JaxSynthPharm
from pointvs_tpu.data.loader import get_data_loader as jax_get_data_loader
from pointvs_tpu_torch import inference
from pointvs_tpu_torch.data.dataset import SynthPharmDataset
from pointvs_tpu_torch.data.loader import get_data_loader
from pointvs_tpu_torch.data.preprocessing import SYNTH_PHARM_ATOMIC_NUMBERS
from pointvs_tpu_torch.main import main as port_main
from pointvs_tpu_torch.models.params import load_reference_checkpoint, \
    state_dict_from_flax
from tests.setup_and_params import ORIGINAL_GRAPH, RESOURCES
from tests.test_torch_egnn import jax_model_and_params
from tests.test_torch_main import CLI_MODEL, SETUP
from tests.test_torch_train_loader import assert_same_batch

TRAJ_TOL = dict(atol=1e-4, rtol=1e-5)
N_ITEMS = 8


def write_synthpharm_set(root, n=N_ITEMS, seed=0):
    """n complexes and a types file ``sp.types`` (labels alternate)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n):
        for kind, src in (('lig', 'lig_0'), ('rec', 'rec_0')):
            table = pq.read_table(RESOURCES / f'{src}.parquet')
            if kind == 'rec':
                table = table.take(np.sort(rng.choice(table.num_rows, 300,
                                                      replace=False)))
                types = rng.integers(0, 3, table.num_rows)
            else:
                types = rng.choice(SYNTH_PHARM_ATOMIC_NUMBERS,
                                   table.num_rows)
            cols = {c: table.column(c) for c in 'xyz'}
            cols['type'] = pa.array(types.astype(np.int64))
            cols['bp'] = pa.array(np.full(table.num_rows, int(kind == 'rec'),
                                          np.int64))
            pq.write_table(pa.table(cols), root / f'{kind}_{i}.parquet')
        lines.append(f'{int(i % 3 == 0)} -1 0.5 rec_{i}.parquet '
                     f'lig_{i}.parquet')
    (root / 'sp.types').write_text('\n'.join(lines) + '\n')
    return root / 'sp.types'


ITEMS = {
    'default': dict(edge_radius=4),
    'estimate_bonds_prune': dict(edge_radius=4, estimate_bonds=True,
                                 prune=True),
    'no_receptor': dict(edge_radius=4, no_receptor=True),
    'ligand_only_bp': dict(edge_radius=4, bp=0),
    'receptor_only_bp': dict(edge_radius=3, bp=1),
}


@pytest.mark.parametrize('name', sorted(ITEMS))
def test_items_match_jax(tmp_path, name):
    types = write_synthpharm_set(tmp_path / 'sp')
    kwargs = dict(compact=True, polar_hydrogens=False, **ITEMS[name])
    want = JaxSynthPharm(tmp_path / 'sp', types_fname=types, **kwargs)
    got = SynthPharmDataset(tmp_path / 'sp', types, **kwargs)
    assert len(got) == len(want) == N_ITEMS
    assert got.feature_dim == want.feature_dim == 12
    for i in range(N_ITEMS):
        g, w = got[i], want[i]
        assert g.node_feats.shape[1] == 12 and g.num_edges > 0
        for field in ('node_feats', 'coords', 'senders', 'receivers',
                      'edge_attr'):
            a, b = getattr(g, field), np.asarray(getattr(w, field))
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, field)
        assert g.y == w.y and g.lig_fname == w.lig_fname
        if name == 'no_receptor' or name == 'ligand_only_bp':
            assert g.node_feats[:, :3].sum() == 0
        if name == 'receptor_only_bp':
            assert g.node_feats[:, 3:].sum() == 0


def test_train_batches_match_jax(tmp_path):
    """Weighted sampling over 2 epochs (mixed labels), batch 3."""
    types = write_synthpharm_set(tmp_path / 'sp')
    kwargs = dict(batch_size=3, compact=True, radius=4, edge_radius=4,
                  polar_hydrogens=False, mode='train', prefetch=0, seed=5)
    jax_dl = jax_get_data_loader(tmp_path / 'sp', types_fname=types,
                                 dataset_class=JaxSynthPharm, rot=False,
                                 num_devices=1, **kwargs)
    port_dl = get_data_loader(tmp_path / 'sp', types,
                              dataset_class=SynthPharmDataset, **kwargs)
    assert port_dl.use_weighted_sampler
    for _ in range(2):
        got, want = list(port_dl), list(jax_dl)
        assert len(got) == len(want) == len(port_dl)
        for (g, g_meta), (w, w_meta) in zip(got, want):
            w = type(w)(*[None if a is None else np.asarray(a)[0]
                          for a in w])
            assert_same_batch(g, w)
            assert g_meta.lig_fnames == w_meta.lig_fnames


# ------------------------------------------------------------ the CLIs
def _argv(save, types, extra=()):
    data = str(types.parent)
    return (['egnn', str(save), '--train_data_root_pose', data,
             '--train_types_pose', str(types), '--test_data_root_pose', data,
             '--test_types_pose', str(types), '-b', '2', '-ep', '2',
             '--synthpharm', '--dropout', '0', '--top1', '--end_flag']
            + CLI_MODEL + SETUP + list(extra))


@pytest.fixture(scope='module')
def sp_runs(tmp_path_factory):
    from pointvs_tpu.main import main as jax_main
    root = tmp_path_factory.mktemp('synthpharm_cli')
    types = write_synthpharm_set(root / 'sp')
    flags = dict(residual=True, normalize=True, tanh=True, graphnorm=True,
                 edge_attention=True, softmax_attention=True)
    _, params = jax_model_and_params(flags, ORIGINAL_GRAPH, False, seed=8)
    weights = root / 'init.pt'
    torch.save({'model_state_dict': state_dict_from_flax(params),
                'p_epoch': 0, 'a_epoch': 0}, weights)
    extra = ['--load_weights', str(weights)]
    jax_trainer = jax_main(_argv(root / 'jax', types, extra))
    port_trainer = port_main(_argv(root / 'port', types, extra)
                             + ['--device', 'cpu'])
    return root, types, jax_trainer, port_trainer


def test_cli_matches_jax(sp_runs):
    root, _, jax_trainer, port_trainer = sp_runs
    losses = np.asarray(port_trainer.train_losses)
    assert len(losses) == 2 * N_ITEMS // 2 and np.isfinite(losses).all()
    logged = [r['Loss (train, pose)'] for r in map(
        json.loads, (root / 'jax' / 'metrics.jsonl').read_text()
        .splitlines()) if 'Loss (train, pose)' in r]
    # JAX logs batch 1 of each epoch (4 steps an epoch, interval 10).
    assert len(logged) == 2
    np.testing.assert_allclose(losses[[0, 4]], logged, **TRAJ_TOL)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jax_trainer.params))
    got, meta = load_reference_checkpoint(
        root / 'port' / 'checkpoints' / 'pose_ckpt_epoch_2.pt')
    assert meta['p_epoch'] == 2 and sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                   err_msg=key, **TRAJ_TOL)
    rows = [(root / run / 'pose_predictions.txt').read_text().splitlines()
            for run in ('port', 'jax')]
    assert len(rows[0]) == len(rows[1]) == N_ITEMS
    for g, w in zip(*rows):
        g, w = g.split(), w.split()
        assert g[:2] == w[:2] and g[3:] == w[3:]
        assert abs(float(g[2]) - float(w[2])) <= 1.1e-3


def test_synth_pharm_flag_is_recorded_and_inert(sp_runs, tmp_path):
    root, types, _, port_trainer = sp_runs
    flagged = port_main(_argv(tmp_path / 'p', types, [
        '--load_weights', str(root / 'init.pt'), '-p', '--device', 'cpu']))
    cmd = yaml.safe_load((tmp_path / 'p' / 'cmd_args.yaml').read_text())
    jax_cmd = yaml.safe_load((root / 'jax' / 'cmd_args.yaml').read_text())
    assert cmd['synth_pharm'] and not jax_cmd['synth_pharm']
    assert cmd['synthpharm'] and jax_cmd['synthpharm']
    np.testing.assert_array_equal(flagged.train_losses,
                                  port_trainer.train_losses)
    np.testing.assert_array_equal(flagged.val_scores, port_trainer.val_scores)


def test_without_compact_both_stop_at_the_first_step(sp_runs, tmp_path):
    from pointvs_tpu.main import main as jax_main
    _, types, _, _ = sp_runs
    argv = [a for a in _argv(tmp_path / 'x', types) if a != '--compact']
    with pytest.raises(Exception, match=r'\(22, 16\)'):
        jax_main([a.replace(str(tmp_path / 'x'), str(tmp_path / 'jax'))
                  for a in argv])
    with pytest.raises(ValueError, match='12 node features.*dim_input=22'):
        port_main([a.replace(str(tmp_path / 'x'), str(tmp_path / 'port'))
                   for a in argv] + ['--device', 'cpu'])

    def names(run):
        return sorted(p.name for p in run.iterdir()
                      if p.name != 'train_spec.yaml')
    assert names(tmp_path / 'port') == names(tmp_path / 'jax') == [
        'cmd_args.yaml', 'metrics.jsonl', 'model_kwargs.yaml', 'output.log']
    kwargs = yaml.safe_load(
        (tmp_path / 'port' / 'model_kwargs.yaml').read_text())
    assert kwargs['dim_input'] == 22


def test_serving_cli_scores_a_synthpharm_run(sp_runs):
    """The JAX serving CLI reads a --synthpharm run's structures as
    ordinary complexes and stops at its first item (the files have no
    atomic_number or types column); the port's stops with a ValueError
    naming the flag, before loading the model (ROADMAP.md, Queue 3)."""
    from pointvs_tpu.inference import main as jax_inference
    root, types, _, _ = sp_runs
    run = root / 'port'
    args = [str(run), str(types), str(types.parent)]
    with pytest.raises(Exception, match='atomic_number|types'):
        jax_inference(args + ['--num_devices', '1', '--output_fname',
                              'jax_served.txt'])
    with pytest.raises(ValueError, match='--synthpharm'):
        inference.main(args + ['--device', 'cpu', '--output_fname',
                               'served.txt'])
    assert not (run / 'pose_served.txt').exists()
