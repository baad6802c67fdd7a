"""The port's siamese two-tower family against the JAX package's.

Same inputs, same weights: a parameter tree of the JAX model's shapes
drawn with numpy (``test_torch_lucid.draw_params``) goes through
``state_dict_from_flax`` into the port. The towers run on two different
random padded batches (the receptor side and the ligand side, with
padding edges and real nodes that receive no edge). Gates: forward 1e-5
with attention none, sigmoid and softmax on the unrolled and the scanned
JAX layouts; E(3) invariance 3e-5; a 20-step loss trajectory within atol
1e-4 / rtol 1e-5 of JAX's ``make_train_step``; every leaf of the JAX tree
mapped to one port key. The pair loader gives JAX's receptor and ligand
batches, array for array, in validation and over 3 training epochs
(weighted sampling, rotation, label noise and entity dropout, augmented
actives).

The CLI: ``pointvs_tpu_torch.main siamese`` and ``pointvs_tpu.main
siamese`` start from the same weights and train 20 steps; their logged
losses, final parameters and predictions agree within the trajectory
gate (predictions: three printed decimals). The JAX package has no
``.pt`` mapping for this family, so its importer
(``torch_to_flax_params``) is replaced in the test by one that draws the
tree in the JAX trainer's own shapes; the port loads that tree through
``state_dict_from_flax``. Then the port's serving CLI scores the run
directory to its validation rows, and ``resume_training`` continues it.
``run_clis`` serves ``test_torch_dense.py`` and ``test_torch_strain.py``.
"""
import json

import jax
import numpy as np
import pytest
import torch
import yaml

from pointvs_tpu.data.buckets import SiamesePair as JaxPair
from pointvs_tpu.data.loader import get_data_loader as jax_get_data_loader
from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu.parallel.mesh import get_mesh, replicate, shard_batch
from pointvs_tpu.parallel.steps import make_train_step as jax_train_step
from pointvs_tpu.training.optimisers import build_optimiser as jax_optimiser
from pointvs_tpu.training.optimisers import make_lr_schedule
from pointvs_tpu_torch import inference
from pointvs_tpu_torch.data.buckets import GraphBatch, SiamesePair, to_device
from pointvs_tpu_torch.data.loader import get_data_loader
from pointvs_tpu_torch.main import main as port_main
from pointvs_tpu_torch.models.params import load_reference_checkpoint, \
    state_dict_from_flax
from pointvs_tpu_torch.parallel.steps import make_train_step
from pointvs_tpu_torch.resume_training import main as resume_main
from pointvs_tpu_torch.training import optimisers
from tests.setup_and_params import EGNN_EPS, ORIGINAL_GRAPH, RESOURCES, \
    ROTATED_GRAPH
from tests.test_torch_egnn import jax_batch
from tests.test_torch_lucid import draw_params, port_from_jax
from tests.test_torch_train_loader import assert_same_batch, write_types
from tests.test_train_trajectory import LR, N_BATCHES, WD

K, DIM_IN, LAYERS = 16, 12, 2
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
TRAJ_TOL = dict(atol=1e-4, rtol=1e-5)
BASE = dict(residual=True, normalize=True, tanh=True, graphnorm=True)
ATTENTION = {
    'none': {},
    'sigmoid': dict(edge_attention=True),
    'softmax': dict(edge_attention=True, softmax_attention=True),
}


def kwargs_of(attention, scan_layers=False):
    return dict(dim_input=DIM_IN, k=K, num_layers=LAYERS,
                scan_layers=scan_layers, **BASE, **ATTENTION[attention])


def jax_pair(seed=0, n_graphs=3):
    return JaxPair(rec=jax_batch(n_graphs, seed=seed),
                   lig=jax_batch(n_graphs, seed=seed + 100))


def port_pair(pair):
    def side(batch):
        fields = {f: getattr(batch, f) for f in GraphBatch._fields}
        return GraphBatch(**fields)
    return to_device(SiamesePair(side(pair.rec), side(pair.lig)),
                     torch.device('cpu'))


def jax_model_params(attention, pair, scan_layers=False, seed=0):
    model = build_jax_model('siamese', **kwargs_of(attention, scan_layers))
    return model, draw_params(model, pair, seed=seed)


# ----------------------------------------------------------- forward
@pytest.mark.parametrize('scan_layers', [False, True],
                         ids=['unrolled', 'scan'])
@pytest.mark.parametrize('attention', sorted(ATTENTION))
def test_forward_matches_jax(attention, scan_layers):
    pair = jax_pair(seed=len(attention))
    model, params = jax_model_params(attention, pair, scan_layers)
    want = np.asarray(jax.jit(model.apply)(params, pair))
    port = port_from_jax('siamese', params,
                         **kwargs_of(attention, scan_layers))
    with torch.no_grad():
        got = port(port_pair(pair)).numpy()
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize('attention', sorted(ATTENTION))
def test_e3_invariance(attention):
    pair = JaxPair(rec=ORIGINAL_GRAPH, lig=ORIGINAL_GRAPH)
    rotated = JaxPair(rec=ROTATED_GRAPH, lig=ROTATED_GRAPH)
    _, params = jax_model_params(attention, pair)
    port = port_from_jax('siamese', params, **kwargs_of(attention))
    with torch.no_grad():
        a = port(port_pair(pair)).numpy()
        b = port(port_pair(rotated)).numpy()
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=EGNN_EPS, rtol=0)


@pytest.mark.parametrize('scan_layers', [False, True],
                         ids=['unrolled', 'scan'])
def test_state_dict_maps_every_leaf(scan_layers):
    pair = jax_pair()
    _, params = jax_model_params('softmax', pair, scan_layers)
    sd = state_dict_from_flax(params)
    leaves = jax.tree_util.tree_leaves(params)
    layer_leaves = [leaf for path, leaf in
                    jax.tree_util.tree_leaves_with_path(params)
                    if 'egnn_scan' in jax.tree_util.keystr(path)]
    # A scanned leaf holds every layer's parameter: one port key each.
    assert len(sd) == len(leaves) + (LAYERS - 1) * len(layer_leaves)
    assert sum(v.numel() for v in sd.values()) == sum(
        np.size(leaf) for leaf in leaves)
    assert {k.split('.')[0] for k in sd} == {'rec_tower', 'lig_tower',
                                             'head'}
    assert not any('coord_mlp' in k for k in sd if k.startswith('lig'))
    stray = dict(params['params'], extra={'kernel': np.zeros((2, 2))})
    with pytest.raises(KeyError, match='extra'):
        state_dict_from_flax(stray)


# ----------------------------------------------------------- training
def jax_trajectory(model, params, batches, task='classification',
                   steps=20):
    """Per-step losses of JAX's ``make_train_step`` on any batch pytree
    (the schedule and optimiser of tests/test_train_trajectory.py)."""
    mesh = get_mesh(1)
    tx = jax_optimiser('adam', WD)
    step = jax_train_step(model, tx, task, 'mse', mesh)
    sched = make_lr_schedule(LR, steps_per_epoch=N_BATCHES,
                             epochs=max(1, steps // N_BATCHES),
                             warm_restarts=True)
    p = replicate(jax.tree.map(np.array, params), mesh)
    o = replicate(tx.init(params), mesh)
    losses = []
    for t in range(steps):
        batch = shard_batch(jax.tree.map(lambda a: np.asarray(a)[None],
                                         batches[t % N_BATCHES]), mesh)
        p, o, loss = step(p, o, batch, np.float32(sched(t)),
                          jax.random.PRNGKey(0))
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
    return losses


def port_trajectory(model, batches, task='classification', steps=20):
    """Per-step losses of the port's train step on port batches (the
    schedule and optimiser of tests/test_train_trajectory.py)."""
    opt = optimisers.build_optimiser(model.parameters(), 'adam', WD, LR)
    sched = optimisers.make_lr_schedule(LR, N_BATCHES,
                                        max(1, steps // N_BATCHES),
                                        warm_restarts=True)
    step = make_train_step(model, opt, task, 'mse')
    return [step(batches[t % N_BATCHES], sched(t)).item()
            for t in range(steps)]


def padded_pairs(seed):
    """N_BATCHES pairs of one padded shape per side (one JAX compile)."""
    rng = np.random.RandomState(seed)
    seeds = rng.randint(0, 1000, (N_BATCHES, 2))
    from pointvs_tpu.data.buckets import pad_graphs_to_batch
    from tests.test_forward_parity import _random_samples
    sides = [[_random_samples(4, seed=int(s)) for s in seeds[:, j]]
             for j in range(2)]
    out = []
    for j, sets in enumerate(sides):
        n_pad = max(sum(x.num_nodes for x in s) for s in sets) + 7
        e_pad = max(sum(x.num_edges for x in s) for s in sets) + 13
        out.append([pad_graphs_to_batch(s, num_graphs=4, n_pad=n_pad,
                                        e_pad=e_pad) for s in sets])
    return [JaxPair(rec=r, lig=lg) for r, lg in zip(*out)]


def test_trajectory_matches_jax():
    pairs = padded_pairs(seed=3)
    model, params = jax_model_params('softmax', pairs[0], seed=4)
    want = jax_trajectory(model, params, pairs)
    port = port_from_jax('siamese', params, **kwargs_of('softmax'))
    got = port_trajectory(port, [port_pair(p) for p in pairs])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TRAJ_TOL)


# ----------------------------------------------------------- loader
LOADER = dict(batch_size=3, radius=4, edge_radius=4, estimate_bonds=True,
              polar_hydrogens=False, compact=True, seed=5)
TRAIN_SETTINGS = {
    'val': dict(mode='val'),
    'weighted_rot_noise': dict(mode='train', rot=True, p_noise=0.3),
    'remove_entity': dict(mode='train', p_remove_entity=0.5),
    'augmented_actives': dict(mode='train', augmented_actives=1),
}


def loaders(tmp_path, layout, settings):
    types = write_types(tmp_path / 'train.types')
    kwargs = dict(LOADER, **settings)
    jax_dl = jax_get_data_loader(RESOURCES, types_fname=types, prefetch=0,
                                 num_devices=1, layout=layout,
                                 **dict({'rot': False}, **kwargs))
    port_dl = get_data_loader(RESOURCES, types, prefetch=0, layout=layout,
                              **kwargs)
    return jax_dl, port_dl


def epochs(loader, unstack=False, n=3):
    out = []
    for _ in range(n):
        for batch, meta in loader:
            if unstack:
                batch = jax.tree.map(lambda a: np.asarray(a)[0], batch)
            out.append((batch, meta))
    return out


@pytest.mark.parametrize('name', sorted(TRAIN_SETTINGS))
def test_pair_batches_match_jax(tmp_path, name):
    jax_dl, port_dl = loaders(tmp_path, 'pair', TRAIN_SETTINGS[name])
    assert port_dl.paired_dataset.bp == 0 and port_dl.dataset.bp == 1
    want, got = epochs(jax_dl, unstack=True), epochs(port_dl)
    assert len(got) == len(want) == 3 * len(port_dl)
    for (g, g_meta), (w, w_meta) in zip(got, want):
        assert isinstance(g, SiamesePair)
        assert_same_batch(g.rec, w.rec)
        assert_same_batch(g.lig, w.lig)
        np.testing.assert_array_equal(g.rec.strain, w.rec.strain)
        np.testing.assert_array_equal(g_meta.y, g.rec.y)
        assert g_meta.lig_fnames == w_meta.lig_fnames
        assert g_meta.rec_fnames == w_meta.rec_fnames
    # Each side holds one entity: receptor atoms carry the entity bit.
    rec, lig = got[0][0].rec, got[0][0].lig
    real = rec.node_mask > 0
    assert (rec.node_feats[real, -1] == 1).all()
    assert (lig.node_feats[lig.node_mask > 0, -1] == 0).all()


# ----------------------------------------------------------- the CLI
CLI = ['-b', '2', '-ep', '1', '--top1', '--end_flag', '--dropout', '0',
       '--layers', str(LAYERS), '-k', str(K), '--compact', '--radius', '4',
       '--edge_radius', '4', '--estimate_bonds']
SETUP = ['--num_devices', '1', '--prefetch', '0', '--device_cache', 'off']


def _draw_like(template, seed):
    rng = np.random.RandomState(seed)

    def draw(leaf):
        if np.ndim(leaf) >= 2:
            bound = 1 / np.sqrt(np.shape(leaf)[-2])
            return rng.uniform(-bound, bound, np.shape(leaf)).astype(
                np.float32)
        return rng.uniform(0.2, 1.0, np.shape(leaf)).astype(np.float32)
    return jax.tree.map(draw, template)


def cli_argv(model, save, flags, train_types, test_types=None):
    """Both CLIs' command line: 20 steps at batch 2 over a 40-line types
    file, validation on ``test_types``."""
    test_types = test_types or RESOURCES / 'test.types'
    return ([model, str(save), '--train_data_root_pose', str(RESOURCES),
             '--train_types_pose', str(train_types), '--test_data_root_pose',
             str(RESOURCES), '--test_types_pose', str(test_types)] + CLI
            + list(flags) + SETUP)


def run_clis(root, model, flags, train_types, test_types=None, seed=6):
    """The JAX and the port training CLI from one drawn parameter tree:
    returns (jax_trainer, port_trainer); run dirs ``root/{jax,port}``, the
    port's weights ``root/init.pt``."""
    from pointvs_tpu.main import main as jax_main
    from pointvs_tpu.models import torch_import
    drawn = {}

    def import_drawn(state_dict, template, model_name):
        del state_dict, model_name
        drawn['params'] = _draw_like(template, seed)
        return drawn['params']

    blank = root / 'blank.pt'
    torch.save({'model_state_dict': {}, 'p_epoch': 0, 'a_epoch': 0}, blank)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(torch_import, 'torch_to_flax_params', import_drawn)
        jax_trainer = jax_main(
            cli_argv(model, root / 'jax', flags, train_types, test_types)
            + ['--load_weights', str(blank)])
    weights = root / 'init.pt'
    torch.save({'model_state_dict': state_dict_from_flax(drawn['params']),
                'p_epoch': 0, 'a_epoch': 0}, weights)
    port_trainer = port_main(
        cli_argv(model, root / 'port', flags, train_types, test_types)
        + ['--load_weights', str(weights), '--device', 'cpu'])
    return jax_trainer, port_trainer


def rows(path):
    return [line.split() for line in path.read_text().splitlines()]


def check_clis_agree(root, jax_trainer, port_trainer, steps=20):
    """Logged losses, final parameters and predictions within the gates."""
    losses = np.asarray(port_trainer.train_losses)
    assert len(losses) == steps and np.isfinite(losses).all()
    logged = {r['Batch (train, pose)']: r['Loss (train, pose)']
              for r in map(json.loads, (root / 'jax' / 'metrics.jsonl')
                           .read_text().splitlines())
              if 'Loss (train, pose)' in r}
    assert sorted(logged) == [1, 11]
    for batch, loss in logged.items():
        np.testing.assert_allclose(losses[batch - 1], loss, **TRAJ_TOL)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jax_trainer.params))
    got, meta = load_reference_checkpoint(
        root / 'port' / 'checkpoints' / 'pose_ckpt_epoch_1.pt')
    assert meta['p_epoch'] == 1 and sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   err_msg=key, **TRAJ_TOL)
    want_rows = rows(root / 'jax' / 'pose_predictions.txt')
    got_rows = rows(root / 'port' / 'pose_predictions.txt')
    assert len(got_rows) == len(want_rows) >= 2
    for g, w in zip(got_rows, want_rows):
        assert g[:2] == w[:2] and g[3:] == w[3:]
        assert abs(float(g[2]) - float(w[2])) <= 1.1e-3


def check_serve_and_resume(run, test_types=None):
    """The serving CLI scores the run to its validation rows; resuming
    continues it to epoch 2."""
    test_types = test_types or RESOURCES / 'test.types'
    trainer = inference.main([str(run), str(test_types), str(RESOURCES),
                              '--device', 'cpu', '--output_fname',
                              'served.txt'])
    assert (run / 'pose_served.txt').read_text() == (
        run / 'pose_predictions.txt').read_text()
    args = yaml.safe_load((run / 'cmd_args.yaml').read_text())
    args['epochs_pose'] = 2
    (run / 'cmd_args.yaml').write_text(yaml.dump(args))
    resumed = resume_main([str(run), '--device', 'cpu'])
    assert resumed.p_epoch == 2
    assert (run / 'checkpoints' / 'pose_ckpt_epoch_2.pt').exists()
    assert np.isfinite(resumed.train_losses).all()
    return trainer


@pytest.fixture(scope='module')
def siamese_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('siamese_cli')
    types = write_types(root / 'train.types', n=40,
                        labels=lambda i: int(i % 3 == 0))
    flags = ['--egnn_attention', '--softmax_attention', '--egnn_residual',
             '--egnn_normalise', '--egnn_tanh', '--graphnorm']
    return (root,) + run_clis(root, 'siamese', flags, types)


def test_cli_matches_jax(siamese_runs):
    root, jax_trainer, port_trainer = siamese_runs
    assert port_trainer.input_kind == 'pair'
    check_clis_agree(root, jax_trainer, port_trainer)


def test_cli_serves_and_resumes(siamese_runs):
    root = siamese_runs[0]
    trainer = check_serve_and_resume(root / 'port')
    assert trainer.model.__class__.__name__ == 'SiameseEGNN'
