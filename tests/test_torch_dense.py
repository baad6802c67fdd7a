"""The port's dense point-cloud family (``dense_egnn``, alias ``lie_conv``)
against the JAX package's ``DenseEGNN``.

Same inputs, same weights: random point clouds zero-padded by both
packages' ``dense_collate`` (with padding atoms and an empty graph slot),
a parameter tree of the JAX model's shapes drawn with numpy, carried by
``state_dict_from_flax``. Gates: forward 1e-5 with the distance cutoff
off and at 4 A, normalisation and the residual each on and off; E(3)
invariance 3e-5 on the test complexes; gradients finite through the
diagonal and padding pairs (radial 0); a 20-step loss trajectory within
atol 1e-4 / rtol 1e-5 of JAX's; every leaf mapped to one port key; the
dense loader's batches array-equal to JAX's in validation and over 3
training epochs. The CLI (``main lie_conv``) against JAX's from the same
weights (``test_torch_siamese.run_clis``), ``dense_egnn`` giving the same
run as ``lie_conv``, then serving and resuming the run directory.
"""
import jax
import numpy as np
import pytest
import torch

from pointvs_tpu.data.buckets import GraphSample as JaxSample
from pointvs_tpu.data.preprocessing import uniform_random_rotation
from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu.models.vanilla import dense_collate as jax_dense_collate
from pointvs_tpu_torch.data.buckets import DenseBatch, GraphSample, \
    to_device
from pointvs_tpu_torch.data.loader import DENSE_NODE_BUCKETS, \
    get_data_loader
from pointvs_tpu_torch.main import main as port_main
from pointvs_tpu_torch.models.params import state_dict_from_flax
from pointvs_tpu_torch.models.vanilla import dense_collate
from tests.setup_and_params import EGNN_EPS, RESOURCES
from tests.test_torch_lucid import draw_params, port_from_jax
from tests.test_torch_siamese import check_clis_agree, \
    check_serve_and_resume, cli_argv, epochs, jax_trajectory, loaders, \
    port_trajectory, run_clis
from tests.test_torch_train_loader import write_types
from tests.test_train_trajectory import N_BATCHES

K, DIM_IN, LAYERS = 16, 12, 2
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
TRAJ_TOL = dict(atol=1e-4, rtol=1e-5)
FLAGS = {
    f'cutoff_{c}_norm_{int(n)}_res_{int(r)}': dict(cutoff=c, normalize=n,
                                                   residual=r)
    for c in (None, 4.0) for n in (False, True) for r in (False, True)}


def kwargs_of(name):
    return dict(dim_input=DIM_IN, k=K, num_layers=LAYERS, **FLAGS[name])


def random_samples(n_graphs, seed, multi=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.randint(6, 14))
        y = (rng.rand(3).astype(np.float32) if multi
             else np.float32(rng.randint(0, 2)))
        out.append(dict(node_feats=rng.rand(n, DIM_IN).astype(np.float32),
                        coords=(rng.rand(n, 3) * 6).astype(np.float32),
                        senders=np.zeros(0, np.int32),
                        receivers=np.zeros(0, np.int32),
                        edge_attr=np.zeros((0, 3), np.float32), y=y))
    return out


def batches(seed, slots=4, max_len=16, multi=False):
    """The same samples through both packages' dense_collate: one slot
    empty, padding atoms in every graph."""
    samples = random_samples(slots - 1, seed, multi)
    want = jax_dense_collate([JaxSample(**s) for s in samples], max_len,
                             num_graphs=slots)
    got = dense_collate([GraphSample(**s) for s in samples], max_len,
                        num_graphs=slots)
    return want, got


def port_dense(batch):
    return to_device(DenseBatch(*[np.asarray(a) for a in batch]),
                     torch.device('cpu'))


def model_params(name, batch, seed=0):
    model = build_jax_model('dense_egnn', **kwargs_of(name))
    return model, draw_params(model, batch, seed=seed)


@pytest.mark.parametrize('multi', [False, True], ids=['scalar', 'three'])
def test_collate_matches_jax(multi):
    want, got = batches(seed=1, multi=multi)
    for field in DenseBatch._fields:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), field)
    assert got.graph_mask.tolist() == [1, 1, 1, 0]


@pytest.mark.parametrize('name', sorted(FLAGS))
def test_forward_matches_jax(name):
    want_batch, batch = batches(seed=len(name))
    model, params = model_params(name, want_batch)
    want = np.asarray(jax.jit(model.apply)(params, want_batch))
    port = port_from_jax('dense_egnn', params, **kwargs_of(name))
    with torch.no_grad():
        got = port(port_dense(batch)).numpy()
        bare = port(tuple(port_dense(batch)[:3])).numpy()
    assert got.shape == (4, 1)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    np.testing.assert_array_equal(bare, got)


def resources_batch():
    loader = get_data_loader(RESOURCES, RESOURCES / 'test.types',
                             batch_size=2, radius=4, edge_radius=4,
                             estimate_bonds=True, polar_hydrogens=False,
                             layout='dense', prefetch=0)
    return next(iter(loader))[0]


@pytest.mark.parametrize('name', ['cutoff_None_norm_1_res_1',
                                  'cutoff_4.0_norm_1_res_1'])
def test_e3_invariance(name):
    batch = resources_batch()
    assert batch.p.shape[1] in DENSE_NODE_BUCKETS
    rotated = np.array(batch.p)
    for i in range(2):
        n = int(batch.m[i].sum())
        rotated[i, :n] = uniform_random_rotation(rotated[i, :n])
    _, params = model_params(name, batch)
    port = port_from_jax('dense_egnn', params, **kwargs_of(name))
    with torch.no_grad():
        a = port(port_dense(batch)).numpy()
        b = port(port_dense(batch._replace(
            p=rotated.astype(np.float32)))).numpy()
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=EGNN_EPS, rtol=0)


def test_gradients_finite_through_zero_radial_pairs():
    """The diagonal and the padding pairs have radial 0; the detached norm
    keeps every gradient finite."""
    _, batch = batches(seed=3)
    name = 'cutoff_None_norm_1_res_1'
    _, params = model_params(name, batch)
    port = port_from_jax('dense_egnn', params, **kwargs_of(name))
    dense = port_dense(batch)
    p = dense.p.clone().requires_grad_(True)
    port(dense._replace(p=p)).sum().backward()
    assert torch.isfinite(p.grad).all()
    # The last layer's coordinate MLP reaches no output: no gradient.
    grads = [q.grad for q in port.parameters() if q.grad is not None]
    assert len(grads) == len(list(port.parameters())) - 3
    assert all(torch.isfinite(g).all() for g in grads)


def test_state_dict_maps_every_leaf():
    _, batch = batches(seed=0)
    _, params = model_params('cutoff_4.0_norm_1_res_1', batch)
    sd = state_dict_from_flax(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    assert 'dense_layers.1.coord_mlp.2.weight' in sd
    assert 'dense_layers.1.coord_mlp.2.bias' not in sd
    stray = dict(params['params'], dense_layer_0=dict(
        params['params']['dense_layer_0'], gate={'kernel': np.zeros(1)}))
    with pytest.raises(KeyError, match='gate'):
        state_dict_from_flax(stray)


def test_trajectory_matches_jax():
    name = 'cutoff_4.0_norm_1_res_1'
    pairs = [batches(seed=10 + i) for i in range(N_BATCHES)]
    model, params = model_params(name, pairs[0][0], seed=5)
    want = jax_trajectory(model, params, [w for w, _ in pairs])
    port = port_from_jax('dense_egnn', params, **kwargs_of(name))
    got = port_trajectory(port, [port_dense(g) for _, g in pairs])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TRAJ_TOL)


@pytest.mark.parametrize('mode', ['val', 'train'])
def test_dense_batches_match_jax(tmp_path, mode):
    settings = dict(mode=mode)
    if mode == 'train':
        settings.update(rot=True, p_noise=0.3, p_remove_entity=0.3,
                        augmented_actives=1)
    jax_dl, port_dl = loaders(tmp_path, 'dense', settings)
    want, got = epochs(jax_dl, unstack=True), epochs(port_dl)
    assert len(got) == len(want) == 3 * len(port_dl)
    for (g, g_meta), (w, w_meta) in zip(got, want):
        assert isinstance(g, DenseBatch)
        for field in DenseBatch._fields:
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field), field)
        assert g_meta.lig_fnames == w_meta.lig_fnames


@pytest.fixture(scope='module')
def dense_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('dense_cli')
    types = write_types(root / 'train.types', n=40,
                        labels=lambda i: int(i % 3 == 0))
    flags = ['--egnn_residual', '--egnn_normalise', '--egnn_tanh']
    jax_trainer, port_trainer = run_clis(root, 'lie_conv', flags, types)
    alias_trainer = port_main(
        cli_argv('dense_egnn', root / 'alias', flags, types)
        + ['--load_weights', str(root / 'init.pt'), '--device', 'cpu'])
    return root, jax_trainer, port_trainer, alias_trainer


def test_cli_matches_jax(dense_runs):
    root, jax_trainer, port_trainer, _ = dense_runs
    assert port_trainer.input_kind == 'dense'
    check_clis_agree(root, jax_trainer, port_trainer)


def test_dense_egnn_alias_trains_the_same_run(dense_runs):
    root, _, port_trainer, alias_trainer = dense_runs
    assert alias_trainer.train_losses == port_trainer.train_losses
    assert (root / 'alias' / 'pose_predictions.txt').read_text() \
        == (root / 'port' / 'pose_predictions.txt').read_text()


def test_cli_serves_and_resumes(dense_runs):
    trainer = check_serve_and_resume(dense_runs[0] / 'port')
    assert trainer.model.__class__.__name__ == 'DenseEGNN'
