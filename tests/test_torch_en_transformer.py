"""The port's en_transformer family (alias lie_transformer) against the
JAX package's.

Same batches and weights as tests/test_torch_lucid.py (asymmetric and
symmetric, both with padding edges and real nodes that receive no edge).
Gates: forward 1e-5 over heads 2/4, update_coords and tanh, in the
unrolled and the scan layout; the per-head softmax sums to 1 +- 1e-6 per
node and head (tests/test_en_transformer.py's gate) with all heads in one
K1 launch; E(3) invariance 3e-5; a 20-step loss trajectory within atol
1e-4 / rtol 1e-5 of JAX's. The family has no reference state_dict schema:
its keys follow the JAX module names, ``state_dict_from_flax`` reads both
layouts, and ``load_state_dict(state_dict())`` is the identity. The
serving CLI scores a port run directory as the JAX model scores the same
weights (the JAX package reads no ``.pt`` of this family, so its forward
stands in for its CLI).
"""
import jax
import numpy as np
import pytest
import torch

from pointvs_tpu.data.buckets import pad_graphs_to_batch
from pointvs_tpu.data.dataset import PointCloudDataset
from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu.utils import save_yaml
from pointvs_tpu_torch import inference
from pointvs_tpu_torch.models.registry import MODEL_REGISTRY, build_model
from pointvs_tpu_torch.ops import segment_kernels
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from tests.setup_and_params import EGNN_EPS, ORIGINAL_GRAPH, RESOURCES, \
    ROTATED_GRAPH
from tests.test_torch_egnn import port_batch
from tests.test_torch_lucid import (DIM_IN, FWD_TOL, K, LAYERS, TRAJ_TOL,
                                    batch_of, draw_params, forward_pair,
                                    port_from_jax, port_trajectory,
                                    trajectory_batches)
from tests.test_train_trajectory import N_BATCHES, _jax_trajectory

CONFIGS = {
    'heads2': dict(heads=2),
    'heads4': dict(heads=4),
    'static_coords': dict(heads=4, update_coords=False),
    'no_tanh_softplus': dict(heads=2, tanh=False, final_softplus=True),
}


@pytest.mark.parametrize('kind', ['asym', 'sym'])
@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_forward_matches_jax(name, kind):
    want, got = forward_pair('en_transformer', dict(CONFIGS[name]),
                             batch_of(kind, seed=len(name)))
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_scan_layout_and_alias_match_jax():
    """The scan-stacked JAX layout carried into per-layer modules; the
    registry's lie_transformer is the same model."""
    assert MODEL_REGISTRY['lie_transformer'] is MODEL_REGISTRY[
        'en_transformer']
    want, got = forward_pair('en_transformer', dict(CONFIGS['heads4']),
                             batch_of('asym'), scan_layers=True)
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_per_head_softmax_sums_to_one():
    """All H heads take one K1 launch's worth of denominators (plain
    here); each head's softmax sums to 1 +- 1e-6 over a sender's unmasked
    edges, masked edges get 0, and each column equals the one-column
    softmax."""
    batch = port_batch(batch_of('asym', seed=5))
    n = batch.node_feats.shape[0]
    agg = EdgeAggregator(batch.senders, batch.receivers, batch.edge_mask, n,
                         recv_perm=batch.recv_perm)
    logits = torch.from_numpy(
        np.random.RandomState(0).randn(len(batch.senders), 4).astype(
            np.float32) * 3)
    att = agg.softmax_src(logits)
    sums = segment_kernels.windowed_segment_sum_plain(att, batch.senders, n)
    has_edges = segment_kernels.windowed_segment_sum_plain(
        batch.edge_mask[:, None], batch.senders, n)[:, 0] > 0
    np.testing.assert_allclose(sums[has_edges].numpy(), 1.0, atol=1e-6)
    assert (att[batch.edge_mask == 0] == 0).all()
    for h in range(4):
        torch.testing.assert_close(att[:, h],
                                   agg.softmax_src(logits[:, h]),
                                   atol=0, rtol=0)


def test_e3_invariance():
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  heads=4)
    params = draw_params(build_jax_model('en_transformer', **kwargs),
                         ORIGINAL_GRAPH)
    model = port_from_jax('en_transformer', params, **kwargs)
    with torch.no_grad():
        a = model(port_batch(ORIGINAL_GRAPH)).numpy()
        b = model(port_batch(ROTATED_GRAPH)).numpy()
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=EGNN_EPS, rtol=0)


def test_trajectory_matches_jax():
    batches = trajectory_batches(22)
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  heads=4)
    model = build_jax_model('en_transformer', scan_layers=False, **kwargs)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batches[0])
    want, _ = _jax_trajectory(model, params, batches, 'classification')
    got = port_trajectory(port_from_jax('en_transformer', params, **kwargs),
                          batches, 'classification')
    assert got[-N_BATCHES] < got[0]   # it trained
    np.testing.assert_allclose(got, want, **TRAJ_TOL)


def test_state_dict_keys_init_and_round_trip():
    """JAX module names as keys; the coordinate MLP's last Linear is
    bias-free at gain 0.001; both JAX layouts give the same state_dict,
    which loads back unchanged."""
    from pointvs_tpu_torch.models.layers import init_parameters
    from pointvs_tpu_torch.models.params import state_dict_from_flax
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  heads=4)
    batch = batch_of('asym')
    params = draw_params(build_jax_model('en_transformer', **kwargs), batch)
    stacked = jax.tree.map(
        lambda *leaves: np.stack(leaves),
        *[params['params'][f'tf_layer_{i}'] for i in range(LAYERS)])
    scan = {'params': {key: value for key, value in params['params'].items()
                       if not key.startswith('tf_layer_')}}
    scan['params']['tf_scan'] = stacked
    sd = state_dict_from_flax(params)
    sd_scan = state_dict_from_flax(scan)
    assert sorted(sd) == sorted(sd_scan)
    for key in sd:
        assert torch.equal(sd[key], sd_scan[key]), key
    assert {'input_embed.weight', 'tf_layer_0.q_proj.weight',
            'tf_layer_1.edge_bias.2.weight', 'tf_layer_0.ff_norm.bias',
            'tf_layer_1.coord_mlp.2.weight', 'head.0.bias'} <= set(sd)
    assert 'tf_layer_0.coord_mlp.2.bias' not in sd
    model = build_model('en_transformer', **kwargs)
    model.load_state_dict(sd, strict=True)
    for key, value in model.state_dict().items():
        assert torch.equal(value, sd[key]), key
    init_parameters(model, torch.Generator().manual_seed(0))
    last = model.tf_layer_0.coord_mlp[2].weight.detach()
    assert float(last.abs().max()) <= 0.001 * np.sqrt(6 / (K + 4))


def test_serving_cli_scores_like_jax(tmp_path):
    """A port run directory (.pt + sidecars) scored by the port's serving
    CLI on the CPU, against the JAX model's forward on the same weights
    and the same featurised batch."""
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  heads=2)
    model = build_jax_model('en_transformer', **kwargs)
    params = draw_params(model, ORIGINAL_GRAPH, seed=9)
    port = port_from_jax('en_transformer', params, **kwargs)
    run = tmp_path / 'run'
    (run / 'checkpoints').mkdir(parents=True)
    torch.save({'model_state_dict': port.state_dict(), 'p_epoch': 1,
                'a_epoch': 0}, run / 'checkpoints' / 'pose_ckpt_epoch_1.pt')
    save_yaml(dict(kwargs, model_task='classification'),
              run / 'model_kwargs.yaml')
    save_yaml({'model': 'lie_transformer', 'batch_size': 2, 'radius': 4,
               'edge_radius': 4, 'estimate_bonds': True, 'compact': True},
              run / 'cmd_args.yaml')
    trainer = inference.main([str(run), str(RESOURCES / 'test.types'),
                              str(RESOURCES), '--device', 'cpu'])
    ds = PointCloudDataset(
        RESOURCES, radius=4, polar_hydrogens=False, compact=True,
        types_fname=RESOURCES / 'test.types', edge_radius=4,
        estimate_bonds=True, model_task='classification')
    batch = pad_graphs_to_batch([ds[0], ds[1]], num_graphs=2)
    logits = np.asarray(jax.jit(model.apply)(params, batch))[:, 0]
    np.testing.assert_allclose(trainer.val_scores, 1 / (1 + np.exp(-logits)),
                               atol=1e-5)
    assert len((run / 'pose_predictions.txt').read_text().splitlines()) == 2
