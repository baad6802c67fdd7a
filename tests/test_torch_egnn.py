"""The port's SartorrasEGNN forward against the JAX package's.

Same padded batch, same weights: a random parameter tree of the JAX
model's shapes (gates and GraphNorm parameters away from their init) goes
through ``state_dict_from_flax`` into the port. Tolerances: forward
1e-5 (the gate of tests/test_forward_parity.py), E(3) invariance 3e-5
(EGNN_EPS), parameter round trip exact.
"""
import jax
import numpy as np
import pytest
import torch

from pointvs_tpu.data.buckets import pad_graphs_to_batch
from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu.models.torch_import import torch_to_flax_params
from pointvs_tpu_torch.data.buckets import GraphBatch, to_device
from pointvs_tpu_torch.models.params import state_dict_from_flax
from pointvs_tpu_torch.models.registry import build_model
from tests.setup_and_params import EGNN_EPS, ORIGINAL_GRAPH, ROTATED_GRAPH
from tests.test_forward_parity import _random_samples

K, DIM_IN, LAYERS = 16, 12, 3
BASE = dict(residual=True, normalize=True, tanh=True, graphnorm=True)

CONFIGS = {
    'default': BASE,
    'sigmoid_attention': dict(BASE, edge_attention=True),
    'softmax_attention': dict(BASE, edge_attention=True,
                              softmax_attention=True),
}
# Further flag axes that serving reads, each on the unrolled layout.
EXTRA_CONFIGS = {
    'relu_node_attention_whole_batch': dict(
        BASE, edge_attention=True, node_attention=True,
        attention_activation_fn='relu', graphnorm_whole_batch=True),
    'rezero_edge_residual': dict(BASE, rezero=True, edge_residual=True,
                                 edge_attention=True,
                                 softmax_attention=True),
    'gated_permutation_invariant': dict(
        BASE, gated_residual=True, edge_residual=True,
        permutation_invariance=True, multi_fc=True, final_softplus=True),
    'static_coords_softmax': dict(BASE, edge_attention=True,
                                  softmax_attention=True,
                                  update_coords=False),
}


def jax_batch(n_graphs=4, seed=0):
    samples = _random_samples(n_graphs, seed=seed)
    return pad_graphs_to_batch(
        samples, num_graphs=n_graphs,
        n_pad=sum(s.num_nodes for s in samples) + 7,
        e_pad=sum(s.num_edges for s in samples) + 13)


def port_batch(batch):
    """The JAX package's GraphBatch as the port's, on the CPU."""
    fields = {f: getattr(batch, f) for f in GraphBatch._fields}
    return to_device(GraphBatch(**fields), torch.device('cpu'))


def jax_model_and_params(flags, batch, scan_layers, seed=0):
    """The JAX model and a random parameter tree of its shapes (drawn with
    numpy: kernels U(+-1/sqrt(fan_in)), vectors U(0.2, 1) so gates and
    GraphNorm scales are away from their init; no JAX init compile)."""
    model = build_jax_model('egnn', dim_input=DIM_IN, k=K, dim_output=1,
                            num_layers=LAYERS, scan_layers=scan_layers,
                            **flags)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch)
    rng = np.random.RandomState(seed)

    def draw(leaf):
        if len(leaf.shape) >= 2:
            bound = 1 / np.sqrt(leaf.shape[-2])
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        return rng.uniform(0.2, 1.0, leaf.shape).astype(np.float32)

    return model, jax.tree.map(draw, shapes)


def port_model(flags, params):
    model = build_model('egnn', dim_input=DIM_IN, k=K, dim_output=1,
                        num_layers=LAYERS, **flags)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model.eval()


def _check_forward(flags, scan_layers, n_graphs=4):
    batch = jax_batch(n_graphs, seed=len(str(flags)))
    model, params = jax_model_and_params(flags, batch, scan_layers)
    want = np.asarray(jax.jit(model.apply)(params, batch))
    with torch.no_grad():
        got = port_model(flags, params)(port_batch(batch)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('scan_layers', [False, True],
                         ids=['unrolled', 'scan'])
@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_forward_matches_jax(name, scan_layers):
    _check_forward(CONFIGS[name], scan_layers)


@pytest.mark.parametrize('name', sorted(EXTRA_CONFIGS))
def test_forward_matches_jax_flag_axes(name):
    _check_forward(EXTRA_CONFIGS[name], scan_layers=False)


def test_forward_matches_jax_on_symmetric_real_batch():
    """The test-resources complex: a symmetric radius graph, so the port
    takes its one-gather ``gather_pair`` path."""
    batch = ORIGINAL_GRAPH
    assert batch.inv_recv_perm is not None
    flags = CONFIGS['softmax_attention']
    model, params = jax_model_and_params(flags, batch, False)
    want = np.asarray(jax.jit(model.apply)(params, batch))
    with torch.no_grad():
        got = port_model(flags, params)(port_batch(batch)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_port_e3_invariance(name):
    flags = CONFIGS[name]
    _, params = jax_model_and_params(flags, ORIGINAL_GRAPH, False)
    model = port_model(flags, params)
    with torch.no_grad():
        a = model(port_batch(ORIGINAL_GRAPH)).numpy()
        b = model(port_batch(ROTATED_GRAPH)).numpy()
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=EGNN_EPS, rtol=0)


@pytest.mark.parametrize('scan_layers', [False, True],
                         ids=['unrolled', 'scan'])
def test_state_dict_round_trip(scan_layers):
    """port state_dict -> torch_to_flax_params == the original JAX tree."""
    flags = EXTRA_CONFIGS['rezero_edge_residual']
    batch = jax_batch(2)
    _, params = jax_model_and_params(flags, batch, scan_layers)
    sd = port_model(flags, params).state_dict()
    back = torch_to_flax_params(sd, params, 'egnn')
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf))


def test_out_of_slice_flags_raise():
    for flag, value in (('bf16', True), ('remat', True), ('dropout', 0.1),
                        ('include_strain_info', True)):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            build_model('egnn', dim_input=DIM_IN, k=K, dim_output=1,
                        **{flag: value})
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        build_model('lucid', dim_input=DIM_IN, k=K, dim_output=1)
