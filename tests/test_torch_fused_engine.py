"""The port's fused engines against the JAX package's.

``inference_engine.fused_forward`` (K3 in every layer) against the JAX
``fused_forward`` (Pallas in interpret mode) for the five variants of
tests/test_fused_engine.py, atol 3e-5; ``fused_train.fused_apply``
(K3 forward, K4 backward, K1 scatters) against the JAX ``fused_apply``
for the variants of tests/test_fused_train.py: outputs 2e-5, coordinate
gradients 3e-5, parameter gradients 3e-5 x max(1, |ref|), and against the
port's own module-path autograd at the same gates. With
``graphnorm_whole_batch`` the fused paths take per-graph statistics and
the module path whole-batch ones, in both packages. The model is cut to k=16 (2
to 3 layers) to keep the CPU time small.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu.training.losses import loss_fn as jax_loss_fn
from pointvs_tpu_torch.fused_train import fused_apply, \
    supports_fused_training
from pointvs_tpu_torch.inference_engine import fused_forward, \
    supports_fusion
from pointvs_tpu_torch.models.params import state_dict_from_flax
from pointvs_tpu_torch.models.registry import build_model
from pointvs_tpu_torch.training.losses import loss_fn
from tests.setup_and_params import MODEL_KWARGS, ORIGINAL_GRAPH
from tests.test_fused_engine import _pad_nodes
from tests.test_torch_egnn import port_batch


def _port_model_from_jax(kwargs, params):
    model = build_model('egnn', **kwargs)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


ENGINE_VARIANTS = {
    'softmax_attention': {},
    'sigmoid_attention': {'softmax_attention': False},
    'no_attention': {'edge_attention': False, 'node_attention': False,
                     'softmax_attention': False},
    'edge_residual': {'edge_residual': True},
    'no_graphnorm': {'graphnorm': False, 'normalize': False, 'tanh': False},
}
SMALL = dict(MODEL_KWARGS, k=16, num_layers=3)
SMALL_TRAIN = dict(SMALL, num_layers=2)


@pytest.mark.parametrize('variant', sorted(ENGINE_VARIANTS))
def test_fused_forward_matches_jax(variant):
    from pointvs_tpu.inference_engine import fused_forward as jax_fused
    kwargs = dict(SMALL, **ENGINE_VARIANTS[variant])
    batch = _pad_nodes(ORIGINAL_GRAPH)
    model = build_jax_model('egnn', **kwargs)
    params = model.init(jax.random.PRNGKey(2), batch)
    want = np.asarray(jax_fused(model, params, batch, interpret=True))
    port = _port_model_from_jax(kwargs, params)
    assert supports_fusion(port)
    got = fused_forward(port, port_batch(batch)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)
    with torch.no_grad():
        module = port(port_batch(batch)).numpy()
    np.testing.assert_allclose(got, module, atol=3e-5)


TRAIN_VARIANTS = dict(ENGINE_VARIANTS, scan_layers={'scan_layers': True})


def _train_batch():
    from pointvs_tpu.data.buckets import pad_graphs_to_batch
    from pointvs_tpu.data.dataset import PointCloudDataset
    from tests.setup_and_params import RESOURCES
    ds = PointCloudDataset(
        RESOURCES, radius=4, polar_hydrogens=False, compact=True,
        types_fname=RESOURCES / 'test.types', edge_radius=4,
        estimate_bonds=True, model_task='classification')
    return _pad_nodes(pad_graphs_to_batch([ds[0], ds[1]], num_graphs=2))


def _port_grads(model, batch, fused):
    coords = batch.coords.clone().requires_grad_(True)
    b = batch._replace(coords=coords)
    out = fused_apply(model, b) if fused else model(b)
    s, w = loss_fn(out, b, 'classification', 'mse')
    model.zero_grad()
    (s / torch.clamp_min(w, 1.0)).backward()
    # A parameter that does not reach the loss (the last layer's
    # coordinate MLP on the module path) has the zero gradient JAX gives it.
    return (out.detach().numpy(), coords.grad.numpy(),
            {n: (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                 else p.grad.numpy().copy())
             for n, p in model.named_parameters()})


@pytest.mark.parametrize('variant', sorted(TRAIN_VARIANTS))
def test_fused_apply_matches_jax(variant):
    from pointvs_tpu.fused_train import fused_apply as jax_fused_apply
    kwargs = dict(SMALL_TRAIN, **TRAIN_VARIANTS[variant])
    batch = _train_batch()
    model = build_jax_model('egnn', **kwargs)
    params = model.init(jax.random.PRNGKey(2), batch)

    def loss(p, coords):
        out = jax_fused_apply(model, p, batch._replace(coords=coords),
                              interpret=True)
        s, w = jax_loss_fn(out, batch, 'classification', 'mse')
        return s / jnp.maximum(w, 1.0), out

    (_, want_out), (g_params, g_coords) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(batch.coords))
    want_grads = state_dict_from_flax(jax.tree.map(np.asarray, g_params))

    port = _port_model_from_jax(kwargs, params)
    pb = port_batch(batch)
    assert supports_fused_training(port, pb)
    out, coord_grad, grads = _port_grads(port, pb, fused=True)
    np.testing.assert_allclose(out, np.asarray(want_out), atol=2e-5)
    np.testing.assert_allclose(coord_grad, np.asarray(g_coords), atol=3e-5)
    _, module_coord_grad, module_grads = _port_grads(port, pb, fused=False)
    np.testing.assert_allclose(coord_grad, module_coord_grad, atol=3e-5)
    assert set(grads) == set(module_grads)
    for name, g in grads.items():
        for ref in (want_grads[name].numpy(), module_grads[name]):
            scale = max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(g, ref, atol=3e-5 * scale, rtol=0,
                                       err_msg=name)


def _two_pockets_batch():
    """One complex boxed at 4 and at 6 A: two different graphs, on which
    per-graph and whole-batch statistics differ."""
    from pointvs_tpu.data.buckets import pad_graphs_to_batch
    from pointvs_tpu.data.dataset import PointCloudDataset
    from tests.setup_and_params import RESOURCES
    samples = [PointCloudDataset(
        RESOURCES, radius=radius, polar_hydrogens=False, compact=True,
        types_fname=RESOURCES / 'test.types', edge_radius=4,
        estimate_bonds=True, model_task='classification')[0]
        for radius in (4, 6)]
    return _pad_nodes(pad_graphs_to_batch(samples, num_graphs=2))


@pytest.mark.parametrize('variant', ['softmax_attention', 'sigmoid_attention'])
def test_whole_batch_graphnorm_fused_matches_module_and_jax(variant):
    """``graphnorm_whole_batch=True``: the fused paths take per-graph
    GraphNorm statistics, as the JAX fused engines do, and the module path
    the whole batch's, as JAX's ``model.apply`` does (ROADMAP Queue 3).
    The port's fused forward and ``fused_apply`` equal JAX's
    ``fused_forward`` / ``fused_apply``, and its module path JAX's module
    path, at the gates of the tests above."""
    from pointvs_tpu.fused_train import fused_apply as jax_fused_apply
    from pointvs_tpu.inference_engine import fused_forward as jax_fused
    kwargs = dict(SMALL_TRAIN, graphnorm_whole_batch=True,
                  **ENGINE_VARIANTS[variant])
    batch = _two_pockets_batch()
    model = build_jax_model('egnn', **kwargs)
    params = model.init(jax.random.PRNGKey(3), batch)

    def grads_of(apply):
        def loss(p, coords):
            out = apply(p, batch._replace(coords=coords))
            s, w = jax_loss_fn(out, batch, 'classification', 'mse')
            return s / jnp.maximum(w, 1.0), out
        (_, out), (g_params, g_coords) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(
                params, jnp.asarray(batch.coords))
        return (np.asarray(out), np.asarray(g_coords),
                state_dict_from_flax(jax.tree.map(np.asarray, g_params)))

    want = {
        True: grads_of(lambda p, b: jax_fused_apply(model, p, b,
                                                    interpret=True)),
        False: grads_of(model.apply)}
    port = _port_model_from_jax(kwargs, params)
    pb = port_batch(batch)
    assert supports_fusion(port) and supports_fused_training(port, pb)
    with torch.no_grad():
        np.testing.assert_allclose(
            fused_forward(port, pb).numpy(),
            np.asarray(jax_fused(model, params, batch, interpret=True)),
            atol=3e-5)
        np.testing.assert_allclose(port(pb).numpy(), want[False][0],
                                   atol=2e-5)
    # The two statistics give different logits on this batch.
    assert np.abs(want[True][0] - want[False][0]).max() > 1e-4
    for fused in (True, False):
        out, coord_grad, grads = _port_grads(port, pb, fused=fused)
        want_out, want_coords, want_grads = want[fused]
        np.testing.assert_allclose(out, want_out, atol=2e-5)
        np.testing.assert_allclose(coord_grad, want_coords, atol=3e-5)
        assert set(grads) == set(want_grads)
        for name in grads:
            ref = want_grads[name].numpy()
            scale = max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(grads[name], ref,
                                       atol=3e-5 * scale, rtol=0,
                                       err_msg=name)
