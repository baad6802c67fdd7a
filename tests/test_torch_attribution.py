"""Attribution in the port (``pointvs_tpu_torch/attribution``) against the
JAX package.

- Each of the 12 names of ``ATTRIBUTION_FNS`` on the same weights
  (``state_dict_from_flax``) and the same one-graph batch, for egnn with
  the README flags (softmax edge attention), egnn with sigmoid edge and
  node attention, multitask (the pose and the affinity head), lucid (soft
  edge gate) and en_transformer: atom and bond masking deltas within
  2e-5; attention values, cam, displacements and bond-length changes
  within 3e-5; the mean ranks equal wherever the underlying values differ
  by more than 3e-5. Where the JAX function stops (a method the model has
  no values for), the port's stops too. JAX runs on the CPU.
- ``capture_aux`` (the unfused branch) gives the fused branch's logits
  within 1e-5, in both packages; the tiled masking equals deleting each
  atom's masks one forward at a time.
- The siamese and dense families are refused by name.

The graph is the test complex boxed at 3 A with 3 A edges (53 atoms,
344 edges, 178 of them ligand-receptor). The driver and the entry points
are held against JAX in ``tests/test_torch_attribution_driver.py``.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from pointvs_tpu.attribution import attribution_fns as jax_fns
from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu.data import get_data_loader
from pointvs_tpu_torch.attribution import attribution_fns as port_fns
from tests.setup_and_params import RESOURCES
from tests.test_torch_egnn import port_batch
from tests.test_torch_lucid import draw_params, port_from_jax

K, DIM_IN, LAYERS = 16, 12, 3
EGNN = dict(residual=True, normalize=True, tanh=True, graphnorm=True)
CONFIGS = {
    'egnn_readme': ('egnn', dict(EGNN, edge_attention=True,
                                 softmax_attention=True), None),
    'egnn_node_sigmoid': ('egnn', dict(EGNN, edge_attention=True,
                                       node_attention=True), None),
    'multitask_pose': ('multitask', dict(
        EGNN, edge_attention=True, softmax_attention=True,
        node_attention=True, dim_output=3), 'classification'),
    'multitask_affinity': ('multitask', dict(
        EGNN, edge_attention=True, softmax_attention=True,
        node_attention=True, dim_output=3), 'multi_regression'),
    'lucid': ('lucid', dict(attention=True, norm_coords=True,
                            norm_feats=True, graphnorm=True), None),
    'en_transformer': ('en_transformer', dict(heads=4), None),
}
MASKING = ('atom_masking', 'masking', 'bond_masking')
RANKS = ('mean_node_attention_rank', 'mean_edge_attention_rank')
MASK_TOL, VALUE_TOL = 2e-5, 3e-5


def _one_graph(radius=3, edge_radius=3):
    """The first test complex as the JAX package's one-graph batch."""
    loader = get_data_loader(
        data_root=RESOURCES, types_fname=RESOURCES / 'test.types',
        batch_size=1, compact=True, radius=radius, edge_radius=edge_radius,
        estimate_bonds=True, polar_hydrogens=False, mode='val', prefetch=0)
    batch = next(iter(loader))[0]
    return type(batch)(*[None if a is None else np.asarray(a)[0]
                         for a in batch])


ORIGINAL_GRAPH = _one_graph()


@lru_cache(maxsize=None)
def models(config):
    """(JAX model, params, port model, task) of a config."""
    name, flags, task = CONFIGS[config]
    kwargs = dict(dim_input=DIM_IN, k=K, num_layers=LAYERS,
                  **dict(dict(dim_output=1), **flags))
    model = build_jax_model(name, **kwargs)
    params = draw_params(model, ORIGINAL_GRAPH, seed=11)
    port = port_from_jax(name, params, **kwargs)
    return model, params, port, task


def jax_scores(config, fn_name):
    """JAX's scores, or the exception type it stops with (once per
    function: several names share one)."""
    return _jax_scores(config, jax_fns.ATTRIBUTION_FNS[fn_name])


@lru_cache(maxsize=None)
def _jax_layers(config):
    """JAX's per-layer aux of a config's forward (computed once; the JAX
    functions that read it each run the forward again)."""
    model, params, _, task = models(config)
    return _JAX_LAYER_AUX(model, params, ORIGINAL_GRAPH, task)


_JAX_LAYER_AUX = jax_fns._layer_aux


@lru_cache(maxsize=None)
def _jax_tiled(config):
    """One tiled masking function a config, so that atom and bond masking
    share its compiled program (the JAX package builds one a call)."""
    model, _, _, task = models(config)
    return _JAX_TILED(model, task)


_JAX_TILED = jax_fns.functools_partial_tiled


@lru_cache(maxsize=None)
def _jax_scores(config, fn):
    model, params, _, task = models(config)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_fns, '_layer_aux',
                      lambda *args, **kwargs: _jax_layers(config))
        patch.setattr(jax_fns, 'functools_partial_tiled',
                      lambda *args, **kwargs: _jax_tiled(config))
        try:
            return np.asarray(fn(model, params, ORIGINAL_GRAPH, task=task))
        except Exception as exc:   # the reference stops here
            return type(exc)


def _near_ties(values: np.ndarray, tol: float) -> np.ndarray:
    """For each item, how many other items' values lie within ``tol`` of
    its own (each such item can swap ranks with it)."""
    ordered = np.sort(values)
    return (np.searchsorted(ordered, values + tol, side='right')
            - np.searchsorted(ordered, values - tol, side='left') - 1)


def _check_ranks(config, fn_name, got, want):
    """The mean ranks are equal where each layer's value is more than
    3e-5 from every other item's; elsewhere they differ by at most the
    mean count of such near ties."""
    layers = _jax_layers(config)
    key = 'node_att_val' if 'node' in fn_name else 'att_val'
    mask = ORIGINAL_GRAPH.node_mask if 'node' in fn_name \
        else ORIGINAL_GRAPH.edge_mask
    n = int(np.asarray(mask).sum())
    slack = np.mean([_near_ties(np.asarray(aux[key]).reshape(-1)[:n],
                                VALUE_TOL)
                     for aux in layers[:10] if key in aux], axis=0)
    assert (slack == 0).any()
    assert np.all(np.abs(got - want) <= slack + 1e-9)


@pytest.mark.parametrize('fn_name', sorted(jax_fns.ATTRIBUTION_FNS))
@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_attribution_matches_jax(config, fn_name):
    assert sorted(port_fns.ATTRIBUTION_FNS) == sorted(
        jax_fns.ATTRIBUTION_FNS)
    want = jax_scores(config, fn_name)
    _, _, port, task = models(config)
    batch = port_batch(ORIGINAL_GRAPH)
    fn = port_fns.ATTRIBUTION_FNS[fn_name]
    if isinstance(want, type):
        # The model has no such values (no node / edge attention, no
        # include_strain_info head): the reference stops with KeyError
        # (a missing aux entry), ValueError (no layer to rank) or
        # AttributeError (cam); the port with KeyError or ValueError.
        assert want in (KeyError, ValueError, AttributeError), want
        with pytest.raises((KeyError, ValueError)):
            fn(port, batch, task=task)
        return
    got = fn(port, batch, task=task)
    assert got.shape == want.shape
    if fn_name in RANKS:
        _check_ranks(config, fn_name, got, want)
    else:
        tol = MASK_TOL if fn_name in MASKING else VALUE_TOL
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert np.abs(got).max() > 0


def test_every_method_runs_somewhere():
    """Each method gives scores on at least one config (none is covered
    by refusals alone)."""
    for fn_name in jax_fns.ATTRIBUTION_FNS:
        assert any(not isinstance(jax_scores(c, fn_name), type)
                   for c in CONFIGS), fn_name


@pytest.mark.parametrize('config', ['egnn_readme', 'egnn_node_sigmoid',
                                    'multitask_affinity'])
def test_capture_aux_logits_match_the_fused_branch(config):
    model, params, port, task = models(config)
    kwargs = {'task': task} if task else {}
    want = np.asarray(model.apply(params, ORIGINAL_GRAPH, **kwargs))
    want_aux = np.asarray(model.apply(params, ORIGINAL_GRAPH,
                                      capture_aux=True, **kwargs)[0])
    batch = port_batch(ORIGINAL_GRAPH)
    with torch.no_grad():
        fused = port(batch, **kwargs).numpy()
        unfused, aux = port(batch, capture_aux=True, **kwargs)
    np.testing.assert_allclose(unfused.numpy(), fused, atol=1e-5, rtol=0)
    np.testing.assert_allclose(fused, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(unfused.numpy(), want_aux, atol=1e-5, rtol=0)
    assert len(aux['layers']) == LAYERS
    assert {'att_val', 'intermediate_coords'} <= set(aux['layers'][0])
    assert aux['node_embeddings'].shape == (ORIGINAL_GRAPH.node_mask.shape[0],
                                            K)


def test_tiled_masking_equals_deleting_each_atom():
    _, _, port, _ = models('egnn_readme')
    batch = port_batch(ORIGINAL_GRAPH)
    scores = port_fns.atom_masking(port, batch)
    with torch.no_grad():
        original = float(port(batch)[0, 0])
        for i in (0, 3, 11, len(scores) - 1):
            gone = (batch.senders == i) | (batch.receivers == i)
            masked = batch._replace(
                node_mask=batch.node_mask.clone().index_fill_(0, torch.tensor(
                    [i]), 0.0),
                edge_mask=torch.where(gone, 0.0, batch.edge_mask))
            want = original - float(port(masked)[0, 0])
            assert abs(scores[i] - want) <= 1e-5


@pytest.mark.parametrize('chunk', [1, 7, 32, 200])
def test_masking_chunk_size_does_not_change_the_scores(chunk, monkeypatch):
    _, _, port, _ = models('egnn_node_sigmoid')
    batch = port_batch(ORIGINAL_GRAPH)
    want = port_fns.atom_masking(port, batch)
    n_pad = batch.node_mask.shape[0]
    gone = np.eye(n_pad, dtype=np.float32)[:len(want)]
    got = port_fns._masked_deltas(port, batch, gone, None, chunk=chunk)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize('family', ['siamese', 'dense_egnn'])
def test_pair_and_dense_families_are_refused(family):
    from pointvs_tpu_torch.models.registry import build_model
    model = build_model(family, dim_input=DIM_IN, k=K, dim_output=1,
                        num_layers=1)
    batch = port_batch(ORIGINAL_GRAPH)
    for name in ('atom_masking', 'cam', 'edge_attention'):
        with pytest.raises(ValueError, match='capture_aux'):
            port_fns.ATTRIBUTION_FNS[name](model, batch)
