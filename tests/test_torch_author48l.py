"""The benchmark's configuration ``egnn_author48l`` in the port, on the CPU.

The configuration (``pvsbench/configs/egnn_author48l.json``) holds the
affinity predictor's recorded settings, 48 layers, k=32, 10 A edges with
estimated bonds, under a three-output ``multi_regression`` head, with the
README model's layer flags assumed. The port's ``SartorrasEGNN``, built
from those flags through the training CLI's ``parse_args`` and
``model_kwargs_from_args``, scores graphs from the port's featuriser as the
benchmark's plain reference (``pvsbench/reference/egnn.py``, which imports
nothing of the port) does on seeded random weights, and the reference in
TF32 does not; the screen scores a library with such a run by the mean of
the three outputs and ranks by it, and under a profiler keeps its eval
batches' real and bucket edges as counts on each path; and each layer of
the forward is a ``pointvs.model.layer`` span holding one
``pointvs.model.aggregate`` span while a profiler records.
"""
import json
from types import SimpleNamespace

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointvs_tpu_torch import tracing
from pointvs_tpu_torch.config import model_kwargs_from_args, parse_args
from pointvs_tpu_torch.data.buckets import to_device
from pointvs_tpu_torch.data.dataset import PointCloudDataset
from pointvs_tpu_torch.data.loader import GraphDataLoader
from pointvs_tpu_torch.models.registry import build_model
from pointvs_tpu_torch.parallel.steps import make_eval_step
from pointvs_tpu_torch.screen import screen
from pvsbench import inputs
from pvsbench.kinds.rescreen import write_run_dir
from pvsbench.reference import egnn as ref_egnn
from pvsbench.reference import featurise as ref_feat
from tests.setup_and_params import RESOURCES

REPO = RESOURCES.parents[1]
CONFIG = json.loads(
    (REPO / 'pvsbench' / 'configs' / 'egnn_author48l.json').read_text())
FLAGS = CONFIG['flags']
CPU = torch.device('cpu')
SEED = 2 ** 31 + 23
N_POSES = 3
# The port against the reference, both float32: sums in another order
# (K2's plain form and the sorted segment sums against index_add_) move
# the pK outputs by ~5e-7 after 48 layers of residual updates; TF32's
# 10-bit mantissa moves them by ~6e-5. 5e-6 lies ten times from each.
ATOL = 5e-6


@pytest.fixture(scope='module')
def library(tmp_path_factory):
    """(root, ligand names): seeded shifts of the test ligand in its
    pocket, the receptor and an unlabelled types file under ``root``."""
    root = tmp_path_factory.mktemp('author48l')
    lig = pq.read_table(RESOURCES / 'lig_0.parquet')
    xyz = np.stack([lig.column(c).to_numpy() for c in 'xyz'], axis=1)
    rng = np.random.default_rng(4)
    names = []
    for i in range(N_POSES):
        new = xyz + rng.standard_normal(3)
        table = lig
        for j, col in enumerate('xyz'):
            table = table.set_column(table.schema.get_field_index(col), col,
                                     [new[:, j]])
        names.append(f'pose_{i}.parquet')
        pq.write_table(table, root / names[-1])
    (root / 'rec_0.parquet').write_bytes(
        (RESOURCES / 'rec_0.parquet').read_bytes())
    (root / 'poses.types').write_text(''.join(
        f'-1 -1 -1 rec_0.parquet {name}\n' for name in names))
    return root, names


@pytest.fixture(scope='module')
def weights():
    schema = ref_egnn.param_schema(FLAGS['channels'], FLAGS['layers'],
                                   CONFIG['dim_input'], dim_output=3)
    return inputs.make_weights(schema, SEED, CPU)


@pytest.fixture(scope='module')
def model(weights):
    args = parse_args([CONFIG['model'], 'run'] + inputs.cli_flags(FLAGS))
    net = build_model(CONFIG['model'], **model_kwargs_from_args(
        args, CONFIG['dim_input']))
    net.load_state_dict(weights, strict=True)
    return net


@pytest.fixture(scope='module')
def samples(library):
    """The port's graphs of the library and one batch of all of them."""
    root, _ = library
    dataset = PointCloudDataset(
        root, root / 'poses.types', radius=FLAGS['radius'],
        edge_radius=FLAGS['edge_radius'],
        estimate_bonds=FLAGS['estimate_bonds'], compact=FLAGS['compact'],
        polar_hydrogens=False, model_task=CONFIG['task'])
    batch, _ = next(iter(GraphDataLoader(dataset, batch_size=N_POSES,
                                         mode='val')))
    return [dataset[i] for i in range(N_POSES)], to_device(batch, CPU)


def reference_outputs(graphs, weights, tf32=False) -> np.ndarray:
    with torch.no_grad():
        return ref_egnn.forward(
            weights, ref_egnn.block(graphs, CPU), FLAGS['layers'],
            ref_egnn.Precision(tf32)).double().numpy()


def reference_graphs(library) -> list:
    root, names = library
    rec = ref_feat.read_structure(root / 'rec_0.parquet')
    return [ref_feat.featurise(rec, ref_feat.read_structure(root / name),
                               FLAGS['radius'], FLAGS['edge_radius'],
                               FLAGS['estimate_bonds']) for name in names]


def test_port_matches_the_reference_and_tf32_does_not(library, weights,
                                                      model, samples):
    graphs, batch = samples
    assert model.num_layers == 48
    ported = [dict(feats=s.node_feats, coords=s.coords,
                   senders=s.senders.astype(np.int64),
                   receivers=s.receivers.astype(np.int64),
                   eclass=s.edge_attr.argmax(1).astype(np.int64))
              for s in graphs]
    # The port's featuriser gives the reference's graphs at 10 A with
    # estimated bonds: ~8-9.5k edges a pose.
    for port_g, ref_g in zip(ported, reference_graphs(library)):
        for key in ('feats', 'coords', 'senders', 'receivers', 'eclass'):
            np.testing.assert_array_equal(port_g[key], ref_g[key])
        assert len(ref_g['senders']) > 8000
    out = make_eval_step(model, CONFIG['task'])(batch)
    real = batch.graph_mask.reshape(-1) > 0
    got = out[real].double().numpy()
    assert got.shape == (N_POSES, 3)
    want = reference_outputs(ported, weights)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    control = reference_outputs(ported, weights, tf32=True)
    assert np.abs(control - want).max() > ATOL


def test_screen_scores_by_the_mean_of_three_outputs(library, weights,
                                                    tmp_path):
    """A 48-layer ``multi_regression`` run screens the library at batch 2
    (two eval steps, the second with one pose) from the resident store:
    each pose's score is the reference's mean of its three outputs, the
    rows are ranked by it, and under a profiler the eval batches' real
    and bucket edges are kept as counts."""
    root, names = library
    run = tmp_path / 'run'
    write_run_dir(SimpleNamespace(config=CONFIG), run, weights)
    tracing.take_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        result = screen(run, root / 'rec_0.parquet',
                        str(root / 'pose_*.parquet'),
                        output=tmp_path / 'hits.csv', batch_size=2,
                        device='cpu')
    graphs = reference_graphs(library)
    want = reference_outputs(graphs, weights).mean(axis=1)
    by_name = {r['ligand']: r for r in result.rows}
    got = np.array([by_name[str(root / name)]['score'] for name in names])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # Scores lie far enough apart for the ranks to be the reference's.
    assert np.diff(np.sort(want)).min() > 4 * ATOL
    assert [r['ligand'] for r in result.rows] == [
        str(root / names[i]) for i in np.argsort(-want)]
    assert [r['rank'] for r in result.rows] == [1, 2, 3]
    real = sum(len(g['senders']) for g in graphs)
    (real_name, got_real), (padded_name, padded) = tracing.take_counts()
    assert (real_name, got_real) == ('pointvs.screen.real_edges', real)
    assert padded_name == 'pointvs.screen.padded_edges'
    assert padded % 2 == 0 and real <= padded <= 2 * real  # two batches
    screen(run, root / 'rec_0.parquet', str(root / 'pose_*.parquet'),
           output=tmp_path / 'again.csv', batch_size=2, device='cpu')
    assert tracing.take_counts() == []   # nothing kept without a profiler


# The layer's aggregation on each branch: K2's fused softmax (this
# model's), K1's fused sum and mean without attention, and K1's
# sum with static coordinates.
BRANCHES = {'author48l': None,
            'no_attention': dict(edge_attention=False),
            'static_coords': dict(edge_attention=False,
                                  update_coords=False)}


@pytest.mark.parametrize('branch', sorted(BRANCHES))
def test_each_layer_is_a_span_with_one_aggregate(model, samples, branch):
    _, batch = samples
    net = model
    if BRANCHES[branch] is not None:
        net = build_model('egnn', dim_input=12, k=16, dim_output=3,
                          num_layers=3, **BRANCHES[branch])
    step = make_eval_step(net, CONFIG['task'])
    tracing.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        step(batch)
    kept = tracing.take_spans()
    layers = [(a, b) for n, a, b in kept if n == 'pointvs.model.layer']
    aggregates = [(a, b) for n, a, b in kept
                  if n == 'pointvs.model.aggregate']
    assert len(layers) == net.num_layers == len(aggregates)
    for lo, hi in layers:
        assert sum(lo <= a and b <= hi for a, b in aggregates) == 1
    step(batch)
    assert tracing.take_spans() == []


# The screen's paths, by the variables that choose them: the chunked path
# pads each budget batch to POINTVS_SCREEN_EDGE_BUDGET's edges (131,072;
# here a chunk of 0.02 MB holds one pose); the others pin one bucket for
# every batch.
PATHS = {'resident': {}, 'streaming': dict(POINTVS_SCREEN_DEVICE='0'),
         'chunked': dict(POINTVS_SCREEN_CHUNK_MB='0.02')}


@pytest.mark.parametrize('path', sorted(PATHS))
def test_screen_keeps_the_edges_on_each_path(library, tmp_path, monkeypatch,
                                             path):
    """A two-layer run of the model at batch 2, under a profiler: two eval
    steps of one bucket (a budget batch a chunk on the chunked path),
    holding the library's real edges."""
    for var, value in PATHS[path].items():
        monkeypatch.setenv(var, value)
    root, names = library
    config = dict(CONFIG, flags=dict(FLAGS, layers=2))
    weights = inputs.make_weights(ref_egnn.param_schema(
        FLAGS['channels'], 2, CONFIG['dim_input'], dim_output=3), SEED, CPU)
    write_run_dir(SimpleNamespace(config=config), tmp_path / 'run', weights)
    tracing.take_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        result = screen(tmp_path / 'run', root / 'rec_0.parquet',
                        str(root / 'pose_*.parquet'),
                        output=tmp_path / 'hits.csv', batch_size=2,
                        device='cpu')
    assert result.path == path
    real = sum(len(g['senders']) for g in reference_graphs(library))
    counts = tracing.take_counts()
    assert len(counts) == 2
    counts = dict(counts)
    assert counts['pointvs.screen.real_edges'] == real
    padded = counts['pointvs.screen.padded_edges']
    if path == 'chunked':
        assert padded == N_POSES * 131072
    else:
        assert padded % 2 == 0 and real <= padded <= 2 * real
