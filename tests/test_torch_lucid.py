"""The port's lucid family against the JAX package's.

Same padded batches, same weights: a parameter tree of the JAX model's
shapes drawn with numpy goes through ``state_dict_from_flax`` into the
port. Every case runs an asymmetric batch (random receivers: its
receiver-sorted order has other degrees than its sender order) and a
symmetric one (each edge and its reverse; the port takes ``gather_pair``),
both with padding edges and with real nodes that receive no edge. Gates:
forward 1e-5 (the JAX suite's), E(3) invariance 3e-5, a 20-step loss
trajectory within atol 1e-4 / rtol 1e-5 of JAX's ``make_train_step``
(dropout 0), ``sum_to_dst`` / ``mean_to_dst`` and their gradients 1e-5,
parameters carried across exactly. Also: a reference-schema state_dict
(JAX weights put into ``testing/torch_ref.RefLucidEGNN`` by
``load_flax_lucid_params``, re-keyed as the reference saves it) loads and
gives the reference's forward; gradients stay finite through
padding edges; a training forward with dropout equals the reference's
under the same JAX key, its own lucid layer made compact (the reference's
refuses dropout > 0 at init), unscanned and scanned.

The shared helpers here (batches, parameter draws, the port trajectory)
serve ``test_torch_multitask.py`` and ``test_torch_en_transformer.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvs_tpu.data.buckets import GraphSample, pad_graphs_to_batch
from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu.models.torch_import import torch_to_flax_params
from pointvs_tpu.ops.aggregate import EdgeAggregator as JaxAggregator
from pointvs_tpu.testing.torch_ref import RefLucidEGNN, \
    load_flax_lucid_params, samples_to_torch_batch
from pointvs_tpu_torch.models.params import state_dict_from_flax
from pointvs_tpu_torch.models.registry import build_model
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from pointvs_tpu_torch.parallel.steps import make_train_step
from pointvs_tpu_torch.training import optimisers
from tests.setup_and_params import EGNN_EPS, ORIGINAL_GRAPH, ROTATED_GRAPH
from tests.test_forward_parity import _random_samples
from tests.test_torch_egnn import jax_batch, port_batch
from tests.test_torch_import import ref_state_dict_lucid
from tests.test_train_trajectory import LR, N_BATCHES, N_GRAPHS, WD, \
    _jax_trajectory
from tests.test_train_trajectory import _random_samples as _traj_samples

K, DIM_IN, LAYERS = 16, 12, 2
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
TRAJ_TOL = dict(atol=1e-4, rtol=1e-5)


# ----------------------------------------------------------- helpers
def sym_batch(n_graphs=3, seed=0):
    """Symmetric edge lists (every edge and its reverse, the same class
    both ways); each graph's last node has no edge."""
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(n_graphs):
        n = int(rng.randint(8, 16))
        pairs = set()
        while len(pairs) < 2 * n:
            a, b = rng.randint(0, n - 1, 2)
            if a != b:
                pairs.add((min(a, b), max(a, b)))
        pairs = sorted(pairs)
        cls = rng.randint(0, 3, len(pairs))
        edges = sorted([(a, b, c) for (a, b), c in zip(pairs, cls)]
                       + [(b, a, c) for (a, b), c in zip(pairs, cls)])
        s, r, c = (np.array(col) for col in zip(*edges))
        samples.append(GraphSample(
            node_feats=rng.rand(n, DIM_IN).astype(np.float32),
            coords=(rng.rand(n, 3) * 8).astype(np.float32),
            senders=s.astype(np.int32), receivers=r.astype(np.int32),
            edge_attr=np.eye(3, dtype=np.float32)[c],
            y=np.float32(rng.randint(0, 2))))
    return pad_graphs_to_batch(
        samples, num_graphs=n_graphs,
        n_pad=sum(x.num_nodes for x in samples) + 7,
        e_pad=sum(x.num_edges for x in samples) + 13)


def batch_of(kind, seed=0):
    """'asym' or 'sym', checked for the hazards every case must carry."""
    batch = jax_batch(3, seed=seed) if kind == 'asym' else sym_batch(3, seed)
    n = batch.node_feats.shape[0]
    assert (batch.inv_recv_perm is not None) == (kind == 'sym')
    assert (np.asarray(batch.senders) == n).any(), 'no padding edges'
    received = np.bincount(np.asarray(batch.receivers), minlength=n + 1)[:n]
    assert ((received == 0) & (np.asarray(batch.node_mask) > 0)).any(), \
        'no real node without a receiving edge'
    return batch


def draw_params(model, batch, seed=0, **init_kwargs):
    """A parameter tree of the JAX model's shapes drawn with numpy:
    matrices U(+-1/sqrt(fan_in)), vectors U(0.2, 1) (away from any
    init); no JAX init compile."""
    shapes = jax.eval_shape(
        lambda b: model.init(jax.random.PRNGKey(0), b, **init_kwargs),
        batch)
    rng = np.random.RandomState(seed)

    def draw(leaf):
        if len(leaf.shape) >= 2:
            bound = 1 / np.sqrt(leaf.shape[-2])
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        return rng.uniform(0.2, 1.0, leaf.shape).astype(np.float32)

    return jax.tree.map(draw, shapes)


def port_from_jax(name, params, **kwargs):
    model = build_model(name, **kwargs)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model.eval()


def trajectory_batches(seed, multi=False):
    """The 4 batches of tests/test_train_trajectory.py's samples, padded
    to one shape (one JAX train-step compile for the trajectory)."""
    rng = np.random.RandomState(seed)
    sets = [_traj_samples(N_GRAPHS, rng, multi) for _ in range(N_BATCHES)]
    n_pad = max(sum(x.num_nodes for x in s) for s in sets) + 7
    e_pad = max(sum(x.num_edges for x in s) for s in sets) + 13
    return [pad_graphs_to_batch(s, num_graphs=N_GRAPHS, n_pad=n_pad,
                                e_pad=e_pad) for s in sets]


def port_trajectory(model, batches, task, steps=20, multitask=False,
                    use_fused=False):
    """Per-step losses of the port's train step, with the optimiser,
    schedule and batches of tests/test_train_trajectory.py."""
    opt = optimisers.build_optimiser(model.parameters(), 'adam', WD, LR)
    sched = optimisers.make_lr_schedule(LR, N_BATCHES,
                                        max(1, steps // N_BATCHES),
                                        warm_restarts=True)
    step = make_train_step(model, opt, task, 'mse', use_fused=use_fused,
                           multitask=multitask)
    return [step(port_batch(batches[t % N_BATCHES]), sched(t)).item()
            for t in range(steps)]


def forward_pair(name, flags, batch, scan_layers=False, seed=0,
                 **call_kwargs):
    """(JAX output, port output) of one family on the same weights."""
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=flags.pop(
        'dim_output', 1), num_layers=LAYERS, **flags)
    model = build_jax_model(name, scan_layers=scan_layers, **kwargs)
    params = draw_params(model, batch, seed)
    want = np.asarray(jax.jit(lambda p, b: model.apply(
        p, b, **call_kwargs))(params, batch))
    with torch.no_grad():
        got = port_from_jax(name, params, **kwargs)(
            port_batch(batch), **call_kwargs).numpy()
    return want, got


# ------------------------------------------------------------- lucid
CONFIGS = {
    'plain': dict(norm_feats=False, norm_coords=False),
    'fourier_attention': dict(fourier_features=2, attention=True),
    'thick_norms_graphnorm': dict(attention=True, thick_attention=True,
                                  norm_feats=True, norm_coords=True,
                                  graphnorm=True),
    'thin_final_act_whole_batch': dict(thin_mlps=True, node_final_act=True,
                                       graphnorm=True,
                                       graphnorm_whole_batch=True,
                                       tanh=False),
    'static_coords': dict(update_coords=False, attention=True,
                          fourier_features=2),
}


@pytest.mark.parametrize('kind', ['asym', 'sym'])
@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_forward_matches_jax(name, kind):
    want, got = forward_pair('lucid', dict(CONFIGS[name]),
                             batch_of(kind, seed=len(name)))
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize('name', ['fourier_attention',
                                  'thick_norms_graphnorm'])
def test_scan_layout_forward_matches_jax(name):
    want, got = forward_pair('lucid', dict(CONFIGS[name]), batch_of('asym'),
                             scan_layers=True)
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_e3_invariance():
    flags = dict(CONFIGS['fourier_attention'], norm_coords=True,
                 graphnorm=True)
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  **flags)
    params = draw_params(build_jax_model('lucid', **kwargs), ORIGINAL_GRAPH)
    model = port_from_jax('lucid', params, **kwargs)
    with torch.no_grad():
        a = model(port_batch(ORIGINAL_GRAPH)).numpy()
        b = model(port_batch(ROTATED_GRAPH)).numpy()
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=EGNN_EPS, rtol=0)


def test_destination_aggregations_match_jax():
    """sum_to_dst / mean_to_dst (K1 over receivers_sorted, plain here) and
    their gradients against the JAX aggregator's, on the asymmetric batch
    with some real edges masked."""
    batch = batch_of('asym', seed=3)
    n = batch.node_feats.shape[0]
    mask = np.asarray(batch.edge_mask).copy()
    mask[::5] = 0.0
    rng = np.random.RandomState(4)
    data = rng.randn(len(mask), 5).astype(np.float32)
    weights = rng.randn(n, 5).astype(np.float32)
    pb = port_batch(batch)
    port = EdgeAggregator(pb.senders, pb.receivers, torch.from_numpy(mask),
                          n, recv_perm=pb.recv_perm)
    ref = JaxAggregator(jnp.asarray(batch.senders),
                        jnp.asarray(batch.receivers),
                        jnp.asarray(batch.recv_perm), jnp.asarray(mask), n)
    for op in ('sum_to_dst', 'mean_to_dst'):
        leaf = torch.from_numpy(data).requires_grad_(True)
        got = getattr(port, op)(leaf)
        (got * torch.from_numpy(weights)).sum().backward()
        want_out = np.asarray(getattr(ref, op)(jnp.asarray(data)))
        grad = jax.grad(lambda d: jnp.sum(getattr(ref, op)(d) * weights))(
            jnp.asarray(data))
        np.testing.assert_allclose(got.detach().numpy(), want_out,
                                   **FWD_TOL, err_msg=op)
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(grad),
                                   **FWD_TOL, err_msg=op)
    np.testing.assert_array_equal(
        port.dst_offsets.numpy(),
        np.searchsorted(np.sort(np.asarray(batch.receivers)),
                        np.arange(n + 1)))


def test_trajectory_matches_jax():
    batches = trajectory_batches(21)
    flags = dict(attention=True, fourier_features=2, graphnorm=True)
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  **flags)
    model = build_jax_model('lucid', scan_layers=False, **kwargs)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batches[0])
    want, _ = _jax_trajectory(model, params, batches, 'classification')
    port = port_from_jax('lucid', params, **kwargs)
    got = port_trajectory(port, batches, 'classification')
    assert got[-N_BATCHES] < got[0]   # it trained
    np.testing.assert_allclose(got, want, **TRAJ_TOL)


@pytest.mark.parametrize('thick', [False, True], ids=['thin', 'thick'])
def test_reference_state_dict_loads(thick):
    """JAX weights put into torch_ref's RefLucidEGNN by
    ``load_flax_lucid_params`` and saved in the reference schema load
    strictly into the port: the same tensors ``state_dict_from_flax``
    gives, and the reference's forward (its GraphNorm takes whole-batch
    statistics)."""
    samples = _random_samples(3, seed=17)
    batch = pad_graphs_to_batch(
        samples, num_graphs=3, n_pad=sum(s.num_nodes for s in samples) + 5,
        e_pad=sum(s.num_edges for s in samples) + 9)
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  attention=True, thick_attention=thick, norm_feats=True,
                  norm_coords=True, thin_mlps=not thick, graphnorm=True,
                  graphnorm_whole_batch=True, node_final_act=thick)
    params = draw_params(build_jax_model('lucid', **kwargs), batch, seed=5)
    net = load_flax_lucid_params(RefLucidEGNN(
        DIM_IN, K, 1, LAYERS, soft_edge=True, thick_attention=thick,
        norm_feats=True, norm_coors=True, tanh=True, thin_mlps=not thick,
        graphnorm=True, node_final_act=thick), params).eval()
    port = build_model('lucid', **kwargs).eval()
    port.load_state_dict(ref_state_dict_lucid(net), strict=True)
    for key, value in state_dict_from_flax(params).items():
        assert torch.equal(port.state_dict()[key], value), key
    feats, coords, rows, cols, eattr, gid, _ = samples_to_torch_batch(
        samples)
    with torch.no_grad():
        want = net(feats, coords, rows, cols, eattr, gid, 3).numpy()
        got = port(port_batch(batch)).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize('scan_layers', [False, True],
                         ids=['unrolled', 'scan'])
def test_state_dict_round_trip(scan_layers):
    """port state_dict -> the JAX package's importer -> the original JAX
    tree, leaf for leaf; load_state_dict(state_dict()) is the identity."""
    flags = dict(CONFIGS['thick_norms_graphnorm'])
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  **flags)
    batch = batch_of('asym')
    params = draw_params(build_jax_model('lucid', scan_layers=scan_layers,
                                         **kwargs), batch)
    sd = port_from_jax('lucid', params, **kwargs).state_dict()
    back = torch_to_flax_params(sd, params, 'lucid')
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf))
    again = build_model('lucid', **kwargs)
    again.load_state_dict(sd, strict=True)
    for key, value in again.state_dict().items():
        assert torch.equal(value, sd[key]), key


def test_padding_gradients_are_finite():
    """CoorsNorm clamps inside its sqrt: padding edges (rel_coors == 0)
    give finite gradients everywhere."""
    flags = dict(CONFIGS['thick_norms_graphnorm'])
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  **flags)
    batch = batch_of('sym', seed=2)
    params = draw_params(build_jax_model('lucid', **kwargs), batch)
    model = port_from_jax('lucid', params, **kwargs).train()
    pb = port_batch(batch)
    coords = pb.coords.clone().requires_grad_(True)
    model(pb._replace(coords=coords)).sum().backward()
    assert torch.isfinite(coords.grad).all()
    for name, p in model.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), name


def compact_reference_lucid():
    """The reference's lucid layer (and its scan body) with ``__call__``
    made compact: the least repair under which flax accepts the layer's
    inline node-MLP ``nn.Dropout`` (``pointvs_tpu/models/lucid.py:187``),
    which the reference's own layer refuses whenever dropout > 0. The
    body is the reference's code object, unchanged."""
    import types

    import flax.linen as fnn
    from pointvs_tpu.models import lucid as jax_lucid
    fn = jax_lucid.LucidEGNNLayer.__call__
    fn = getattr(fn, '__wrapped__', fn)
    body = types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                              fn.__defaults__, fn.__closure__)
    body.__kwdefaults__ = fn.__kwdefaults__

    class CompactLucidLayer(jax_lucid.LucidEGNNLayer):
        __call__ = fnn.compact(body)

    class CompactLucidScanBody(CompactLucidLayer):
        def __call__(self, h, batch, agg, edge_mask, train, capture_aux):
            return CompactLucidLayer.__call__(
                self, h, batch, agg, edge_mask, train=train,
                capture_aux=capture_aux)

    return CompactLucidLayer, CompactLucidScanBody


def repair_reference_lucid(monkeypatch):
    """Build the JAX package's lucid models from the compact layer while
    the test runs (its ``LucidEGNN.setup`` reads the two names)."""
    from pointvs_tpu.models import lucid as jax_lucid
    layer, body = compact_reference_lucid()
    monkeypatch.setattr(jax_lucid, 'LucidEGNNLayer', layer)
    monkeypatch.setattr(jax_lucid, '_LucidScanBody', body)


def test_reference_lucid_refuses_dropout():
    """The fault the repair above works round: the JAX package's lucid
    cannot even be initialised with dropout > 0."""
    import flax
    model = build_jax_model('lucid', dim_input=DIM_IN, k=K, dim_output=1,
                            num_layers=LAYERS, dropout=0.1)
    with pytest.raises(flax.errors.AssignSubModuleError):
        jax.eval_shape(lambda b: model.init(jax.random.PRNGKey(0), b),
                       batch_of('asym'))


@pytest.mark.parametrize('scan_layers', [False, True],
                         ids=['layers', 'scan'])
def test_dropout_masks_follow_the_seed(scan_layers, monkeypatch):
    """A training forward with dropout 0.3 under one JAX key equals the
    repaired reference's ``apply(..., train=True, rngs={'dropout': key})``
    within the forward gate (the port draws each site's mask from the key
    flax derives for it, unscanned and under ``nn.scan``); another key
    gives another output; dropout 0 trains as the eval forward does; a
    training forward with dropout and no key is refused; the realised
    rate of one site is within 0.03 of the flag's."""
    from pointvs_tpu_torch.models.layers import Dropout
    from pointvs_tpu_torch.ops import prng
    repair_reference_lucid(monkeypatch)
    batch = batch_of('asym')
    pb = port_batch(batch)
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  attention=True, fourier_features=2, dropout=0.3)
    model = build_jax_model('lucid', scan_layers=scan_layers, **kwargs)
    params = draw_params(model, batch, seed=5)
    port = port_from_jax('lucid', params, scan_layers=scan_layers,
                         **kwargs)
    key = prng.step_key(3, 7)
    want = np.asarray(model.apply(params, batch, train=True,
                                  rngs={'dropout': jnp.asarray(key)}))
    plain = np.asarray(model.apply(params, batch))
    with torch.no_grad():
        got = port(pb, train=True, dropout_rng=key).numpy()
        other = port(pb, train=True,
                     dropout_rng=prng.step_key(3, 8)).numpy()
        assert np.abs(want - plain).max() > 1e-4   # the masks changed it
        np.testing.assert_allclose(got, want, **FWD_TOL)
        assert np.abs(other - got).max() > 1e-4
        with pytest.raises(ValueError, match='dropout_rng'):
            port(pb, train=True)
        port.dropout = 0.0
        np.testing.assert_array_equal(
            port(pb, train=True, dropout_rng=key).numpy(), port(pb).numpy())
    x = torch.ones(400, 50)
    kept = Dropout(0.3)(x, prng.prng_key(123))
    assert abs(float((kept == 0).float().mean()) - 0.3) < 0.03
    assert torch.allclose(kept[kept != 0], torch.tensor(1 / 0.7))


def test_serving_cli_matches_jax(tmp_path):
    """Both packages' serving CLIs on one lucid run directory written by
    the port (.pt in the reference schema + sidecars): the same rows, the
    scores within the three printed decimals, the port's raw scores
    within 5e-4 of its rows."""
    from pointvs_tpu.inference import main as jax_inference
    from pointvs_tpu.utils import save_yaml
    from pointvs_tpu_torch import inference
    from tests.setup_and_params import RESOURCES
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  **CONFIGS['thick_norms_graphnorm'])
    params = draw_params(build_jax_model('lucid', **kwargs), ORIGINAL_GRAPH,
                         seed=11)
    run = tmp_path / 'run'
    (run / 'checkpoints').mkdir(parents=True)
    torch.save({'model_state_dict':
                port_from_jax('lucid', params, **kwargs).state_dict(),
                'p_epoch': 2, 'a_epoch': 0},
               run / 'checkpoints' / 'pose_ckpt_epoch_2.pt')
    save_yaml(dict(kwargs, model_task='classification', scan_layers=False),
              run / 'model_kwargs.yaml')
    save_yaml({'model': 'lucid', 'batch_size': 2, 'radius': 4,
               'edge_radius': 4, 'estimate_bonds': True, 'compact': True},
              run / 'cmd_args.yaml')
    args = [str(run), str(RESOURCES / 'test.types'), str(RESOURCES),
            '--num_devices', '1']
    jax_inference(args + ['--output_fname', 'jax.txt'])
    trainer = inference.main(args + ['--output_fname', 'port.txt',
                                     '--device', 'cpu'])
    want = [r.split() for r in (run / 'pose_jax.txt').read_text()
            .splitlines()]
    got = [r.split() for r in (run / 'pose_port.txt').read_text()
           .splitlines()]
    assert len(got) == len(want) == 2 and trainer.p_epoch == 2
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[3:] == w[3:]
        assert abs(float(g[2]) - float(w[2])) <= 2e-3
    np.testing.assert_allclose(trainer.val_scores,
                               [float(r[2]) for r in got], atol=5e-4)
