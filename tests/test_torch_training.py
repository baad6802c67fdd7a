"""The port's training slice against the JAX package.

Losses against ``loss_fn`` (3 tasks x mse/huber, 1e-6); optimiser updates,
moments and schedules against optax over 20 steps on seeded gradients
(1e-6 on parameters); a 12-step module-path loss trajectory against JAX
``make_train_step`` on one CPU device (the gate of
tests/test_train_trajectory.py: atol 1e-4, rtol 1e-5), and the fused path's
trajectory against the module path's at the same gate; the segment
kernels' custom gradients (plain route) against the plain functions' own
autograd (1e-5); a ``.pt`` checkpoint round trip, with a JAX forward on the
imported weights within 1e-5 of the port's. The packed wire form
(``data/wire.py``) of a real batch in v1, v2 and v3: the packed train,
eval and scan steps equal the raw batch's exactly, the packed eval step
is within 1e-5 of the JAX package's packed eval step, and the Trainer
packs collated batches only.
"""
from collections import namedtuple

import jax
import numpy as np
import optax
import pytest
import torch

from pointvs_tpu.data.buckets import pad_graphs_to_batch
from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu.models.torch_import import load_torch_checkpoint, \
    torch_to_flax_params
from pointvs_tpu.training import losses as jax_losses
from pointvs_tpu.training import optimisers as jax_optimisers
from pointvs_tpu_torch.data.buckets import GraphBatch as HostBatch
from pointvs_tpu_torch.models.params import state_dict_from_flax
from pointvs_tpu_torch.models.registry import build_model
from pointvs_tpu_torch.ops import segment_kernels as sk
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from pointvs_tpu_torch.ops.graphnorm import GraphNorm
from pointvs_tpu_torch.ops.segment import masked_graph_mean_pool
from pointvs_tpu_torch.ops.sorted_segment import gather_by_sorted_ids, \
    windowed_segment_sum
from pointvs_tpu_torch.parallel.steps import make_eval_step, \
    make_train_step
from pointvs_tpu_torch.training import optimisers
from pointvs_tpu_torch.training.engine import Trainer
from pointvs_tpu_torch.training.losses import loss_fn
from tests.test_torch_cuda_kernels import make_case
from tests.test_torch_egnn import port_batch
from tests.test_train_trajectory import (DIM_IN, K, LAYERS, LR, N_BATCHES,
                                         N_GRAPHS, WD, _jax_trajectory,
                                         _random_samples)

Batch = namedtuple('Batch', 'y graph_mask')
FLAGS = dict(residual=True, normalize=True, tanh=True, graphnorm=True,
             graphnorm_whole_batch=True, edge_attention=True,
             softmax_attention=True)


@pytest.mark.parametrize('kind', ['mse', 'huber'])
@pytest.mark.parametrize('task', ['classification', 'regression',
                                  'multi_regression'])
def test_losses_match_jax(task, kind):
    rng = np.random.RandomState(3)
    b = 6
    width = 3 if task == 'multi_regression' else 1
    logits = (rng.randn(b, width) * 2).astype(np.float32)
    if task == 'classification':
        y = rng.randint(0, 2, b).astype(np.float32)
    else:
        y = (rng.rand(b, width) * 4).astype(np.float32).reshape(
            (b, width) if width > 1 else (b,))
        if width > 1:
            y[rng.rand(b, width) < 0.3] = -1.0
    mask = np.array([1, 1, 1, 1, 0, 1], np.float32)
    want = jax_losses.loss_fn(logits, Batch(y, mask), task, kind)
    got = loss_fn(torch.from_numpy(logits),
                  Batch(torch.from_numpy(y), torch.from_numpy(mask)), task,
                  kind)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6, atol=1e-6)


def _moments(state, name):
    """(first, second) moment trees of an optax chain state."""
    for sub in state:
        if name == 'adam' and isinstance(sub, optax.ScaleByAdamState):
            return sub.mu, sub.nu
        if name == 'sgd' and isinstance(sub, optax.TraceState):
            return sub.trace, None
    raise AssertionError(f'no {name} state in {state}')


@pytest.mark.parametrize('name', ['adam', 'sgd'])
def test_optimiser_matches_optax(name):
    """Clip by value 1.0, coupled weight decay, then Adam / Nesterov SGD:
    20 steps on seeded gradients (some beyond the clip) with the lr from a
    warm-restart schedule; parameters and the optimiser moments agree."""
    rng = np.random.RandomState(5)
    shapes = {'a': (4, 3), 'b': (5,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = jax_optimisers.build_optimiser(name, 1e-2)
    jp = {k: jax.numpy.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt = optimisers.build_optimiser(list(tp.values()), name, 1e-2, 1e-2)
    sched = optimisers.make_lr_schedule(1e-2, steps_per_epoch=7, epochs=3,
                                        warm_restarts=True)
    for t in range(20):
        grads = {k: (rng.randn(*s) * 1.5).astype(np.float32)
                 for k, s in shapes.items()}
        updates, state = tx.update({k: jax.numpy.asarray(g)
                                    for k, g in grads.items()}, state, jp)
        jp = {k: jp[k] - sched(t) * updates[k] for k in jp}
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        optimisers.clip_and_step(opt, sched(t))
    first, second = _moments(state, name)
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6)
        st = opt.state[p]
        np.testing.assert_allclose(
            st['exp_avg' if name == 'adam' else 'momentum_buffer'].numpy(),
            np.asarray(first[k]), atol=1e-6, rtol=1e-6)
        if second is not None:
            np.testing.assert_allclose(st['exp_avg_sq'].numpy(),
                                       np.asarray(second[k]), atol=1e-7,
                                       rtol=1e-5)


@pytest.mark.parametrize('kind', ['1cycle', 'warm_restarts', 'constant'])
def test_schedules_match_jax(kind):
    kw = dict(use_1cycle=kind == '1cycle',
              warm_restarts=kind == 'warm_restarts')
    want = jax_optimisers.make_lr_schedule(3e-3, 11, 4, **kw)
    got = optimisers.make_lr_schedule(3e-3, 11, 4, **kw)
    assert [got(t) for t in range(50)] == [want(t) for t in range(50)]


def _trajectory_batches(seed):
    rng = np.random.RandomState(seed)
    sample_sets = [_random_samples(N_GRAPHS, rng) for _ in range(N_BATCHES)]
    return [pad_graphs_to_batch(s, num_graphs=N_GRAPHS,
                                n_pad=sum(x.num_nodes for x in s) + 7,
                                e_pad=sum(x.num_edges for x in s) + 13)
            for s in sample_sets]


def _port_trajectory(model, batches, steps, use_fused=False):
    opt = optimisers.build_optimiser(model.parameters(), 'adam', WD, LR)
    sched = optimisers.make_lr_schedule(LR, N_BATCHES,
                                        max(1, steps // N_BATCHES),
                                        warm_restarts=True)
    step = make_train_step(model, opt, 'classification', 'mse',
                           use_fused=use_fused)
    return [step(port_batch(batches[t % N_BATCHES]), sched(t)).item()
            for t in range(steps)]


def _port_from_jax(params, **flags):
    model = build_model('egnn', dim_input=DIM_IN, k=K, dim_output=1,
                        num_layers=LAYERS, **flags)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def test_module_trajectory_matches_jax():
    steps = 12
    batches = _trajectory_batches(11)
    model = build_jax_model('egnn', dim_input=DIM_IN, k=K, dim_output=1,
                            num_layers=LAYERS, scan_layers=False, **FLAGS)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batches[0])
    want, _ = _jax_trajectory(model, params, batches, 'classification',
                              steps=steps)
    got = _port_trajectory(_port_from_jax(params, **FLAGS), batches, steps)
    assert got[-N_BATCHES] < got[0]     # it trained
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_fused_trajectory_matches_module():
    """The fused training path (plain K3/K4 here) against the module path,
    from the same weights, over 10 steps. With per-graph GraphNorm
    statistics: under ``graphnorm_whole_batch`` the fused path takes
    per-graph ones, as the JAX package's does, and the two paths differ
    by design (``tests/test_torch_fused_engine.py`` holds each against
    JAX's)."""
    flags = dict(FLAGS, graphnorm_whole_batch=False)
    batches = _trajectory_batches(12)
    jax_model = build_jax_model('egnn', dim_input=DIM_IN, k=K, dim_output=1,
                                num_layers=LAYERS, **flags)
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(1), batches[0])
    module = _port_trajectory(_port_from_jax(params, **flags), batches, 10)
    fused = _port_trajectory(_port_from_jax(params, **flags), batches, 10,
                             use_fused=True)
    np.testing.assert_allclose(fused, module, atol=1e-4, rtol=1e-5)


def test_eval_step_gate():
    six = build_model('egnn', dim_input=DIM_IN, k=K, dim_output=1,
                      num_layers=6, **FLAGS)
    assert make_eval_step(six, 'classification', use_fused=True).fused
    assert not make_eval_step(six, 'classification').fused
    three = build_model('egnn', dim_input=DIM_IN, k=K, dim_output=1,
                        num_layers=3, **FLAGS)
    assert not make_eval_step(three, 'classification', use_fused=True).fused
    batch = port_batch(_trajectory_batches(13)[0])
    step = make_eval_step(six, 'classification', use_fused=True)
    with torch.no_grad():   # a CPU batch takes the module forward
        torch.testing.assert_close(step(batch), six(batch), atol=0, rtol=0)


# --------------------------------------------------------------------- #
def _leaf(a):
    return torch.from_numpy(a).double().requires_grad_(True)


@pytest.mark.parametrize('case', ['plain', 'empty_rows', 'tied_max',
                                  'all_masked_rows'])
def test_segment_gradients_match_plain_autograd(case):
    """The custom backward of every aggregation (K1 for gathers' and sums'
    transposes, the reference's _fsp_bwd / _fsg_bwd for K2) against
    autograd through the plain versions, in float64."""
    ids, feat, logits, trans, mask, n = make_case(case)
    rng = np.random.RandomState(9)
    node = rng.randn(n, 5)
    recv = rng.permutation(ids).astype(np.int32)
    ids_t, recv_t = torch.from_numpy(ids), torch.from_numpy(recv)
    m = torch.from_numpy(mask).double()
    k = feat.shape[1]

    def custom(f, lg, tr, nd):
        agg = EdgeAggregator(ids_t, recv_t, m, num_nodes=n)
        return [windowed_segment_sum(f, ids_t, n),
                gather_by_sorted_ids(nd, ids_t, n), agg.gather_dst(nd),
                *agg.fused_softmax_aggregate(f, lg, tr, mask=m),
                *agg.fused_sigmoid_aggregate(f, lg, tr, mask=m)]

    def plain(f, lg, tr, nd):
        pad = torch.cat([nd, nd.new_zeros((1, nd.shape[1]))])
        outs = [sk.windowed_segment_sum_plain(f, ids_t, n),
                pad[ids_t.long()], pad[recv_t.long()]]
        for mode in ('softmax', 'sigmoid'):
            out, _ = sk.fused_softmax_aggregate_plain(f, lg, tr, m, ids_t, n,
                                                      mode)
            feats = out[:, :k]
            if mode == 'softmax':
                feats = feats / torch.clamp_min(out[:, k + 4], 1e-16)[:, None]
            outs += [feats,
                     out[:, k:k + 3] / torch.clamp_min(out[:, k + 5:], 1.0)]
        return outs

    weights = [torch.from_numpy(rng.randn(*o.shape))
               for o in custom(*[_leaf(a) for a in (feat, logits, trans,
                                                    node)])]
    grads = []
    for fn in (custom, plain):
        leaves = [_leaf(a) for a in (feat, logits, trans, node)]
        sum((o * w).sum() for o, w in zip(fn(*leaves), weights)).backward()
        grads.append([x.grad for x in leaves])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_gather_pair_gradient_matches_indexing():
    """gather_pair (one gather, backward through inv_recv_perm and K1) on a
    symmetric edge list against plain indexing."""
    n = 4
    rng = np.random.RandomState(2)
    hc = torch.from_numpy(rng.randn(n, 4)).requires_grad_(True)
    senders = torch.tensor([0, 0, 1, 2, n, n], dtype=torch.int32)
    receivers = torch.tensor([1, 2, 0, 0, n, n], dtype=torch.int32)
    recv_perm = torch.argsort(receivers, stable=True)
    assert torch.equal(receivers[recv_perm], senders)
    inv = torch.empty_like(recv_perm)
    inv[recv_perm] = torch.arange(len(recv_perm))
    agg = EdgeAggregator(senders, receivers, None, num_nodes=n,
                         recv_perm=recv_perm, inv_recv_perm=inv)
    w = torch.from_numpy(rng.randn(6, 4))
    a, b = agg.gather_pair(hc)
    ((a * w).sum() + (b * w.flip(0)).sum()).backward()
    got = hc.grad.clone()
    hc.grad = None
    pad = torch.cat([hc, hc.new_zeros((1, 4))])
    ((pad[senders.long()] * w).sum()
     + (pad[receivers.long()] * w.flip(0)).sum()).backward()
    torch.testing.assert_close(got, hc.grad)


@pytest.mark.parametrize('whole_batch', [False, True])
def test_graphnorm_and_pool_differentiate(whole_batch):
    rng = np.random.RandomState(4)
    n, g, f = 12, 3, 4
    graph_id = torch.tensor([0, 0, 0, 1, 1, 2, 2, 2, 2, 3, 3, 3])
    node_mask = (graph_id < g).double()
    norm = GraphNorm(f, whole_batch=whole_batch).double()
    with torch.no_grad():
        for p in norm.parameters():
            p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, f)))
    x = torch.from_numpy(rng.randn(n, f)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda v: masked_graph_mean_pool(norm(v, graph_id, g, node_mask),
                                         graph_id, g, node_mask), (x,))


# --------------------------------------------------------------------- #
class _Loader(list):
    """A list of (batch, meta) with len(): what train_model needs."""


def _host(batch):
    """The JAX package's host GraphBatch as the port's (numpy arrays)."""
    return HostBatch(**{f: getattr(batch, f) for f in HostBatch._fields})


def test_trainer_checkpoint_round_trip(tmp_path):
    batches = _trajectory_batches(15)
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  model_task='classification', **FLAGS)
    trainer = Trainer('egnn', tmp_path, torch.device('cpu'),
                      learning_rate=LR, weight_decay=WD, warm_restarts=True,
                      log_interval=2, **kwargs)
    loader = _Loader((_host(b), None) for b in batches)
    trainer.train_model(loader, epochs=2)
    assert len(trainer.train_losses) == 2 * N_BATCHES
    assert np.isfinite(trainer.train_losses).all()
    assert 0 < trainer.active_mean_pred < 1
    ckpt = tmp_path / 'checkpoints' / 'pose_ckpt_epoch_2.pt'
    assert ckpt.exists()
    assert (tmp_path / 'checkpoints' / 'pose_ckpt_epoch_1.pt').exists()

    batch = batches[0]
    with torch.no_grad():
        want = trainer.model(port_batch(batch)).numpy()
    again = Trainer('egnn', tmp_path / 'again', torch.device('cpu'),
                    seed=9, **kwargs)
    again.load_weights(ckpt)
    assert again.p_epoch == 2
    assert again.optimiser.state_dict()['state']   # Adam moments restored
    with torch.no_grad():
        np.testing.assert_array_equal(again.model(port_batch(batch)).numpy(),
                                      want)

    jax_model = build_jax_model('egnn', scan_layers=False, **kwargs)
    template = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), batch)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), template)
    state_dict, meta = load_torch_checkpoint(ckpt)
    assert meta['p_epoch'] == 2
    params = torch_to_flax_params(state_dict, template, 'egnn')
    got = np.asarray(jax.jit(jax_model.apply)(params, batch))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_trainer_nan_guard(tmp_path):
    batch = _trajectory_batches(16)[0]
    bad = batch._replace(node_feats=np.full_like(batch.node_feats, np.nan))
    trainer = Trainer('egnn', tmp_path, torch.device('cpu'), dim_input=DIM_IN,
                      k=K, dim_output=1, num_layers=2, **FLAGS)
    with pytest.raises(FloatingPointError):
        trainer.train_model(_Loader([(_host(bad), None)]), epochs=1)


# --------------------------------------------------------------------- #
# The packed batch form (data/wire.py) in the steps: on the same batch the
# packed train, eval and scan steps give the raw batch's outputs exactly,
# in each wire format; the packed eval step matches the JAX package's
# packed eval step within 1e-5.
WIRE_FORMATS = {'v1': dict(prefer_v2=False, v3='0'),
                'v2': dict(prefer_v2=True, v3='1'),
                'v3': dict(prefer_v2=False, v3='1')}


def _real_batch():
    from tests.setup_and_params import ORIGINAL_GRAPH_TWO_ITEMS
    return _host(ORIGINAL_GRAPH_TWO_ITEMS)


def _packed(batch, fmt, monkeypatch):
    from pointvs_tpu_torch.data import wire
    opts = WIRE_FORMATS[fmt]
    monkeypatch.setenv('POINTVS_WIRE_V3', opts['v3'])
    packed = wire.compress(batch, prefer_v2=opts['prefer_v2'])
    assert type(packed).__name__ == {'v1': 'WireBatch', 'v2': 'WireBatchV2',
                                     'v3': 'WireBatchV3'}[fmt]
    return ('packed', wire.upload(wire.pack(packed), torch.device('cpu')),
            wire.template(packed), batch.inv_recv_perm is not None)


def _wire_model(seed=0):
    from pointvs_tpu_torch.models.layers import init_parameters
    model = build_model('egnn', dim_input=DIM_IN, k=K, dim_output=1,
                        num_layers=LAYERS, **FLAGS)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model


@pytest.mark.parametrize('fmt', sorted(WIRE_FORMATS))
def test_packed_train_step_equals_raw(fmt, monkeypatch):
    batch = _real_batch()
    packed = _packed(batch, fmt, monkeypatch)
    outs, weights = [], []
    for form in ('raw', 'packed'):
        model = _wire_model()
        opt = optimisers.build_optimiser(model.parameters(), 'adam', WD, LR)
        step = make_train_step(model, opt, 'classification',
                               with_metrics=True)
        outs.append([step(port_batch(batch) if form == 'raw' else packed, LR)
                     for _ in range(3)])
        weights.append([p.detach().clone() for p in model.parameters()])
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)
    for got, want in zip(weights[1], weights[0]):
        assert torch.equal(got, want)


@pytest.mark.parametrize('fmt', sorted(WIRE_FORMATS))
def test_packed_eval_and_scan_steps_equal_raw(fmt, monkeypatch):
    from pointvs_tpu_torch.data import wire
    from pointvs_tpu_torch.parallel.steps import make_scan_eval_step
    batch = _real_batch()
    shifted = batch._replace(coords=batch.coords + np.float32(0.25))
    model = _wire_model(1)
    eval_step = make_eval_step(model, 'classification')
    raw = [eval_step(port_batch(b)) for b in (batch, shifted, batch)]
    packed = [_packed(b, fmt, monkeypatch) for b in (batch, shifted, batch)]
    for got, want in zip([eval_step(p) for p in packed], raw):
        assert torch.equal(got, want)
    group = wire.upload([wire.ready(p[1]).numpy() for p in packed],
                        torch.device('cpu'))
    scanned = make_scan_eval_step(model, 'classification')(
        group, packed[0][2], packed[0][3])
    assert scanned.shape == (3,) + raw[0].shape
    assert torch.equal(scanned, torch.stack(raw))


def test_packed_eval_matches_jax_packed_eval():
    from pointvs_tpu.data import wire as ref_wire
    from pointvs_tpu.data.buckets import stack_device_batches
    from pointvs_tpu.parallel.mesh import get_mesh, replicate, shard_batch
    from pointvs_tpu.parallel.steps import make_eval_step as jax_eval_step
    from pointvs_tpu_torch.data import wire
    from tests.setup_and_params import ORIGINAL_GRAPH_TWO_ITEMS
    from tests.test_torch_egnn import jax_model_and_params, port_model
    batch = ORIGINAL_GRAPH_TWO_ITEMS
    jax_model, params = jax_model_and_params(FLAGS, batch, False, seed=3)
    mesh = get_mesh(1)
    stacked = stack_device_batches([batch])
    ref = ref_wire.compress(stacked)
    want = np.asarray(jax_eval_step(jax_model, 'classification', mesh)(
        replicate(params, mesh),
        ('packed', shard_batch(ref_wire.pack_stacked(ref), mesh),
         ref_wire.stacked_template(ref), True))).reshape(-1, 1)
    host = _host(batch)
    packed = wire.pack_batch(host, torch.device('cpu'))
    assert type(packed[2]).__name__ == type(ref).__name__ == 'WireBatchV3'
    got = make_eval_step(port_model(FLAGS, params), 'classification')(
        packed).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_trainer_packs_collated_batches_only(tmp_path):
    """The Trainer ships a collated batch packed; a batch the wire form
    cannot carry exactly (random float features) moves array by array."""
    from pointvs_tpu_torch.data.wire import Staged
    trainer = Trainer('egnn', tmp_path, torch.device('cpu'), silent=True,
                      dim_input=DIM_IN, k=K, dim_output=1, num_layers=2,
                      **FLAGS)
    packed = trainer._to_device(_real_batch())
    assert packed[0] == 'packed' and isinstance(packed[1], Staged)
    assert trainer._to_device(packed) is packed
    raw = trainer._to_device(_host(_trajectory_batches(17)[0]))
    assert isinstance(raw, HostBatch) and torch.is_tensor(raw.node_feats)
    assert trainer._to_device(raw) is raw
