"""The port's ``--bf16`` (mixed precision) against the JAX package's.

Same inputs and weights as tests/test_torch_egnn.py and
tests/test_torch_multitask.py (k=16, 3 layers; numpy draws in the JAX
model's shapes, carried over by ``state_dict_from_flax``).

What "the reference" computes under bf16 depends on how it runs: eagerly
(each op rounded to its dtype) or under ``jax.jit``, where XLA may keep
excess precision across fused bf16 ops. The port rounds each op as its
dtype says, so it computes the eager function; its logits came out
identical to JAX's eager ones on every configuration here. Gates, as
fractions of the largest |logit| (the JAX suite's own bf16-against-f32
gate is 5e-2, tests/test_bf16.py):

- forward against JAX eager: ``EAGER_GATE`` 1e-4 (measured at most
  2.0e-6: the EGNN's logits identical, the multitask's within f32
  rounding of the head);
- forward against JAX jit: no further from it than JAX's own eager
  forward is, plus ``EAGER_GATE``. That spread is the reference's own:
  measured up to 5e-2 of the largest |logit| on the multitask pose head
  (logits ~0.06), 5e-4 on the EGNN;
- parameter gradients against JAX jit, all parameters as one vector:
  the L2 difference over the L2 norm, and the largest difference over
  the largest |gradient|, each within ``GRAD_GATE`` 2e-2 (measured
  6.8e-3 and 3.3e-3; JAX's own eager and jit gradients differ by 6.6e-3
  in L2);
- a 10-step loss trajectory on one batch: finite, decreasing, each loss
  within ``TRAJ_GATE`` 5e-3 relative of JAX jit's (measured 8.0e-4);
- the training CLI against JAX's from one ``.pt`` (20 steps): the
  logged losses within ``TRAJ_GATE`` (measured 2.6e-4); the final
  parameters, as one vector, no further from JAX's than ``PARAM_GATE``
  5e-2 of the distance JAX's moved from the start (L2; measured 8.5e-3:
  Adam's normalised steps carry rounding where a gradient is near zero);
  the predictions within ``SCORE_GATE`` 5e-3.

Also: parameters and checkpoints stay f32 and logits come out f32; the
f32 ``[h | coord]`` gather's backward equals JAX's packed mixed gather
(``_gather_hc_mixed`` / ``_gather_hc_pair_mixed``) within one bf16 ulp;
``supports_fusion`` rejects a bf16 model, so the fused eval step gives
the module path's numbers; the families without a ``bf16`` field (lucid,
siamese, dense) compute the same with the flag as without it in both
packages.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from pointvs_tpu.models.registry import \
    filter_model_kwargs as jax_filter_kwargs
from pointvs_tpu.ops.aggregate import EdgeAggregator as JaxAggregator
from pointvs_tpu.training.losses import loss_fn as jax_loss_fn
from pointvs_tpu_torch import inference
from pointvs_tpu_torch.inference_engine import supports_fusion
from pointvs_tpu_torch.main import main as port_main
from pointvs_tpu_torch.models.params import load_reference_checkpoint, \
    state_dict_from_flax
from pointvs_tpu_torch.models.registry import MODEL_REGISTRY, \
    build_model, filter_model_kwargs
from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
from pointvs_tpu_torch.parallel.steps import make_eval_step, \
    make_train_step
from pointvs_tpu_torch.resume_training import main as resume_main
from pointvs_tpu_torch.training import optimisers
from pointvs_tpu_torch.training.engine import Trainer
from pointvs_tpu_torch.training.losses import loss_fn
from tests.setup_and_params import ORIGINAL_GRAPH, RESOURCES
from tests.test_torch_egnn import DIM_IN, K, LAYERS, jax_batch, \
    jax_model_and_params, port_batch
from tests.test_torch_lucid import batch_of, draw_params, port_from_jax
from tests.test_torch_main import CLI_MODEL, SETUP
from tests.test_torch_train_loader import write_types
from tests.test_train_trajectory import LR, WD, _jax_trajectory

EAGER_GATE = 1e-4
GRAD_GATE = 2e-2
TRAJ_GATE = 5e-3
PARAM_GATE = 5e-2
SCORE_GATE = 5e-3

BASE = dict(residual=True, normalize=True, tanh=True, graphnorm=True)
EGNN = {
    'default': BASE,
    'sigmoid': dict(BASE, edge_attention=True),
    'softmax': dict(BASE, edge_attention=True, softmax_attention=True),
    'softmax_static_coords_rezero': dict(
        BASE, edge_attention=True, softmax_attention=True,
        update_coords=False, rezero=True, edge_residual=True),
    'gated_node_attention_whole_batch': dict(
        BASE, gated_residual=True, edge_residual=True, node_attention=True,
        edge_attention=True, attention_activation_fn='relu',
        graphnorm_whole_batch=True),
}
MULTITASK = dict(BASE, edge_attention=True, softmax_attention=True,
                 final_softplus=True, dim_output=3)


def _model_kwargs(name, flags):
    flags = dict(flags)
    return dict(dim_input=DIM_IN, k=K, dim_output=flags.pop('dim_output', 1),
                num_layers=LAYERS, **flags)


def _jax_and_port(name, flags, batch, seed=0):
    """(JAX bf16 model, its parameter tree, the port's bf16 model)."""
    kwargs = dict(_model_kwargs(name, flags), bf16=True)
    model = build_jax_model(name, scan_layers=False, **kwargs)
    params = draw_params(model, batch, seed)
    return model, params, port_from_jax(name, params, **kwargs)


CASES = {f'egnn_{n}': ('egnn', f, {}) for n, f in EGNN.items()}
CASES.update({f'multitask_{t}': ('multitask', MULTITASK, {'task': t})
              for t in ('classification', 'multi_regression')})


@pytest.mark.parametrize('case', sorted(CASES))
def test_forward_matches_jax(case):
    name, flags, call = CASES[case]
    batch = jax_batch(4, seed=len(case))
    model, params, port = _jax_and_port(name, flags, batch)
    eager = np.asarray(model.apply(params, batch, **call))
    jitted = np.asarray(jax.jit(lambda p, b: model.apply(p, b, **call))(
        params, batch))
    with torch.no_grad():
        got = port(port_batch(batch), **call)
    assert got.dtype == torch.float32 and eager.dtype == np.float32
    got = got.numpy()
    scale = np.abs(eager).max()
    assert np.isfinite(got).all() and scale > 0
    assert np.abs(got - eager).max() <= EAGER_GATE * scale
    spread = np.abs(eager - jitted).max()
    print(f'{case}: max|logit| {scale:.4g}, |port - eager| '
          f'{np.abs(got - eager).max():.3g}, |eager - jit| {spread:.3g}')
    assert np.abs(got - jitted).max() <= spread + EAGER_GATE * scale


def _jax_grads(model, params, batch):
    def loss(p):
        s, w = jax_loss_fn(model.apply(p, batch), batch, 'classification',
                           'mse')
        return s / jnp.maximum(w, 1.0)
    return jax.jit(jax.grad(loss))(params)


@pytest.mark.parametrize('case', ['egnn_default', 'egnn_softmax'])
def test_gradients_match_jax(case):
    """All parameters' gradients as one vector (a per-tensor ratio would
    divide by gradients that vanish, as the softmax-shifted attention
    bias's does, where only rounding is left)."""
    name, flags, _ = CASES[case]
    batch = jax_batch(4, seed=7)
    model, params, port = _jax_and_port(name, flags, batch)
    want = state_dict_from_flax(jax.tree.map(np.asarray, _jax_grads(
        model, params, batch)))
    pb = port_batch(batch)
    s, w = loss_fn(port(pb), pb, 'classification', 'mse')
    (s / torch.clamp_min(w, 1.0)).backward()
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(want)
    grads = dict(port.named_parameters())
    assert all(grads[n].grad.dtype == torch.float32 for n in names)
    got = np.concatenate([grads[n].grad.numpy().ravel() for n in names])
    ref = np.concatenate([np.asarray(want[n]).ravel() for n in names])
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    worst = np.abs(got - ref).max() / np.abs(ref).max()
    print(f'{case}: gradient |port - jit| L2 {rel:.3g}, max {worst:.3g}')
    assert rel <= GRAD_GATE and worst <= GRAD_GATE


def test_trajectory_decreases_and_matches_jax():
    """10 Adam steps on one batch, as tests/test_bf16.py trains."""
    batch = jax_batch(4, seed=11)
    flags = EGNN['softmax']
    model, params, port = _jax_and_port('egnn', flags, batch)
    steps = 10
    want, _ = _jax_trajectory(model, params, [batch] * 4, 'classification',
                              steps=steps)
    opt = optimisers.build_optimiser(port.parameters(), 'adam', WD, LR)
    sched = optimisers.make_lr_schedule(LR, 4, max(1, steps // 4),
                                        warm_restarts=True)
    step = make_train_step(port, opt, 'classification', 'mse')
    pb = port_batch(batch)
    got = np.asarray([step(pb, sched(t)).item() for t in range(steps)])
    print(f'bf16 trajectory: max relative |port - jax| '
          f'{(np.abs(got - want) / np.abs(want)).max():.3g}')
    assert np.isfinite(got).all() and got[-1] < got[0]
    assert (np.abs(got - np.asarray(want)) <= TRAJ_GATE * np.abs(
        np.asarray(want))).all()
    assert all(p.dtype == torch.float32 for p in port.parameters())


def test_params_logits_and_checkpoint_stay_f32(tmp_path):
    kwargs = _model_kwargs('egnn', EGNN['softmax'])
    runs = {}
    for bf16 in (False, True):
        trainer = Trainer('egnn', tmp_path / str(bf16), torch.device('cpu'),
                          seed=3, bf16=bf16, **kwargs)
        batch = port_batch(jax_batch(3, seed=2))
        trainer.train_model([(batch, None)], epochs=1)
        with torch.no_grad():
            assert trainer.model(batch).dtype == torch.float32
        runs[bf16] = torch.load(trainer.save(), weights_only=True)
    for key in ('model_state_dict', 'optimiser_state_dict'):
        f32, bf16 = runs[False][key], runs[True][key]
        flat32 = jax.tree_util.tree_leaves_with_path(f32)
        flat16 = jax.tree_util.tree_leaves_with_path(bf16)
        assert [p for p, _ in flat32] == [p for p, _ in flat16]
        for (path, a), (_, b) in zip(flat32, flat16):
            if torch.is_tensor(a):
                assert a.dtype == b.dtype == a.dtype and a.shape == b.shape, \
                    path
                assert a.dtype != torch.bfloat16, path
    assert trainer.model.bf16 and not supports_fusion(trainer.model)


@pytest.mark.parametrize('side', ['src', 'dst', 'pair'])
def test_gather_backward_matches_jax_mixed_gather(side):
    """The port's f32 [h | coord] gather of bf16 h against JAX's packed
    mixed gathers (``gather_hc_src`` / ``gather_hc_dst`` /
    ``gather_hc_pair``): forward bit-exact; the backward of each (the
    cotangents summed in f32 by K1's plain version and rounded to bf16
    once, as ``_ghc_bwd`` / ``_ghp_bwd``) within one bf16 ulp of JAX's.
    One gather at a time: JAX rounds each gather's cotangent to bf16
    before adding them, the port adds them in f32 first."""
    batch = batch_of('sym' if side == 'pair' else 'asym', seed=5)
    n, e = batch.node_feats.shape[0], batch.senders.shape[0]
    rng = np.random.RandomState(1)
    h = jnp.asarray(rng.randn(n, K), jnp.bfloat16)
    coord = rng.randn(n, 3).astype(np.float32)
    w_h = rng.randn(2, e, K).astype(np.float32)
    w_c = rng.randn(2, e, 3).astype(np.float32)
    jagg = JaxAggregator(batch.senders, batch.receivers, batch.recv_perm,
                         batch.edge_mask, n,
                         inv_recv_perm=batch.inv_recv_perm)

    def jax_gather(hh, cc):
        if side == 'pair':
            return jagg.gather_hc_pair(hh, cc)
        return (jagg.gather_hc_src if side == 'src'
                else jagg.gather_hc_dst)(hh, cc)

    weights = [w_h[0], w_c[0], w_h[1], w_c[1]]
    jh, jc = jax.grad(lambda hh, cc: sum(
        (o.astype(jnp.float32) * w).sum()
        for o, w in zip(jax_gather(hh, cc), weights)), argnums=(0, 1))(
            h, coord)
    pb = port_batch(batch)
    agg = EdgeAggregator(pb.senders, pb.receivers, pb.edge_mask, n,
                         recv_perm=pb.recv_perm,
                         inv_recv_perm=pb.inv_recv_perm)
    th = torch.tensor(np.asarray(h.astype(jnp.float32))).bfloat16()
    th.requires_grad_(True)
    tc = torch.tensor(coord, requires_grad=True)
    hc = torch.cat([th.float(), tc], dim=1)
    gathered = {'pair': lambda: agg.gather_pair(hc),
                'src': lambda: (agg.gather_src(hc),),
                'dst': lambda: (agg.gather_dst(hc),)}[side]()
    outs = []
    for rows in gathered:
        outs += [rows[:, :K].bfloat16(), rows[:, K:]]
    want = jax_gather(h, coord)
    for got_part, want_part in zip(outs, want):
        np.testing.assert_array_equal(
            got_part.float().detach().numpy(),
            np.asarray(want_part.astype(jnp.float32)))
    sum((o.float() * torch.tensor(w)).sum()
        for o, w in zip(outs, weights)).backward()
    assert th.grad.dtype == torch.bfloat16
    want_h = np.asarray(jh.astype(jnp.float32))
    got_h = th.grad.float().numpy()
    assert (np.abs(got_h - want_h) <= 2.0 ** -7 * np.abs(want_h)).all()
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jc), atol=1e-5,
                               rtol=1e-5)


def test_bf16_is_not_fused(tmp_path):
    """The reference's gate (``not model.bf16``): the fused eval step of a
    6-layer bf16 model is the module path, and a fused-training Trainer
    raises at its first step, as for any model the gate rejects."""
    kwargs = dict(_model_kwargs('egnn', EGNN['softmax']), num_layers=6)
    f32 = build_model('egnn', **kwargs)
    bf16 = build_model('egnn', bf16=True, **kwargs)
    assert supports_fusion(f32) and not supports_fusion(bf16)
    step = make_eval_step(bf16, 'classification', use_fused=True)
    assert not step.fused
    batch = port_batch(jax_batch(3, seed=4))
    with torch.no_grad():
        torch.testing.assert_close(step(batch), bf16(batch), atol=0, rtol=0)
    trainer = Trainer('egnn', tmp_path, torch.device('cpu'), silent=True,
                      fused_training=True, bf16=True, **kwargs)
    with pytest.raises(ValueError, match='no fused path'):
        trainer.train_model([(batch, None)], epochs=1)


FAMILIES = {
    'lucid': dict(attention=True, graphnorm=True),
    'siamese': dict(edge_attention=True, softmax_attention=True),
    'dense_egnn': dict(),
}


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_families_without_the_field_ignore_bf16(name):
    """Neither package's lucid, siamese or dense model has a ``bf16``
    field: the flag is filtered out and the model is the f32 one."""
    assert 'bf16' not in jax_filter_kwargs(JAX_REGISTRY[name],
                                           {'bf16': True})
    assert 'bf16' not in filter_model_kwargs(MODEL_REGISTRY[name],
                                             {'bf16': True})
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=2,
                  **FAMILIES[name])
    torch.manual_seed(0)
    plain = build_model(name, **kwargs)
    flagged = build_model(name, bf16=True, **kwargs)
    flagged.load_state_dict(plain.state_dict())
    assert all(p.dtype == torch.float32 for p in flagged.parameters())
    if name == 'siamese':
        from tests.test_torch_siamese import jax_pair, port_pair
        batch = port_pair(jax_pair(seed=1))
    elif name == 'dense_egnn':
        from tests.test_torch_dense import batches, port_dense
        batch = port_dense(batches(seed=1)[1])
    else:
        batch = port_batch(jax_batch(3, seed=1))
    with torch.no_grad():
        torch.testing.assert_close(flagged(batch), plain(batch), atol=0,
                                   rtol=0)


# ------------------------------------------------------------ the CLI
def _cli_argv(save, types, extra=()):
    return (['egnn', str(save), '--train_data_root_pose', str(RESOURCES),
             '--train_types_pose', str(types), '--test_data_root_pose',
             str(RESOURCES), '--test_types_pose',
             str(RESOURCES / 'test.types'), '-b', '2', '-ep', '1', '--top1',
             '--end_flag', '--dropout', '0', '--bf16'] + CLI_MODEL + SETUP
            + list(extra))


@pytest.fixture(scope='module')
def bf16_runs(tmp_path_factory):
    """Both CLIs with --bf16 from one .pt: 20 steps at batch 2."""
    from pointvs_tpu.main import main as jax_main
    root = tmp_path_factory.mktemp('bf16_cli')
    types = write_types(root / 'train.types', n=40,
                        labels=lambda i: int(i % 3 == 0))
    flags = dict(EGNN['softmax'])
    _, params = jax_model_and_params(flags, ORIGINAL_GRAPH, False, seed=6)
    weights = root / 'init.pt'
    torch.save({'model_state_dict': state_dict_from_flax(params),
                'p_epoch': 0, 'a_epoch': 0}, weights)
    extra = ['--load_weights', str(weights)]
    jax_trainer = jax_main(_cli_argv(root / 'jax', types, extra))
    port_trainer = port_main(_cli_argv(root / 'port', types, extra)
                             + ['--device', 'cpu'])
    return root, jax_trainer, port_trainer


def _rows(path):
    return [line.split() for line in path.read_text().splitlines()]


def test_cli_matches_jax(bf16_runs):
    root, jax_trainer, port_trainer = bf16_runs
    assert port_trainer.model.bf16 and jax_trainer.model.bf16
    losses = np.asarray(port_trainer.train_losses)
    assert len(losses) == 20 and np.isfinite(losses).all()
    logged = {r['Batch (train, pose)']: r['Loss (train, pose)']
              for r in map(json.loads, (root / 'jax' / 'metrics.jsonl')
                           .read_text().splitlines())
              if 'Loss (train, pose)' in r}
    assert sorted(logged) == [1, 11]
    for batch, loss in logged.items():
        assert abs(losses[batch - 1] - loss) <= TRAJ_GATE * abs(loss)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jax_trainer.params))
    got, _ = load_reference_checkpoint(
        root / 'port' / 'checkpoints' / 'pose_ckpt_epoch_1.pt')
    init, _ = load_reference_checkpoint(root / 'init.pt')
    assert sorted(got) == sorted(want) == sorted(init)
    assert all(got[key].dtype == torch.float32 for key in got)
    keys = sorted(want)

    def flat(sd):
        return np.concatenate([np.asarray(sd[k]).ravel() for k in keys])
    moved = np.linalg.norm(flat(want) - flat(init))
    rel = np.linalg.norm(flat(got) - flat(want)) / moved
    print(f'bf16 CLI: |port - jax| / |jax - init| parameters (L2) {rel:.3g};'
          f' losses {losses[[0, 10]]} vs {logged}')
    assert rel <= PARAM_GATE
    want_rows = _rows(root / 'jax' / 'pose_predictions.txt')
    got_rows = _rows(root / 'port' / 'pose_predictions.txt')
    assert len(got_rows) == len(want_rows) == 2
    for g, w in zip(got_rows, want_rows):
        assert g[:2] == w[:2] and g[3:] == w[3:]
        assert abs(float(g[2]) - float(w[2])) <= SCORE_GATE


def test_serving_cli_scores_a_bf16_run(bf16_runs):
    """The serving CLI gives the run's own validation scores, and JAX's
    serving CLI on the same weights within the score gate."""
    from pointvs_tpu import inference as jax_inference
    root, _, port_trainer = bf16_runs
    run = root / 'port'
    served = inference.main([str(run), str(RESOURCES / 'test.types'),
                             str(RESOURCES), '--device', 'cpu',
                             '--output_fname', 'served.txt'])
    assert served.model.bf16
    np.testing.assert_array_equal(served.val_scores, port_trainer.val_scores)
    # The JAX package serves the port's .pt through its importer.
    jax_run = root / 'jax_served'
    jax_run.mkdir()
    for name in ('cmd_args.yaml', 'model_kwargs.yaml'):
        (jax_run / name).write_text((run / name).read_text())
    (jax_run / 'checkpoints').mkdir()
    (jax_run / 'checkpoints' / 'pose_ckpt_epoch_1.pt').write_bytes(
        (run / 'checkpoints' / 'pose_ckpt_epoch_1.pt').read_bytes())
    jax_inference.main([str(jax_run), str(RESOURCES / 'test.types'),
                        str(RESOURCES), '--output_fname', 'served.txt',
                        '--num_devices', '1'])
    want = np.asarray([float(r[2]) for r in
                       _rows(jax_run / 'pose_served.txt')])
    assert np.abs(np.round(served.val_scores, 3) - want).max() \
        <= SCORE_GATE


def test_resume_continues_a_bf16_run(bf16_runs, tmp_path):
    import shutil
    import yaml
    run = tmp_path / 'run'
    shutil.copytree(bf16_runs[0] / 'port', run)
    args = yaml.safe_load((run / 'cmd_args.yaml').read_text())
    args['epochs_pose'] = 2
    (run / 'cmd_args.yaml').write_text(yaml.dump(args))
    trainer = resume_main([str(run), '--device', 'cpu'])
    assert trainer.p_epoch == 2 and trainer.model.bf16
    assert len(trainer.train_losses) == 20
    assert np.isfinite(trainer.train_losses).all()
    ckpt = torch.load(run / 'checkpoints' / 'pose_ckpt_epoch_2.pt',
                      weights_only=True)
    assert all(v.dtype == torch.float32
               for v in ckpt['model_state_dict'].values())
