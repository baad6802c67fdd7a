"""The port's multitask family against the JAX package's.

Same batches and weights as tests/test_torch_lucid.py. Gates: the module
forward within 1e-5 of JAX's for both heads under each attention switch
(none, first-only and final-only, for edge and node attention) on the
asymmetric and the symmetric batch, and in the scan layout; E(3)
invariance 3e-5; a 20-step affinity (multi_regression) trajectory within
atol 1e-4 / rtol 1e-5 of JAX's; the fused forward (K3 per layer, plain
here) against JAX's ``inference_engine.fused_forward`` (Pallas in
interpret mode) for each head and a final-only switch, and a 20-step
``fused_apply`` trajectory against JAX's ``fused_train.fused_apply``, at
the same gates. A reference-schema state_dict (JAX weights put into
torch_ref's RefMultitaskEGNN by ``load_flax_multitask_params``, re-keyed
as the reference saves it) loads and gives the reference's forward for
both heads; the port's state_dict goes back into
the JAX tree exactly.

The CLI: ``python -m pointvs_tpu_torch.main multitask ... --model_task
both`` against the JAX package's ``main`` from the same ``.pt`` weights
(20 pose steps, then 20 affinity steps on seeded labels): both loss
trajectories, the run directory's files, the epoch counters and the
validation rows; the serving CLI on that run directory (the affinity
head) against the JAX serving CLI; ``resume_training`` continues the
affinity phase alone.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu.models.torch_import import torch_to_flax_params
from pointvs_tpu.testing.torch_ref import RefMultitaskEGNN, \
    load_flax_multitask_params, samples_to_torch_batch
from pointvs_tpu.training.losses import loss_fn as jax_loss_fn
from pointvs_tpu.training.optimisers import build_optimiser as \
    jax_optimiser
from pointvs_tpu_torch import inference
from pointvs_tpu_torch.inference_engine import _layer_attention, \
    fused_forward, supports_fusion
from pointvs_tpu_torch.main import main as port_main
from pointvs_tpu_torch.models.params import load_reference_checkpoint, \
    state_dict_from_flax
from pointvs_tpu_torch.models.registry import build_model
from pointvs_tpu_torch.resume_training import main as resume_main
from tests.setup_and_params import EGNN_EPS, ORIGINAL_GRAPH, RESOURCES, \
    ROTATED_GRAPH
from tests.test_fused_engine import _pad_nodes
from tests.test_forward_parity import _random_samples
from tests.test_torch_egnn import port_batch
from tests.test_torch_import import ref_state_dict_multitask
from tests.test_torch_lucid import (DIM_IN, FWD_TOL, K, LAYERS, TRAJ_TOL,
                                    batch_of, draw_params, forward_pair,
                                    port_from_jax, port_trajectory,
                                    trajectory_batches)
from tests.test_torch_train_loader import write_types
from tests.test_train_trajectory import LR, N_BATCHES, WD, _jax_trajectory

BASE = dict(residual=True, normalize=True, tanh=True, graphnorm=True,
            edge_attention=True, softmax_attention=True,
            node_attention=True)
SWITCHES = {
    'none': {},
    'edge_first': dict(edge_attention_first_only=True),
    'edge_final': dict(edge_attention_final_only=True),
    'node_first': dict(node_attention_first_only=True),
    'node_final': dict(node_attention_final_only=True),
}
TASKS = {'classification': ('asym', {}),
         'multi_regression': ('sym', dict(dim_output=3,
                                          final_softplus=True))}


@pytest.mark.parametrize('task', sorted(TASKS))
@pytest.mark.parametrize('switch', sorted(SWITCHES))
def test_forward_matches_jax(switch, task):
    kind, extra = TASKS[task]
    flags = dict(BASE, **SWITCHES[switch], **extra)
    want, got = forward_pair('multitask', flags,
                             batch_of(kind, seed=len(switch)), task=task)
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_scan_layout_forward_matches_jax():
    want, got = forward_pair('multitask', dict(BASE, dim_output=3),
                             batch_of('asym'), scan_layers=True,
                             task='regression')
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_heads_and_switches():
    """Both heads exist whatever the task (a pose checkpoint continues on
    affinity); dim_output 3 with relu unless final_softplus; each layer
    carries its switched attention; the scan layout refuses switches."""
    kwargs = dict(dim_input=DIM_IN, k=K, num_layers=3, **BASE,
                  edge_attention_final_only=True,
                  node_attention_first_only=True)
    model = build_model('multitask', dim_output=3, **kwargs)
    sd = model.state_dict()
    assert sd['feats_linear_layers_pose.0.weight'].shape == (1, K)
    assert sd['feats_linear_layers_affinity.0.weight'].shape == (3, K)
    assert not any(k.startswith('feats_linear_layers.') for k in sd)
    assert isinstance(model.feats_linear_layers_affinity[1],
                      torch.nn.ReLU)
    assert isinstance(build_model('multitask', dim_output=1,
                                  final_softplus=True, **kwargs)
                      .feats_linear_layers_affinity[1], torch.nn.Softplus)
    assert [_layer_attention(model, i) for i in range(3)] == [
        'none', 'none', 'softmax']
    assert [layer.node_attention for layer in model.layers[1:]] == [
        True, False, False]
    assert sum('att_mlp.0.weight' in k and 'node' not in k
               for k in sd) == 1
    with pytest.raises(ValueError, match='scan_layers'):
        build_model('multitask', dim_output=1, scan_layers=True, **kwargs)


def test_e3_invariance():
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=3, num_layers=LAYERS,
                  **BASE, edge_attention_final_only=True)
    params = draw_params(build_jax_model('multitask', **kwargs),
                         ORIGINAL_GRAPH)
    model = port_from_jax('multitask', params, **kwargs)
    with torch.no_grad():
        for task in ('classification', 'regression'):
            a = model(port_batch(ORIGINAL_GRAPH), task=task).numpy()
            b = model(port_batch(ROTATED_GRAPH), task=task).numpy()
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, b, atol=EGNN_EPS, rtol=0)


def test_affinity_trajectory_matches_jax():
    batches = trajectory_batches(23, multi=True)
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=3, num_layers=LAYERS,
                  **BASE, graphnorm_whole_batch=True, final_softplus=True,
                  edge_attention_final_only=True)
    model = build_jax_model('multitask', scan_layers=False, **kwargs)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batches[0])
    want, _ = _jax_trajectory(model, params, batches, 'multi_regression')
    got = port_trajectory(port_from_jax('multitask', params, **kwargs),
                          batches, 'multi_regression', multitask=True)
    assert got[-N_BATCHES] < got[0]   # it trained
    np.testing.assert_allclose(got, want, **TRAJ_TOL)


# ------------------------------------------------------- fused paths
FUSED = dict(BASE, node_attention=False)


@pytest.mark.parametrize('case', ['pose', 'affinity', 'final_only'])
def test_fused_forward_matches_jax(case):
    """The port's fused engine against JAX's (interpret mode) and the
    port's module forward, per head and with a final-only switch."""
    from pointvs_tpu.inference_engine import fused_forward as jax_fused
    task = 'classification' if case == 'pose' else 'regression'
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=3,
                  **FUSED, edge_attention_final_only=case == 'final_only')
    batch = _pad_nodes(ORIGINAL_GRAPH)
    model = build_jax_model('multitask', **kwargs)
    params = draw_params(model, batch, seed=2)
    want = np.asarray(jax_fused(model, params, batch, task=task,
                                interpret=True))
    port = port_from_jax('multitask', params, **kwargs)
    assert supports_fusion(port)
    got = fused_forward(port, port_batch(batch), task=task).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    with torch.no_grad():
        module = port(port_batch(batch), task=task).numpy()
    np.testing.assert_allclose(got, module, **FWD_TOL)


def _jax_fused_trajectory(model, params, batches, task, steps):
    """JAX's fused_apply trained as JAX's train step trains: loss sum over
    the clamped weight, then the optax chain at the scheduled lr."""
    from pointvs_tpu.fused_train import fused_apply as jax_fused_apply
    from pointvs_tpu.training.optimisers import make_lr_schedule
    tx = jax_optimiser('adam', WD)
    sched = make_lr_schedule(LR, steps_per_epoch=N_BATCHES,
                             epochs=max(1, steps // N_BATCHES),
                             warm_restarts=True)

    @jax.jit
    def step(p, o, batch, lr):
        def loss(p):
            out = jax_fused_apply(model, p, batch, task=task,
                                  interpret=True)
            s, w = jax_loss_fn(out, batch, task, 'mse')
            return s / jnp.maximum(w, 1.0)
        value, grads = jax.value_and_grad(loss)(p)
        updates, o = tx.update(grads, o, p)
        return jax.tree.map(lambda a, u: a - lr * u, p, updates), o, value

    o = tx.init(params)
    losses = []
    for t in range(steps):
        params, o, value = step(params, o, batches[t % N_BATCHES],
                                jnp.float32(sched(t)))
        losses.append(float(value))
    return losses


def test_fused_apply_trajectory_matches_jax():
    """``fused_apply`` (K3 forward, K4 backward; plain here) with the
    affinity head and a final-only switch, 20 steps against JAX's."""
    steps = 20
    batches = [_pad_nodes(b) for b in trajectory_batches(24)]
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  **FUSED, edge_attention_final_only=True,
                  final_softplus=True)
    batches = [b._replace(y=np.abs(np.asarray(b.y)) * 3 + 1)
               for b in batches]
    model = build_jax_model('multitask', **kwargs)
    params = draw_params(model, batches[0], seed=5)
    want = _jax_fused_trajectory(model, params, batches, 'regression',
                                 steps)
    port = port_from_jax('multitask', params, **kwargs)
    got = port_trajectory(port, batches, 'regression', steps=steps,
                          multitask=True, use_fused=True)
    assert got[-N_BATCHES] < got[0]   # it trained
    np.testing.assert_allclose(got, want, **TRAJ_TOL)


# ----------------------------------------------------- weights across
def test_reference_state_dict_loads():
    """JAX weights put into torch_ref's RefMultitaskEGNN (whole-batch
    GraphNorm) by ``load_flax_multitask_params`` and saved in the
    reference schema load strictly into the port: the tensors
    ``state_dict_from_flax`` gives, and its forward for both heads."""
    from pointvs_tpu.data.buckets import pad_graphs_to_batch
    samples = _random_samples(3, seed=18)
    batch = pad_graphs_to_batch(
        samples, num_graphs=3, n_pad=sum(s.num_nodes for s in samples) + 5,
        e_pad=sum(s.num_edges for s in samples) + 9)
    flags = dict(residual=True, normalize=True, tanh=True, graphnorm=True,
                 edge_attention=True, edge_attention_first_only=True,
                 final_softplus=True)
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=3, num_layers=LAYERS,
                  graphnorm_whole_batch=True, **flags)
    params = draw_params(build_jax_model('multitask', **kwargs), batch,
                         seed=6)
    net = load_flax_multitask_params(
        RefMultitaskEGNN(DIM_IN, K, 3, LAYERS, **flags), params).eval()
    port = build_model('multitask', **kwargs).eval()
    port.load_state_dict(ref_state_dict_multitask(net), strict=True)
    for key, value in state_dict_from_flax(params).items():
        assert torch.equal(port.state_dict()[key], value), key
    feats, coords, rows, cols, eattr, gid, _ = samples_to_torch_batch(
        samples)
    with torch.no_grad():
        for task in ('classification', 'multi_regression'):
            want = net(feats, coords, rows, cols, eattr, gid, 3,
                       task=task).numpy()
            got = port(port_batch(batch), task=task).numpy()
            np.testing.assert_allclose(got, want, **FWD_TOL, err_msg=task)


def test_state_dict_round_trip():
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=3, num_layers=LAYERS,
                  **BASE, node_attention_final_only=True)
    batch = batch_of('asym')
    params = draw_params(build_jax_model('multitask', **kwargs), batch)
    sd = port_from_jax('multitask', params, **kwargs).state_dict()
    back = torch_to_flax_params(sd, params, 'multitask')
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf))


# --------------------------------------------------------------- CLI
CLI_MODEL = ['--layers', str(LAYERS), '-k', str(K), '--egnn_residual',
             '--egnn_normalise', '--egnn_tanh', '--graphnorm',
             '--egnn_attention', '--softmax_attention',
             '--edge_attention_final_only', '--compact', '--radius', '4',
             '--edge_radius', '4', '--estimate_bonds']
SETUP = ['--num_devices', '1', '--prefetch', '0', '--device_cache', 'off']


def write_affinity_types(path, n=40, seed=0):
    """Seeded pKi / pKd / IC50 labels, about a third missing (-1)."""
    rng = np.random.RandomState(seed)
    pairs = ('rec_0.parquet lig_0.parquet', 'rec.parquet lig.parquet')
    lines = []
    for i in range(n):
        values = rng.uniform(3.0, 9.0, 3)
        values[rng.rand(3) < 0.3] = -1
        values[0] = values[0] if values[0] > 0 else 5.0
        lines.append(' '.join(f'{v:.3f}' for v in values)
                     + f' {pairs[i % 2]}')
    path.write_text('\n'.join(lines) + '\n')
    return path


def _argv(save, pose_types, affinity_types, weights):
    data = str(RESOURCES)
    return (['multitask', str(save), '--train_data_root_pose', data,
             '--train_types_pose', str(pose_types),
             '--test_data_root_pose', data, '--test_types_pose',
             str(RESOURCES / 'test.types'), '--train_data_root_affinity',
             data, '--train_types_affinity', str(affinity_types),
             '--test_data_root_affinity', data, '--test_types_affinity',
             str(affinity_types), '--model_task', 'both', '-b', '2', '-ep',
             '1', '-ea', '1', '--dropout', '0', '--end_flag',
             '--load_weights', str(weights)] + CLI_MODEL + SETUP)


@pytest.fixture(scope='module')
def both_runs(tmp_path_factory):
    from pointvs_tpu.main import main as jax_main
    root = tmp_path_factory.mktemp('multitask_cli')
    pose = write_types(root / 'pose.types', n=40,
                       labels=lambda i: int(i % 3 == 0))
    affinity = write_affinity_types(root / 'affinity.types', seed=7)
    kwargs = dict(dim_input=12, k=K, dim_output=1, num_layers=LAYERS,
                  **dict(BASE, node_attention=False),
                  edge_attention_final_only=True)
    params = draw_params(build_jax_model('multitask', **kwargs),
                         ORIGINAL_GRAPH, seed=8)
    weights = root / 'init.pt'
    torch.save({'model_state_dict': state_dict_from_flax(params),
                'p_epoch': 0, 'a_epoch': 0}, weights)
    jax_trainer = jax_main(_argv(root / 'jax', pose, affinity, weights))
    port_trainer = port_main(_argv(root / 'port', pose, affinity, weights)
                             + ['--device', 'cpu'])
    return root, jax_trainer, port_trainer, affinity


def _logged(run, task):
    return {r[f'Batch (train, {task})']: r[f'Loss (train, {task})']
            for r in map(json.loads,
                         (run / 'metrics.jsonl').read_text().splitlines())
            if f'Loss (train, {task})' in r}


def test_both_phases_match_jax(both_runs):
    root, jax_trainer, port_trainer, _ = both_runs
    losses = np.asarray(port_trainer.train_losses)
    assert len(losses) == 40 and np.isfinite(losses).all()
    for offset, task in ((0, 'pose'), (20, 'affinity')):
        logged = _logged(root / 'jax', task)
        assert sorted(logged) == [1, 11], task
        for batch, loss in logged.items():
            np.testing.assert_allclose(losses[offset + batch - 1], loss,
                                       err_msg=task, **TRAJ_TOL)
        assert _logged(root / 'port', task) == {
            b: losses[offset + b - 1] for b in (1, 11)}
    assert (port_trainer.p_epoch, port_trainer.a_epoch) == (
        jax_trainer.p_epoch, jax_trainer.a_epoch) == (1, 1)
    for name, epochs in (('pose_ckpt_epoch_1.pt', (1, 0)),
                         ('affinity_ckpt_epoch_1.pt', (1, 1))):
        _, meta = load_reference_checkpoint(
            root / 'port' / 'checkpoints' / name)
        assert (meta['p_epoch'], meta['a_epoch']) == epochs, name
    want = state_dict_from_flax(jax.tree.map(np.asarray, jax_trainer.params))
    got, _ = load_reference_checkpoint(
        root / 'port' / 'checkpoints' / 'affinity_ckpt_epoch_1.pt')
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                   err_msg=key, **TRAJ_TOL)
    for fname, score_col in (('pose_predictions.txt', 2),
                             ('affinity_predictions.txt', 2)):
        want_rows = [r.split() for r in (root / 'jax' / fname)
                     .read_text().splitlines()]
        got_rows = [r.split() for r in (root / 'port' / fname)
                    .read_text().splitlines()]
        assert len(got_rows) == len(want_rows) > 0, fname
        for g, w in zip(got_rows, want_rows):
            assert g[:score_col] == w[:score_col] and \
                g[score_col + 1:] == w[score_col + 1:], fname
            assert abs(float(g[score_col]) - float(w[score_col])) <= 1.1e-3


def test_both_run_directory_matches_jax(both_runs):
    root = both_runs[0]

    def names(run):
        out = {p.relative_to(run).as_posix().replace('.pt', '')
               for p in run.rglob('*')}
        return {n for n in out if n != 'train_spec.yaml'
                and n.count('/') <= 1}

    assert names(root / 'port') == names(root / 'jax')
    assert {'checkpoints/pose_ckpt_epoch_1',
            'checkpoints/affinity_ckpt_epoch_1', 'pose_predictions.txt',
            'affinity_predictions.txt', 'metrics.jsonl',
            '_FINISHED'} <= names(root / 'port')
    kwargs = yaml.safe_load((root / 'port' / 'model_kwargs.yaml')
                            .read_text())
    assert kwargs['model_task'] == 'classification'


def test_serving_cli_scores_affinity_like_jax(both_runs):
    """Both serving CLIs on the port's run directory with --model_task
    regression: the affinity checkpoint and head, the same rows."""
    from pointvs_tpu.inference import main as jax_inference
    root, _, _, affinity = both_runs
    run = root / 'port'
    args = [str(run), str(affinity), str(RESOURCES), '--model_task',
            'regression', '--num_devices', '1']
    jax_inference(args + ['--output_fname', 'jax_served.txt'])
    trainer = inference.main(args + ['--output_fname', 'served.txt',
                                     '--device', 'cpu'])
    assert trainer.a_epoch == 1
    want = [r.split() for r in (run / 'affinity_jax_served.txt')
            .read_text().splitlines()]
    got = [r.split() for r in (run / 'affinity_served.txt')
           .read_text().splitlines()]
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[3:] == w[3:]
        assert abs(float(g[2]) - float(w[2])) <= 1.1e-3
    # --model_task both serves as classification, the pose head, from the
    # newest checkpoint of either task (the affinity phase's trunk), as
    # the JAX serving CLI does: the same rows within the serving gate.
    pose_args = [str(run), str(RESOURCES / 'test.types'), str(RESOURCES),
                 '--model_task', 'both']
    jax_inference(pose_args + ['--num_devices', '1', '--output_fname',
                               'jax_b.txt'])
    pose = inference.main(pose_args + ['--device', 'cpu',
                                       '--output_fname', 'b.txt'])
    assert (pose.p_epoch, pose.a_epoch) == (1, 1)
    want = [r.split() for r in (run / 'pose_jax_b.txt')
            .read_text().splitlines()]
    got = [r.split() for r in (run / 'pose_b.txt').read_text().splitlines()]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == '|' and g[3:] == w[3:]
        assert abs(float(g[2]) - float(w[2])) <= 2e-3
    np.testing.assert_allclose(pose.val_scores, [float(w[2]) for w in want],
                               atol=2e-3)


def test_resume_continues_the_affinity_phase(both_runs, tmp_path):
    """A --model_task both run raised to 2 affinity epochs resumes from its
    newest checkpoint (affinity, epoch 1) and trains the affinity phase
    alone."""
    import shutil
    run = tmp_path / 'run'
    shutil.copytree(both_runs[0] / 'port', run)
    args = yaml.safe_load((run / 'cmd_args.yaml').read_text())
    args['epochs_affinity'] = 2
    (run / 'cmd_args.yaml').write_text(yaml.dump(args))
    trainer = resume_main([str(run), '--device', 'cpu'])
    assert (trainer.p_epoch, trainer.a_epoch) == (1, 2)
    assert len(trainer.train_losses) == 20
    ckpts = sorted(p.name for p in (run / 'checkpoints').iterdir())
    assert ckpts == ['affinity_ckpt_epoch_1.pt', 'affinity_ckpt_epoch_2.pt',
                     'pose_ckpt_epoch_1.pt']


def test_both_needs_the_multitask_model(tmp_path):
    with pytest.raises(RuntimeError, match='multitask'):
        port_main(['egnn', str(tmp_path / 'run'), '--train_data_root_pose',
                   str(RESOURCES), '--train_types_pose',
                   str(RESOURCES / 'test.types'), '--model_task', 'both',
                   '--device', 'cpu'])
