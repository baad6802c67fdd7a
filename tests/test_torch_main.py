"""The port's training CLI (``pointvs_tpu_torch.main``) against the JAX
package's (``pointvs_tpu.main``), and its resume and serving round trips.

One parameter set (numpy draws in the JAX model's shapes) is written as a
reference-schema ``.pt`` and both CLIs start from it with
``--load_weights``: 20 steps (``-b 2`` over a 40-line types file with
mixed labels, so weighted sampling is on; ``--dropout 0``), then
validation on ``tests/resources/test.types``. Each CLI's per-step losses
(the port's ``Trainer.train_losses``; JAX's ``Loss (train, pose)`` rows of
``metrics.jsonl`` at the steps it logs) and the final parameters agree
within atol 1e-4 / rtol 1e-5, the JAX suite's trajectory gate; the
predictions files have the same rows with scores within 1.1e-3 (three
printed decimals). The run directories hold the same files and
``metrics.jsonl`` the same keys. The JAX CLI runs on one CPU device with
the loader thread off (``--num_devices 1 --prefetch 0``) and its
device-resident dataset off.

Also: ``resume_training`` continues a 1-epoch run to epoch 3 with Adam's
step count carried on; the serving CLI scores a port run directory to the
trained model's predictions; ``--scatter_cap`` (the reference's TPU window
capacity) changes nothing in a run or in its resume; and ``--device
cuda`` without CUDA raises. With ``--device_cache off`` every batch goes
to the step in the packed wire form (``data/wire.py``); with the loader's
producer thread (``--prefetch 2``) the run gives the in-line run's
losses exactly.
"""
import json
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from pointvs_tpu.main import main as jax_main
from pointvs_tpu_torch import inference
from pointvs_tpu_torch.logging import get_logger
from pointvs_tpu_torch.main import main as port_main
from pointvs_tpu_torch.models.params import load_reference_checkpoint, \
    state_dict_from_flax
from pointvs_tpu_torch.resume_training import main as resume_main
from tests.setup_and_params import ORIGINAL_GRAPH, RESOURCES
from tests.test_torch_egnn import K, LAYERS, jax_model_and_params
from tests.test_torch_train_loader import write_types

TRAJ_TOL = dict(atol=1e-4, rtol=1e-5)
MODEL_FLAGS = dict(residual=True, normalize=True, tanh=True, graphnorm=True,
                   edge_attention=True, softmax_attention=True)
CLI_MODEL = ['--layers', str(LAYERS), '-k', str(K), '--egnn_residual',
             '--egnn_normalise', '--egnn_tanh', '--graphnorm',
             '--egnn_attention', '--softmax_attention', '--compact',
             '--radius', '4', '--edge_radius', '4', '--estimate_bonds']
SETUP = ['--num_devices', '1', '--prefetch', '0', '--device_cache', 'off']


def _argv(save, types, extra=()):
    return (['egnn', str(save), '--train_data_root_pose', str(RESOURCES),
             '--train_types_pose', str(types), '--test_data_root_pose',
             str(RESOURCES), '--test_types_pose',
             str(RESOURCES / 'test.types'), '-b', '2', '-ep', '1', '--top1',
             '--end_flag', '--dropout', '0'] + CLI_MODEL + SETUP
            + list(extra))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('cli')
    types = write_types(root / 'train.types', n=40,
                        labels=lambda i: int(i % 3 == 0))
    _, params = jax_model_and_params(MODEL_FLAGS, ORIGINAL_GRAPH, False,
                                     seed=6)
    weights = root / 'init.pt'
    torch.save({'model_state_dict': state_dict_from_flax(params),
                'p_epoch': 0, 'a_epoch': 0}, weights)
    extra = ['--load_weights', str(weights)]
    jax_trainer = jax_main(_argv(root / 'jax', types, extra))
    port_trainer = port_main(_argv(root / 'port', types, extra)
                             + ['--device', 'cpu'])
    return root, jax_trainer, port_trainer


def _metrics(run):
    return [json.loads(line) for line in
            (run / 'metrics.jsonl').read_text().splitlines()]


def _rows(path):
    return [line.split() for line in path.read_text().splitlines()]


def test_cli_trajectory_matches_jax(runs):
    root, jax_trainer, port_trainer = runs
    losses = np.asarray(port_trainer.train_losses)
    assert len(losses) == 20 and np.isfinite(losses).all()
    logged = {r['Batch (train, pose)']: r['Loss (train, pose)']
              for r in _metrics(root / 'jax') if 'Loss (train, pose)' in r}
    assert sorted(logged) == [1, 11]
    for batch, loss in logged.items():
        np.testing.assert_allclose(losses[batch - 1], loss, **TRAJ_TOL)
    port_logged = {r['Batch (train, pose)']: r['Loss (train, pose)']
                   for r in _metrics(root / 'port')
                   if 'Loss (train, pose)' in r}
    assert port_logged == {b: losses[b - 1] for b in (1, 11)}

    want = state_dict_from_flax(jax.tree.map(np.asarray, jax_trainer.params))
    got, meta = load_reference_checkpoint(
        root / 'port' / 'checkpoints' / 'pose_ckpt_epoch_1.pt')
    assert meta['p_epoch'] == 1 and sorted(got) == sorted(want)
    moved = 0.0
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                   err_msg=key, **TRAJ_TOL)
        moved = max(moved, float(np.abs(
            port_trainer.model.state_dict()[key].numpy()
            - np.asarray(value)).max()))
    assert moved <= TRAJ_TOL['atol']

    want_rows = _rows(root / 'jax' / 'pose_predictions.txt')
    got_rows = _rows(root / 'port' / 'pose_predictions.txt')
    assert len(got_rows) == len(want_rows) == 2
    for g, w in zip(got_rows, want_rows):
        assert g[:2] == w[:2] and g[3:] == w[3:]
        assert abs(float(g[2]) - float(w[2])) <= 1.1e-3


def test_producer_thread_transfer_matches_jax(runs):
    """The same run with the loader's producer thread (``--prefetch 2``),
    which collates, packs (data/wire.py) and copies each batch ahead of
    the step (``--device_cache off``: every batch goes by the wire): the
    losses of the in-line run exactly, and JAX's within the gate."""
    root, _, port_trainer = runs
    argv = _argv(root / 'port_prefetch', root / 'train.types',
                 ['--load_weights', str(root / 'init.pt')])
    argv[argv.index('--prefetch') + 1] = '2'
    trainer = port_main(argv + ['--device', 'cpu'])
    assert trainer.train_losses == port_trainer.train_losses
    logged = {r['Batch (train, pose)']: r['Loss (train, pose)']
              for r in _metrics(root / 'jax') if 'Loss (train, pose)' in r}
    for batch, loss in logged.items():
        np.testing.assert_allclose(trainer.train_losses[batch - 1], loss,
                                   **TRAJ_TOL)
    assert (root / 'port_prefetch' / 'pose_predictions.txt').read_text() \
        == (root / 'port' / 'pose_predictions.txt').read_text()


def test_run_directory_matches_jax(runs):
    root = runs[0]

    def names(run):
        out = {p.relative_to(run).as_posix().replace('.pt', '')
               for p in run.rglob('*')}
        # The JAX package's cache of compiled TPU programs, and the files
        # inside its orbax checkpoint directories.
        return {n for n in out if n != 'train_spec.yaml'
                and n.count('/') <= 1}

    jax_names, port_names = names(root / 'jax'), names(root / 'port')
    assert port_names == jax_names
    assert {'cmd_args.yaml', 'model_kwargs.yaml', 'output.log',
            'metrics.jsonl', 'checkpoints/pose_ckpt_epoch_1',
            'pose_predictions.txt', '_FINISHED'} <= port_names
    keys = [set().union(*map(set, _metrics(root / run)))
            for run in ('jax', 'port')]
    assert keys[1] == keys[0]
    assert 'Learning rate (train, pose)' in keys[1]
    cmd = yaml.safe_load((root / 'port' / 'cmd_args.yaml').read_text())
    assert cmd['device'] == 'cpu' and 'hostname' in cmd \
        and 'slurm_jobid' in cmd
    assert 'Epoch 1/1' in (root / 'port' / 'output.log').read_text()


def test_serving_cli_scores_a_port_run(runs):
    run = runs[0] / 'port'
    trainer = inference.main([str(run), str(RESOURCES / 'test.types'),
                              str(RESOURCES), '--device', 'cpu',
                              '--output_fname', 'served.txt'])
    assert trainer.p_epoch == 1
    assert (run / 'pose_served.txt').read_text() == (
        run / 'pose_predictions.txt').read_text()
    np.testing.assert_array_equal(trainer.val_scores,
                                  runs[2].val_scores)


def _adam_steps(optimiser_state):
    return {int(s['step']) for s in optimiser_state['state'].values()}


def test_resume_continues_from_the_saved_epoch(tmp_path):
    save = tmp_path / 'resume_run'
    port_main(['egnn', str(save), '--train_data_root_pose', str(RESOURCES),
               '--train_types_pose', str(RESOURCES / 'test.types'), '-b',
               '2', '--device', 'cpu'] + CLI_MODEL[:4] + ['-ep', '1'])
    first = torch.load(save / 'checkpoints' / 'pose_ckpt_epoch_1.pt')
    assert _adam_steps(first['optimiser_state_dict']) == {1}

    args = yaml.safe_load((save / 'cmd_args.yaml').read_text())
    args['epochs_pose'] = 3
    (save / 'cmd_args.yaml').write_text(yaml.dump(args))
    trainer = resume_main([str(save), '--device', 'cpu'])
    assert trainer.p_epoch == 3
    for epoch in (2, 3):
        ckpt = torch.load(save / 'checkpoints' / f'pose_ckpt_epoch_{epoch}.pt')
        assert _adam_steps(ckpt['optimiser_state_dict']) == {epoch}
    assert _adam_steps(trainer.optimiser.state_dict()) == {3}


@pytest.fixture(scope='module')
def capped_runs(tmp_path_factory):
    """One epoch with and without ``--scatter_cap 64``: (runs, Trainers)."""
    root = tmp_path_factory.mktemp('scatter_cap')
    runs, trainers = {}, {}
    for name, extra in (('plain', []), ('capped', ['--scatter_cap', '64'])):
        runs[name] = root / name
        trainers[name] = port_main(
            ['egnn', str(runs[name]), '--train_data_root_pose',
             str(RESOURCES), '--train_types_pose',
             str(RESOURCES / 'test.types'), '-b', '2', '-ep', '1',
             '--device', 'cpu'] + CLI_MODEL[:4] + extra)
    return runs, trainers


def _weights(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


@pytest.mark.parametrize('cli', ['main', 'resume'])
def test_scatter_cap_has_no_effect(capped_runs, tmp_path, cli, caplog):
    """The port's segment kernels have no windows to cap: a run with the
    flag, and its resume from a cmd_args.yaml that carries it, end with
    the weights of the run without it."""
    runs, trainers = capped_runs
    if cli == 'resume':
        trainers = {}
        logger = get_logger()   # its own handlers: no propagation
        logger.addHandler(caplog.handler)
        try:
            for name, run in runs.items():
                copy = tmp_path / name
                shutil.copytree(run, copy)
                args = yaml.safe_load((copy / 'cmd_args.yaml').read_text())
                args['epochs_pose'] = 2
                (copy / 'cmd_args.yaml').write_text(yaml.dump(args))
                trainers[name] = resume_main([str(copy), '--device', 'cpu'])
                assert trainers[name].p_epoch == 2
        finally:
            logger.removeHandler(caplog.handler)
        assert '--scatter_cap 64 has no effect' in caplog.text
    saved = yaml.safe_load((runs['capped'] / 'cmd_args.yaml').read_text())
    assert saved['scatter_cap'] == 64
    plain, capped = _weights(trainers['plain']), _weights(trainers['capped'])
    assert sorted(plain) == sorted(capped)
    for key, value in plain.items():
        assert torch.equal(value, capped[key]), key
    assert trainers['plain'].train_losses == trainers['capped'].train_losses


def test_cuda_without_a_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device cpu'):
        port_main(['egnn', str(tmp_path / 'run'), '--train_data_root_pose',
                   str(RESOURCES), '--train_types_pose',
                   str(RESOURCES / 'test.types')])


def test_profile_traces_steps_3_to_8(tmp_path):
    types = write_types(tmp_path / 'train.types', n=20)
    save = tmp_path / 'run'
    trainer = port_main(['egnn', str(save), '--train_data_root_pose',
                         str(RESOURCES), '--train_types_pose', str(types),
                         '-b', '2', '-ep', '1', '--profile', '--device',
                         'cpu'] + CLI_MODEL[:4] + CLI_MODEL[-5:])
    assert len(trainer.train_losses) == 10
    traces = list((save / 'profile').glob('*.json'))
    assert [t.name for t in traces] == ['trace_pose_epoch_1.json']
    trace = json.loads(traces[0].read_text())
    steps = [e for e in trace['traceEvents']
             if e.get('name', '').startswith('ProfilerStep')
             or 'aten::' in e.get('name', '')]
    assert steps
