"""The port's scale-out CLIs on gloo CPU ranks, against the JAX package's
and against each other.

One parameter set (numpy draws of the JAX model's shapes) starts every run
through ``--load_weights``; 11 training poses at ``-b 2`` (6 steps: one
rank's stripe runs out a step before the other's), the padding pinned by
``--node_bucket`` / ``--edge_bucket``, then validation. GraphNorm takes
per-graph statistics here: under ``--strict_graphnorm`` the reference's
placeholder for an empty dp row carries one real node into the
whole-batch statistics (the port's placeholder has none), and
``test_torch_scale_out.py`` holds the strict dp step against JAX's.

- ``main --num_devices 2 --device cpu`` (2 spawned ranks, the
  device-resident dataset on its default ``auto``) against JAX's ``main
  --num_devices 2`` on 2 of the suite's forced XLA host devices (its
  dataset streamed): the final weights within atol 1e-4 / rtol 1e-5, the
  first step's logged loss, and the predictions files' rows (the port's
  in dataset order, JAX's in its rows' order) within 1.1e-3 (three
  printed decimals);
- ``--num_devices 4 --graph_shard 2`` (2 dp rows x 2 edge shards) against
  ``--num_devices 2``: losses and weights within atol 1e-4 / rtol 1e-5,
  validation scores within 5e-4 (the bound of
  ``tests/test_graph_shard.py::test_cli_graph_shard_matches_dp_only``);
  the sharded run serves on one device (``inference --num_devices 1``)
  to its own scores;
- ``--multihost``: two processes given ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` (as ``torchrun``
  sets them) against the 2 spawned ranks of ``--num_devices 2``, within
  1e-5, as ``tests/test_multihost.py`` holds the reference's;
- ``resume_training --num_devices 1`` continues the 2-rank run; the
  reference's checks of a scale-out command line stop the CLI by name;
  the backend rule and the rank counts.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from pointvs_tpu.main import main as jax_main
from pointvs_tpu_torch import inference
from pointvs_tpu_torch.main import main as port_main
from pointvs_tpu_torch.models.params import load_reference_checkpoint, \
    state_dict_from_flax
from pointvs_tpu_torch.parallel.launch import backend_for, \
    default_num_devices, free_port
from pointvs_tpu_torch.resume_training import main as resume_main
from pointvs_tpu_torch.training.engine import Trainer
from tests.setup_and_params import ORIGINAL_GRAPH, RESOURCES
from tests.test_torch_main import CLI_MODEL, MODEL_FLAGS, TRAJ_TOL
from tests.test_torch_egnn import jax_model_and_params
from tests.test_torch_train_loader import write_types

REPO = RESOURCES.parents[1]
BUCKETS = ['--node_bucket', '256', '--edge_bucket', '2048']


def _argv(save, types, weights, extra=()):
    return (['egnn', str(save), '--train_data_root_pose', str(RESOURCES),
             '--train_types_pose', str(types), '--test_data_root_pose',
             str(RESOURCES), '--test_types_pose',
             str(RESOURCES / 'test.types'), '-b', '2', '-ep', '1',
             '--top1', '--end_flag', '--dropout', '0', '--prefetch', '0',
             '--load_weights', str(weights)]
            + CLI_MODEL + BUCKETS + list(extra))


def _multihost(argv):
    """The training CLI as 2 ranks of a launcher's job."""
    port = str(free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE='2',
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE='2',
                   MASTER_ADDR='127.0.0.1', MASTER_PORT=port)
        env.pop('PYTEST_CURRENT_TEST', None)
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'pointvs_tpu_torch.main'] + argv,
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), '\n===\n'.join(logs)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('scale_out_cli')
    types = write_types(root / 'train.types', n=11,
                        labels=lambda i: int(i % 3 == 0))
    _, params = jax_model_and_params(MODEL_FLAGS, ORIGINAL_GRAPH, False,
                                     seed=8)
    weights = root / 'init.pt'
    torch.save({'model_state_dict': state_dict_from_flax(params),
                'p_epoch': 0, 'a_epoch': 0}, weights)
    jax_main(_argv(root / 'jax', types, weights,
                   ['--num_devices', '2', '--device_cache', 'off']))
    dp = port_main(_argv(root / 'dp', types, weights,
                         ['--num_devices', '2', '--device', 'cpu']))
    gs = port_main(_argv(root / 'gs', types, weights,
                         ['--num_devices', '4', '--graph_shard', '2',
                          '--device', 'cpu']))
    _multihost(_argv(root / 'mh', types, weights,
                     ['--multihost', '--device', 'cpu']))
    return root, dp, gs


def _weights(run):
    state, meta = load_reference_checkpoint(
        run / 'checkpoints' / 'pose_ckpt_epoch_1.pt')
    assert meta['p_epoch'] == 1
    return state


def _rows(path):
    return sorted(line.split() for line in path.read_text().splitlines())


def _logged_losses(run):
    return {r['Batch (train, pose)']: r['Loss (train, pose)']
            for r in map(json.loads,
                         (run / 'metrics.jsonl').read_text().splitlines())
            if 'Loss (train, pose)' in r}


def test_dp_cli_matches_jax(runs):
    root, dp, _ = runs
    assert [r['rank'] for r in dp] == [0, 1]
    losses = dp[0]['train_losses']
    assert len(losses) == 6 and losses == dp[1]['train_losses']
    assert _logged_losses(root / 'dp') == {1: losses[0]}
    np.testing.assert_allclose(losses[0], _logged_losses(root / 'jax')[1],
                               **TRAJ_TOL)
    want = state_dict_from_flax(jax.tree.map(
        np.asarray, _jax_final_params(root / 'jax')))
    got = _weights(root / 'dp')
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                   err_msg=key, **TRAJ_TOL)
    want_rows = _rows(root / 'jax' / 'pose_predictions.txt')
    got_rows = _rows(root / 'dp' / 'pose_predictions.txt')
    assert len(got_rows) == len(want_rows) == 2
    for g, w in zip(got_rows, want_rows):
        assert g[:2] == w[:2] and g[3:] == w[3:]
        assert abs(float(g[2]) - float(w[2])) <= 1.1e-3


def _jax_final_params(run):
    """The JAX run's final parameters, from its orbax checkpoint."""
    from pointvs_tpu.models.load_model import load_model
    trainer = load_model(run, num_devices=1)[0]
    return trainer.params


def test_dp_run_directory_is_written_once(runs):
    """Rank 0 alone writes: one Parameters record, one set of logged
    losses, one predictions row per validation pose, one checkpoint."""
    root, dp, _ = runs
    run = root / 'dp'
    names = sorted(p.name for p in run.iterdir())
    assert names == sorted(['checkpoints', 'cmd_args.yaml', 'metrics.jsonl',
                            'model_kwargs.yaml', 'output.log',
                            'pose_predictions.txt', '_FINISHED'])
    records = [json.loads(line) for line in
               (run / 'metrics.jsonl').read_text().splitlines()]
    assert sum('Parameters' in r for r in records) == 1
    assert len((run / 'pose_predictions.txt').read_text().splitlines()) == 2
    assert sorted(p.name for p in (run / 'checkpoints').iterdir()) == [
        'pose_ckpt_epoch_1.pt']
    kwargs = yaml.safe_load((run / 'model_kwargs.yaml').read_text())
    assert 'edge_shard_axis' not in kwargs \
        and 'batch_shard_axis' not in kwargs
    assert np.array_equal(dp[0]['val_scores'], dp[1]['val_scores'])


def test_graph_shard_cli_matches_dp_only(runs):
    root, dp, gs = runs
    assert len(gs) == 4
    for report in gs:
        np.testing.assert_allclose(report['train_losses'],
                                   dp[0]['train_losses'], **TRAJ_TOL)
        np.testing.assert_allclose(report['val_scores'], dp[0]['val_scores'],
                                   atol=5e-4)
    want = _weights(root / 'dp')
    got = _weights(root / 'gs')
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   err_msg=key, **TRAJ_TOL)


def test_graph_shard_run_serves_on_one_device(runs):
    root, _, gs = runs
    trainer = inference.main([str(root / 'gs'),
                              str(RESOURCES / 'test.types'), str(RESOURCES),
                              '--num_devices', '1', '--device', 'cpu',
                              '--output_fname', 'one_device.txt'])
    assert trainer.num_devices == 1 and trainer.graph_shard == 1
    np.testing.assert_allclose(trainer.val_scores, gs[0]['val_scores'],
                               atol=5e-4)
    assert len(_rows(root / 'gs' / 'pose_one_device.txt')) == 2


def test_multihost_matches_spawned_ranks(runs):
    root, dp, _ = runs
    assert _logged_losses(root / 'mh') == pytest.approx(
        _logged_losses(root / 'dp'), abs=1e-5)
    want = _weights(root / 'dp')
    got = _weights(root / 'mh')
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   err_msg=key, atol=1e-5)
    assert _rows(root / 'mh' / 'pose_predictions.txt') == \
        _rows(root / 'dp' / 'pose_predictions.txt')


def test_resume_on_one_device(runs, tmp_path):
    """A run trained on 2 ranks resumes on 1 (the flag overrides the
    run's own --num_devices)."""
    import shutil
    root, _, _ = runs
    run = tmp_path / 'dp'
    shutil.copytree(root / 'dp', run)
    args = yaml.safe_load((run / 'cmd_args.yaml').read_text())
    args['epochs_pose'] = 2
    (run / 'cmd_args.yaml').write_text(yaml.dump(args))
    trainer = resume_main([str(run), '--num_devices', '1', '--device',
                           'cpu'])
    assert trainer.p_epoch == 2 and trainer.num_devices == 1
    assert (run / 'checkpoints' / 'pose_ckpt_epoch_2.pt').exists()
    assert np.isfinite(trainer.train_losses).all()


CHECKS = {   # extra flags -> the SystemExit's words
    'graph_shard_divides': (['--num_devices', '3', '--graph_shard', '2'],
                            'divisible by --graph_shard'),
    'graph_shard_models': (['--num_devices', '2', '--graph_shard', '2',
                            '--model_task', 'classification'],
                           '--graph_shard supports'),
    'batch_divides': (['--num_devices', '3'], '--batch_size 2 must be'),
    'multihost_buckets': (['--multihost'], '--node_bucket'),
    'multihost_env': (['--multihost', '--node_bucket', '256',
                       '--edge_bucket', '2048'], 'launcher environment'),
}


@pytest.mark.parametrize('name', sorted(CHECKS))
def test_scale_out_checks_stop_the_cli(tmp_path, monkeypatch, name):
    for key in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(key, raising=False)
    extra, words = CHECKS[name]
    model = 'siamese' if name == 'graph_shard_models' else 'egnn'
    argv = [model, str(tmp_path / 'run'), '--train_data_root_pose',
            str(RESOURCES), '--train_types_pose',
            str(RESOURCES / 'test.types'), '-b', '2', '--device', 'cpu']
    with pytest.raises(SystemExit, match=words):
        port_main(argv + extra)
    assert not (tmp_path / 'run' / 'cmd_args.yaml').exists()


def test_backend_rule_and_rank_counts():
    assert backend_for('cpu', 2) == 'gloo'
    cards = torch.cuda.device_count()
    assert backend_for('cuda', max(cards, 1)) == (
        'nccl' if cards else 'gloo')
    assert backend_for('cuda', cards + 1) == 'gloo'
    assert default_num_devices('cpu') == 1


def test_trainer_needs_its_ranks(tmp_path):
    """A Trainer asked for 2 devices outside a 2-rank process group stops
    (the CLIs start the ranks)."""
    with pytest.raises(ValueError, match='rank'):
        Trainer('egnn', tmp_path, torch.device('cpu'), num_devices=2,
                silent=True, dim_input=12, k=8, num_layers=1)


def test_a_failing_rank_fails_the_cli(tmp_path):
    """A rank that raises (here: its types file is missing) stops the
    spawned job, and the parent raises."""
    argv = ['egnn', str(tmp_path / 'run'), '--train_data_root_pose',
            str(RESOURCES), '--train_types_pose',
            str(tmp_path / 'missing.types'), '-b', '2', '--num_devices',
            '2', '--device', 'cpu', '--prefetch', '0']
    with pytest.raises(Exception, match='missing.types'):
        port_main(argv)
