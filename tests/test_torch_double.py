"""The port's ``--double`` (float64) against the JAX package's.

JAX runs float64 only with x64 enabled, which is process-global: every
JAX call here runs inside ``jax.enable_x64()``, a context manager, so
nothing leaks to the next test file on the same worker. Parameters are
drawn in f32 (tests/test_torch_egnn.py's draws) and cast to f64 in both
packages, as ``Trainer(double=True)`` casts them; the batch is f32, which
JAX promotes op by op and the port casts to f64 at the model's entry
(exactly). Both round the node embeddings to f32 in ``pool``, as the
reference does (ROADMAP.md, Queue 3).

Gates: forward and a 5-step loss trajectory within ``REL`` 1e-9 of the
largest |value| (measured: the forwards identical; the trajectory at
most 1.1e-16, with the learning rate rounded to f32 as the
reference passes it). Also: the training CLI with ``--double --device cpu``
writes f64 checkpoints that reload as f64, the serving CLI scores the run
to its validation rows, ``resume_training`` continues it in f64, and
``main``, ``inference`` and ``resume_training`` with ``--device cuda``
exit naming ``--device cpu`` before any CUDA work (``main`` leaves no run
directory).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pointvs_tpu_torch import inference
from pointvs_tpu_torch.data.buckets import cast_floats
from pointvs_tpu_torch.inference_engine import supports_fusion
from pointvs_tpu_torch.main import main as port_main
from pointvs_tpu_torch.models.load_model import load_model
from pointvs_tpu_torch.parallel.steps import make_eval_step
from pointvs_tpu_torch.resume_training import main as resume_main
from pointvs_tpu_torch.training.engine import Trainer
from tests.setup_and_params import RESOURCES
from tests.test_torch_egnn import CONFIGS, jax_batch, \
    jax_model_and_params, port_batch, port_model
from tests.test_torch_lucid import port_trajectory, trajectory_batches
from tests.test_torch_main import CLI_MODEL
from tests.test_train_trajectory import _jax_trajectory

REL = 1e-9


def _to_f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_forward_matches_jax_x64(name):
    flags = CONFIGS[name]
    batch = jax_batch(4, seed=len(name))
    model, params = jax_model_and_params(flags, batch, False)
    with jax.enable_x64():
        want = np.asarray(jax.jit(model.apply)(_to_f64(params), batch))
    assert want.dtype == np.float64
    port = port_model(flags, params).double()
    step = make_eval_step(port, 'classification')
    got = step(port_batch(batch))
    assert got.dtype == torch.float64
    got = got.numpy()
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_trajectory_matches_jax_x64():
    """5 Adam steps (the trajectory test's batches, optimiser and
    schedule) in float64."""
    flags = CONFIGS['softmax_attention']
    batches = trajectory_batches(3)
    model, params = jax_model_and_params(flags, batches[0], False, seed=4)
    with jax.enable_x64():
        want, _ = _jax_trajectory(model, _to_f64(params), batches,
                                  'classification', steps=5)
    port = port_model(flags, params).double()
    got = port_trajectory(port, batches, 'classification', steps=5)
    assert all(p.dtype == torch.float64 for p in port.parameters())
    want, got = np.asarray(want), np.asarray(got)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


def test_f64_model_is_not_fused(tmp_path):
    kwargs = dict(dim_input=12, k=16, dim_output=1, num_layers=6,
                  edge_attention=True, softmax_attention=True)
    trainer = Trainer('egnn', tmp_path, torch.device('cpu'), double=True,
                      silent=True, **kwargs)
    assert trainer.double and not supports_fusion(trainer.model)
    assert not make_eval_step(trainer.model, 'classification',
                              use_fused=True).fused
    with pytest.raises(ValueError, match='CPU only'):
        Trainer('egnn', tmp_path, torch.device('cuda'), double=True,
                silent=True, **kwargs)


# ------------------------------------------------------------ the CLIs
def _argv(save, device='cpu', epochs=1):
    return (['egnn', str(save), '--train_data_root_pose', str(RESOURCES),
             '--train_types_pose', str(RESOURCES / 'test.types'),
             '--test_data_root_pose', str(RESOURCES), '--test_types_pose',
             str(RESOURCES / 'test.types'), '-b', '2', '-ep', str(epochs),
             '--double', '--device', device] + CLI_MODEL)


@pytest.fixture(scope='module')
def double_run(tmp_path_factory):
    run = tmp_path_factory.mktemp('double') / 'run'
    return run, port_main(_argv(run))


def test_cli_trains_and_reloads_in_f64(double_run):
    run, trainer = double_run
    assert trainer.double
    assert yaml.safe_load((run / 'cmd_args.yaml').read_text())['double']
    ckpt = torch.load(run / 'checkpoints' / 'pose_ckpt_epoch_1.pt',
                      weights_only=True)
    floats = [v for v in ckpt['model_state_dict'].values()
              if v.is_floating_point()]
    assert floats and all(v.dtype == torch.float64 for v in floats)
    moments = [t for s in ckpt['optimiser_state_dict']['state'].values()
               for t in s.values() if torch.is_tensor(t) and t.dim()]
    assert moments and all(t.dtype == torch.float64 for t in moments)
    reloaded, _, _ = load_model(run, torch.device('cpu'))
    assert all(p.dtype == torch.float64
               for p in reloaded.model.parameters())
    for key, value in reloaded.model.state_dict().items():
        assert torch.equal(value, ckpt['model_state_dict'][key]), key


def test_serving_cli_scores_a_double_run(double_run):
    run, trainer = double_run
    served = inference.main([str(run), str(RESOURCES / 'test.types'),
                             str(RESOURCES), '--device', 'cpu',
                             '--output_fname', 'served.txt'])
    assert all(p.dtype == torch.float64 for p in served.model.parameters())
    np.testing.assert_array_equal(served.val_scores, trainer.val_scores)
    assert (run / 'pose_served.txt').read_text() == (
        run / 'pose_predictions.txt').read_text()


def test_resume_continues_a_double_run(double_run, tmp_path):
    import shutil
    run = tmp_path / 'run'
    shutil.copytree(double_run[0], run)
    args = yaml.safe_load((run / 'cmd_args.yaml').read_text())
    args['epochs_pose'] = 2
    (run / 'cmd_args.yaml').write_text(yaml.dump(args))
    trainer = resume_main([str(run), '--device', 'cpu'])
    assert trainer.p_epoch == 2 and trainer.double
    ckpt = torch.load(run / 'checkpoints' / 'pose_ckpt_epoch_2.pt',
                      weights_only=True)
    assert all(v.dtype == torch.float64
               for v in ckpt['model_state_dict'].values()
               if v.is_floating_point())


def _no_cuda_work(monkeypatch):
    """Any CUDA call fails the test: the gates must come first."""
    def refuse(*_, **__):
        raise AssertionError('CUDA was touched before the --double gate')
    monkeypatch.setattr(torch.cuda, 'is_available', refuse)


@pytest.mark.parametrize('entry', ['main', 'inference', 'resume_training'])
def test_double_on_cuda_exits_naming_device_cpu(entry, double_run, tmp_path,
                                                monkeypatch):
    _no_cuda_work(monkeypatch)
    run = tmp_path / 'cuda_run'
    argv = {
        'main': lambda: port_main(_argv(run, device='cuda')),
        'inference': lambda: inference.main(
            [str(double_run[0]), str(RESOURCES / 'test.types'),
             str(RESOURCES)]),
        'resume_training': lambda: resume_main([str(double_run[0])]),
    }[entry]
    with pytest.raises(SystemExit, match='--device cpu'):
        argv()
    assert not run.exists()


def test_cast_floats_is_exact():
    batch = port_batch(jax_batch(2, seed=1))
    cast = cast_floats(batch, torch.float64)
    for a, b in zip(batch, cast):
        if torch.is_tensor(a) and a.is_floating_point():
            assert b.dtype == torch.float64
            assert torch.equal(b.float(), a)
        else:
            assert b is a
