"""The port's JAX key chain (``ops/prng.py``) and dropout against JAX.

``ops/prng.py`` against ``jax.random`` bit for bit: ``PRNGKey``,
``split``, ``fold_in`` and ``randint`` over several seeds, ``bits``,
``uniform`` and ``bernoulli`` on shapes whose size is not a power of two
(and float64 uniforms under x64);
against flax: the ``make_rng`` key of every lucid dropout site (unscanned
and under ``nn.scan``; the EGNN's edge-dropout key is held in
``tests/test_torch_edge_dropout.py``). The dropout's
plain version equals flax's ``nn.Dropout`` bit for bit. The Trainer's
step keys are the reference's.

The CLI: ``pointvs_tpu_torch.main`` with ``--dropout 0.1`` against the JAX
package's ``main``, both from one ``.pt``, for 20 steps: egnn (the edge
dropout) and lucid (feature dropout; the JAX package's lucid layer made
compact, ``test_torch_lucid.repair_reference_lucid``, since its own
refuses dropout > 0), logged losses and final parameters within atol
1e-4 / rtol 1e-5, with no monkeypatch of JAX. ``resume_training`` of the
egnn runs continues the key chain as the reference's does (its Trainer
restarts at ``PRNGKey(2)``, step 0), and the two resumed runs agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import flax.linen as fnn
from pointvs_tpu.main import main as jax_main
from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu.resume_training import main as jax_resume
from pointvs_tpu_torch.main import main as port_main
from pointvs_tpu_torch.models.params import load_reference_checkpoint, \
    state_dict_from_flax
from pointvs_tpu_torch.ops import prng
from pointvs_tpu_torch.ops.dropout import threefry_dropout
from pointvs_tpu_torch.resume_training import main as port_resume
from tests.setup_and_params import ORIGINAL_GRAPH, RESOURCES
from tests.test_torch_egnn import K as EGNN_K
from tests.test_torch_egnn import LAYERS as EGNN_LAYERS
from tests.test_torch_lucid import DIM_IN, FWD_TOL, K, LAYERS, batch_of, \
    draw_params, port_from_jax, repair_reference_lucid
from tests.test_torch_main import _metrics
from tests.test_torch_train_loader import write_types

TRAJ_TOL = dict(atol=1e-4, rtol=1e-5)
SEEDS = [0, 1, 2, 42, 2 ** 31 - 1]
SHAPES = [(), (7,), (13, 11), (3, 5, 7), (1001,)]


# ------------------------------------------------------ jax.random
@pytest.mark.parametrize('seed', SEEDS)
def test_keys_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    ours = prng.prng_key(seed)
    np.testing.assert_array_equal(ours, np.asarray(key))
    np.testing.assert_array_equal(prng.split(ours, 5),
                                  np.asarray(jax.random.split(key, 5)))
    for data in (0, 1, 7, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(ours, data),
            np.asarray(jax.random.fold_in(key, data)))
    for lo, hi in ((0, 2 ** 31 - 1), (-5, 1000), (3, 4)):
        assert prng.randint_scalar(ours, lo, hi) == int(
            jax.random.randint(key, (), lo, hi))


@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_bits_uniform_bernoulli_match_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    ours = np.asarray(key)
    np.testing.assert_array_equal(prng.random_bits(ours, shape),
                                  np.asarray(jax.random.bits(key, shape)))
    np.testing.assert_array_equal(prng.uniform(ours, shape),
                                  np.asarray(jax.random.uniform(key, shape)))
    for p in (0.9, 0.7, 0.5):
        np.testing.assert_array_equal(
            prng.bernoulli(ours, p, shape),
            np.asarray(jax.random.bernoulli(key, p, shape)))


@pytest.mark.parametrize('shape', [(7,), (13, 11), (5, 3, 7), (999, 37)],
                         ids=str)
def test_dropout_plain_equals_flax(shape):
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    key = prng.step_key(5, 3)
    want = np.asarray(fnn.Dropout(0.1, deterministic=False).apply(
        {}, jnp.asarray(x), rng=jnp.asarray(key)))
    got = threefry_dropout(torch.from_numpy(x), key, 0.1).numpy()
    np.testing.assert_array_equal(got, want)


def test_float64_draws_match_jax_x64():
    """Under x64 (``--double``) JAX draws 52-bit uniforms, and flax's
    Dropout keeps float64 entries by them."""
    x = np.random.RandomState(1).randn(13, 11)
    key = prng.step_key(2, 6)
    with jax.enable_x64(True):
        k = jnp.asarray(key)
        want_u = np.asarray(jax.random.uniform(k, (7, 5), jnp.float64))
        want = np.asarray(fnn.Dropout(0.1, deterministic=False).apply(
            {}, jnp.asarray(x), rng=k))
    np.testing.assert_array_equal(prng.uniform(key, (7, 5), np.float64),
                                  want_u)
    got = threefry_dropout(torch.from_numpy(x), key, 0.1).numpy()
    assert want.dtype == got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_trainer_step_keys_are_the_references():
    """``fold_in(fold_in(split(PRNGKey(seed))[1], step), 0)``, the
    reference Trainer's key folded with the device index."""
    for seed, step in ((2, 0), (2, 19), (7, 5)):
        _, rng = jax.random.split(jax.random.PRNGKey(seed))
        want = jax.random.fold_in(jax.random.fold_in(rng, step), 0)
        np.testing.assert_array_equal(prng.step_key(seed, step),
                                      np.asarray(want))


# ----------------------------------------------------------- flax keys
@pytest.mark.parametrize('scan_layers', [False, True],
                         ids=['layers', 'scan'])
def test_lucid_site_keys_match_flax(scan_layers, monkeypatch):
    """Every lucid dropout site's key, as flax's ``make_rng`` makes it in
    the site's own scope during a training forward."""
    repair_reference_lucid(monkeypatch)
    batch = batch_of('sym')
    model = build_jax_model('lucid', dim_input=DIM_IN, k=K, dim_output=1,
                            num_layers=LAYERS, attention=True, dropout=0.2,
                            scan_layers=scan_layers)
    params = draw_params(model, batch, seed=1)
    key = prng.step_key(2, 4)
    seen = []

    def record(next_fun, args, kwargs, context):
        module = context.module
        if not isinstance(module, fnn.Dropout) or \
                context.method_name != '__call__':
            return next_fun(*args, **kwargs)
        rng = module.make_rng('dropout')   # the call Dropout would make
        jax.debug.callback(
            lambda r, path=module.scope.path: seen.append(
                (path, tuple(np.asarray(r).tolist()))), rng)
        return next_fun(*args, rng=rng, **kwargs)

    with fnn.intercept_methods(record):
        jax.block_until_ready(model.apply(
            params, batch, train=True, rngs={'dropout': jnp.asarray(key)}))
    want = {}
    for layer in range(LAYERS):
        for site, suffix in prng.LUCID_SITES.items():
            scope = (('lucid_scan',) if scan_layers
                     else (f'lucid_layer_{layer}',)) + suffix
            got = prng.lucid_site_key(key, layer, site, LAYERS, scan_layers)
            want.setdefault(scope, set()).add(tuple(got.tolist()))
    recorded = {}
    for path, value in seen:
        recorded.setdefault(tuple(path), set()).add(value)
    assert recorded == want


# ---------------------------------------------------------------- CLI
LUCID_CLI = ['--layers', str(LAYERS), '-k', str(K), '--egnn_attention',
             '--norm_coords', '--norm_feats', '--fourier_features', '2',
             '--graphnorm']
EGNN_CLI = ['--layers', str(EGNN_LAYERS), '-k', str(EGNN_K),
            '--egnn_residual',
            '--egnn_normalise', '--egnn_tanh', '--graphnorm',
            '--egnn_attention', '--softmax_attention']
COMMON = ['--compact', '--radius', '4', '--edge_radius', '4',
          '--estimate_bonds', '--dropout', '0.1', '-b', '2', '-ep', '1',
          '--seed', '5', '--num_devices', '1', '--prefetch', '0',
          '--device_cache', 'off']


def _argv(model, save, types, weights, flags):
    return ([model, str(save), '--train_data_root_pose', str(RESOURCES),
             '--train_types_pose', str(types), '--load_weights',
             str(weights)] + flags + COMMON)


def _lucid_weights(path):
    kwargs = dict(dim_input=12, k=K, dim_output=1, num_layers=LAYERS,
                  attention=True, norm_coords=True, norm_feats=True,
                  fourier_features=2, graphnorm=True)
    params = draw_params(build_jax_model('lucid', **kwargs), ORIGINAL_GRAPH,
                         seed=9)
    torch.save({'model_state_dict':
                port_from_jax('lucid', params, **kwargs).state_dict(),
                'p_epoch': 0, 'a_epoch': 0}, path)


def _egnn_weights(path):
    from tests.test_torch_egnn import jax_model_and_params
    _, params = jax_model_and_params(
        dict(residual=True, normalize=True, tanh=True, graphnorm=True,
             edge_attention=True, softmax_attention=True), ORIGINAL_GRAPH,
        False, seed=6)
    torch.save({'model_state_dict': state_dict_from_flax(params),
                'p_epoch': 0, 'a_epoch': 0}, path)


@pytest.fixture(scope='module')
def dropout_runs(tmp_path_factory):
    """{model: (root, jax_trainer, port_trainer)} of 20-step CLI runs."""
    root = tmp_path_factory.mktemp('dropout_cli')
    types = write_types(root / 'train.types', n=40,
                        labels=lambda i: int(i % 3 == 0))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        repair_reference_lucid(mp)
        for model, flags, weights in (('egnn', EGNN_CLI, _egnn_weights),
                                      ('lucid', LUCID_CLI, _lucid_weights)):
            run = root / model
            run.mkdir()
            weights(run / 'init.pt')
            argv = lambda name: _argv(model, run / name, types,  # noqa
                                      run / 'init.pt', flags)
            jax_trainer = jax_main(argv('jax'))
            port_trainer = port_main(argv('port') + ['--device', 'cpu'])
            runs[model] = (run, jax_trainer, port_trainer, types)
    return runs


def _assert_trajectory(run, jax_trainer, port_trainer, steps=20):
    losses = np.asarray(port_trainer.train_losses)
    assert len(losses) == steps and np.isfinite(losses).all()
    logged = {r['Batch (train, pose)']: r['Loss (train, pose)']
              for r in _metrics(run / 'jax') if 'Loss (train, pose)' in r}
    assert len(logged) >= 2
    for batch, loss in logged.items():
        np.testing.assert_allclose(losses[batch - 1], loss, **TRAJ_TOL)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jax_trainer.params))
    got = port_trainer.model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                   err_msg=key, **TRAJ_TOL)


@pytest.mark.parametrize('model', ['egnn', 'lucid'])
def test_dropout_trajectory_matches_jax(dropout_runs, model):
    run, jax_trainer, port_trainer, _ = dropout_runs[model]
    assert port_trainer.model_kwargs['dropout'] == 0.1
    _assert_trajectory(run, jax_trainer, port_trainer)


def test_resume_continues_the_key_chain(dropout_runs, tmp_path):
    """Both packages' ``resume_training`` continue the egnn dropout run to
    epoch 2 from their own run directories: the resumed steps' losses and
    final parameters agree."""
    import shutil
    run, _, _, _ = dropout_runs['egnn']
    trainers = {}
    for name, resume, extra in (('jax', jax_resume, ['--num_devices', '1']),
                                ('port', port_resume, ['--device', 'cpu'])):
        copy = tmp_path / name
        shutil.copytree(run / name, copy)
        args = yaml.safe_load((copy / 'cmd_args.yaml').read_text())
        args['epochs_pose'] = 2
        (copy / 'cmd_args.yaml').write_text(yaml.dump(args))
        trainers[name] = resume([str(copy)] + extra)
    assert trainers['port'].p_epoch == trainers['jax'].p_epoch == 2
    assert len(trainers['port'].train_losses) == 20
    _, meta = load_reference_checkpoint(
        tmp_path / 'port' / 'checkpoints' / 'pose_ckpt_epoch_2.pt')
    assert meta['p_epoch'] == 2
    logged = [r['Loss (train, pose)'] for r in _metrics(tmp_path / 'jax')
              if 'Loss (train, pose)' in r]
    losses = trainers['port'].train_losses
    np.testing.assert_allclose([losses[0], losses[10]], logged[-2:],
                               **TRAJ_TOL)
    want = state_dict_from_flax(jax.tree.map(np.asarray,
                                             trainers['jax'].params))
    got = trainers['port'].model.state_dict()
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                   err_msg=key, **TRAJ_TOL)
