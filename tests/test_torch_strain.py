"""``--include_strain_info`` in the port against the JAX package.

A types file's last two fields, where they parse as floats, are the
strain energy dE (capped at 200) and the strain RMSD; the EGNN family
appends each graph's dE to its pooled embedding, so the head reads k + 1
features. Held against JAX:
- the parsed columns, element for element, with the flag on and off;
- the loaders' ``GraphBatch.strain`` (and every other field) in
  validation and over 3 training epochs;
- the forward within 1e-5 for egnn and multitask (both heads) on batches
  whose graphs carry random dE, on the module path and through the fused
  engines (``fused_forward``; ``fused_apply`` in training, K3/K4's plain
  versions on the CPU), against JAX's module and fused paths;
- 20-step loss trajectories within atol 1e-4 / rtol 1e-5 on the module
  and the fused path;
- the CLI (``main egnn --include_strain_info``) from the same weights,
  then both serving CLIs on the port's run, which score with dE = 0 (the
  JAX serving CLI leaves the flag out; the port does as it does), and
  ``resume_training``.
"""
import jax
import numpy as np
import pytest
import torch
import yaml

from pointvs_tpu.data.types_files import \
    parse_classification_types as jax_parse
from pointvs_tpu.models import build_model as build_jax_model
from pointvs_tpu_torch.data.dataset import PointCloudDataset
from pointvs_tpu_torch.data.types_files import parse_classification_types
from pointvs_tpu_torch.fused_train import fused_apply
from pointvs_tpu_torch.inference_engine import fused_forward
from pointvs_tpu_torch.models.registry import build_model
from pointvs_tpu_torch.resume_training import main as resume_main
from tests.setup_and_params import ORIGINAL_GRAPH_TWO_ITEMS, RESOURCES
from tests.test_fused_engine import _pad_nodes
from tests.test_torch_egnn import jax_batch, port_batch
from tests.test_torch_lucid import draw_params, port_from_jax, \
    port_trajectory, trajectory_batches
from tests.test_torch_multitask import _jax_fused_trajectory
from tests.test_torch_siamese import check_clis_agree, epochs, run_clis
from tests.test_torch_train_loader import COMPLEXES, assert_same_batch
from tests.test_train_trajectory import N_BATCHES, _jax_trajectory

K, DIM_IN, LAYERS = 16, 12, 2
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
TRAJ_TOL = dict(atol=1e-4, rtol=1e-5)
BASE = dict(residual=True, normalize=True, tanh=True, graphnorm=True,
            edge_attention=True, softmax_attention=True,
            include_strain_info=True)


def write_strain_types(path, n=8, seed=0):
    """Mixed labels over the two test complexes; most lines carry dE and
    strain RMSD (one dE above the 200 cap), every fifth line none."""
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        line = f'{int(i % 3 == 0)} -1 {0.4 + 0.7 * i:.2f} {COMPLEXES[i % 2]}'
        if i % 5 != 4:
            d_e = 250.0 if i == 1 else rng.uniform(0, 30)
            line += f' {d_e:.3f} {rng.uniform(0, 2):.3f}'
        lines.append(line)
    path.write_text('\n'.join(lines) + '\n')
    return path


@pytest.mark.parametrize('include', [False, True], ids=['off', 'on'])
def test_types_parsing_matches_jax(tmp_path, include):
    types = write_strain_types(tmp_path / 'strain.types')
    got = parse_classification_types(types, include_strain_info=include)
    want = jax_parse(types, include_strain_info=include)
    for field in ('labels', 'rmsds', 'receptors', 'ligands', 'dEs',
                  'strain_rmsds'):
        assert getattr(got, field) == getattr(want, field), field
    if include:
        assert got.dEs[1] == 200.0 and got.dEs[4] is None
    else:
        assert set(got.dEs) == {None}


LOADER = dict(batch_size=3, radius=4, edge_radius=4, estimate_bonds=True,
              polar_hydrogens=False, compact=True, seed=5,
              include_strain_info=True)


@pytest.mark.parametrize('mode', ['val', 'train'])
def test_strain_batches_match_jax(tmp_path, mode):
    from pointvs_tpu.data.loader import get_data_loader as jax_loader
    from pointvs_tpu_torch.data.loader import get_data_loader
    types = write_strain_types(tmp_path / 'strain.types')
    kwargs = dict(LOADER, mode=mode, rot=mode == 'train',
                  p_noise=0.3 if mode == 'train' else -1)
    jax_dl = jax_loader(RESOURCES, types_fname=types, prefetch=0,
                        num_devices=1, **kwargs)
    port_dl = get_data_loader(RESOURCES, types, prefetch=0, **kwargs)
    want, got = epochs(jax_dl, unstack=True), epochs(port_dl)
    assert len(got) == len(want) == 3 * len(port_dl)
    for (g, _), (w, _) in zip(got, want):
        assert_same_batch(g, w)
        np.testing.assert_array_equal(g.strain, w.strain)
    assert any(g.strain[:, 0].max() == 200.0 for g, _ in got)


def test_strain_refuses_augmented_actives(tmp_path):
    types = write_strain_types(tmp_path / 'strain.types')
    with pytest.raises(ValueError, match='augmented'):
        PointCloudDataset(RESOURCES, types, polar_hydrogens=False,
                          include_strain_info=True, augmented_active_count=1)


def with_strain(batch, seed):
    """The batch with a random dE and RMSD per real graph slot."""
    rng = np.random.RandomState(seed)
    strain = rng.uniform(0, 30, (batch.graph_mask.shape[0], 2))
    return batch._replace(strain=(strain * np.asarray(
        batch.graph_mask)[:, None]).astype(np.float32))


def kwargs_of(model, **extra):
    kwargs = dict(dim_input=DIM_IN, k=K, dim_output=1, num_layers=LAYERS,
                  **BASE, **extra)
    if model == 'multitask':
        kwargs.update(node_attention=False, final_softplus=True)
    return kwargs


CASES = {
    'egnn': ('egnn', None),
    'multitask_pose': ('multitask', 'classification'),
    'multitask_affinity': ('multitask', 'regression'),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_forward_matches_jax(case):
    name, task = CASES[case]
    batch = with_strain(jax_batch(3, seed=7), seed=1)
    model = build_jax_model(name, **kwargs_of(name))
    params = draw_params(model, batch, seed=3)
    task_kw = {'task': task} if task else {}
    want = np.asarray(jax.jit(lambda p, b: model.apply(p, b, **task_kw))(
        params, batch))
    port = port_from_jax(name, params, **kwargs_of(name))
    assert port.head_inputs(K) == K + 1
    with torch.no_grad():
        got = port(port_batch(batch), **task_kw).numpy()
        zeroed = port(port_batch(batch._replace(
            strain=np.zeros_like(batch.strain))), **task_kw).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    assert np.abs(got - zeroed).max() > 1e-3   # dE reaches the head


@pytest.mark.parametrize('case', sorted(CASES))
def test_fused_forward_matches_jax(case):
    """``fused_forward`` (K3's plain version here) against JAX's fused
    engine in interpret mode and the module path."""
    from pointvs_tpu.inference_engine import fused_forward as jax_fused
    name, task = CASES[case]
    batch = with_strain(_pad_nodes(ORIGINAL_GRAPH_TWO_ITEMS), seed=2)
    kwargs = kwargs_of(name, node_attention=False)
    model = build_jax_model(name, **kwargs)
    params = draw_params(model, batch, seed=4)
    task_kw = {'task': task} if task else {}
    want = np.asarray(jax_fused(model, params, batch, interpret=True,
                                **task_kw))
    module = np.asarray(model.apply(params, batch, **task_kw))
    port = port_from_jax(name, params, **kwargs)
    got = fused_forward(port, port_batch(batch), **task_kw).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    np.testing.assert_allclose(got, module, **FWD_TOL)
    trained = fused_apply(port, port_batch(batch), **task_kw)
    np.testing.assert_allclose(trained.detach().numpy(), module, **FWD_TOL)


def strain_batches(seed):
    return [with_strain(b, seed + i)
            for i, b in enumerate(trajectory_batches(seed))]


def test_trajectory_matches_jax():
    batches = strain_batches(11)
    model = build_jax_model('egnn', **kwargs_of('egnn'))
    params = draw_params(model, batches[0], seed=6)
    want, _ = _jax_trajectory(model, params, batches, 'classification')
    port = port_from_jax('egnn', params, **kwargs_of('egnn'))
    got = port_trajectory(port, batches, 'classification')
    np.testing.assert_allclose(got, want, **TRAJ_TOL)


def test_fused_trajectory_matches_jax():
    """``fused_apply`` (K3 forward, K4 backward; plain here) with the
    strain input, 20 steps against JAX's fused path."""
    batches = [_pad_nodes(b) for b in strain_batches(13)]
    kwargs = kwargs_of('egnn', node_attention=False)
    model = build_jax_model('egnn', **kwargs)
    params = draw_params(model, batches[0], seed=7)
    want = _jax_fused_trajectory(model, params, batches, 'classification',
                                 20)
    port = port_from_jax('egnn', params, **kwargs)
    got = port_trajectory(port, batches, 'classification', use_fused=True)
    np.testing.assert_allclose(got, want, **TRAJ_TOL)
    assert len(got) == 20 and N_BATCHES == 4


@pytest.fixture(scope='module')
def strain_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('strain_cli')
    train = write_strain_types(root / 'train.types', n=40)
    test = write_strain_types(root / 'test.types', n=4, seed=1)
    flags = ['--include_strain_info', '--egnn_attention',
             '--softmax_attention', '--egnn_residual', '--egnn_normalise',
             '--egnn_tanh', '--graphnorm']
    return (root, test) + run_clis(root, 'egnn', flags, train, test)


def test_cli_matches_jax(strain_runs):
    root, _, jax_trainer, port_trainer = strain_runs
    assert port_trainer.model.include_strain_info
    check_clis_agree(root, jax_trainer, port_trainer)


def jax_serving_scores(run, types, data_root, **kwargs):
    """The scores of the JAX serving CLI's rows (its loader, its
    ``model.apply``), unrounded: sigmoid of the pose logit."""
    from pointvs_tpu.inference import get_model_and_test_dl
    trainer, loader = get_model_and_test_dl(run, types, data_root,
                                            num_devices=1, **kwargs)
    scores = []
    for batch, _ in loader:
        batch = type(batch)(*[None if a is None else np.asarray(a)[0]
                              for a in batch])
        out = np.asarray(trainer.host_model.apply(trainer.params, batch))
        real = np.asarray(batch.graph_mask) > 0
        scores.append(1 / (1 + np.exp(-out[real, 0])))
    return np.concatenate(scores)


def test_cli_serves_with_the_strain_column_and_resumes(strain_runs):
    """The serving CLI builds its loader without the run's strain column
    and scores with dE = 0, as the JAX serving CLI does (ROADMAP.md,
    Queue 3): both CLIs on the port's run directory write the same rows,
    the scores within 1e-5, which differ from the run's own validation
    (read with dE); then ``resume_training`` continues the run."""
    from pointvs_tpu.inference import main as jax_inference
    from pointvs_tpu_torch import inference
    root, test, _, port_trainer = strain_runs
    run = root / 'port'
    args = [str(run), str(test), str(RESOURCES)]
    jax_inference(args + ['--num_devices', '1', '--output_fname',
                          'jax_served.txt'])
    want = jax_serving_scores(run, test, RESOURCES)
    trainer = inference.main(args + ['--device', 'cpu', '--output_fname',
                                     'served.txt'])
    assert trainer.model.include_strain_info
    np.testing.assert_allclose(trainer.val_scores, want, atol=1e-5, rtol=0)
    got_rows = (run / 'pose_served.txt').read_text().splitlines()
    want_rows = (run / 'pose_jax_served.txt').read_text().splitlines()
    assert len(got_rows) == len(want_rows) == 4
    for g, w in zip(got_rows, want_rows):
        g, w = g.split(), w.split()
        assert g[:2] == w[:2] and g[3:] == w[3:]
        assert abs(float(g[2]) - float(w[2])) <= 1.1e-3
    assert np.abs(trainer.val_scores - port_trainer.val_scores).max() > 1e-4
    args = yaml.safe_load((run / 'cmd_args.yaml').read_text())
    args['epochs_pose'] = 2
    (run / 'cmd_args.yaml').write_text(yaml.dump(args))
    resumed = resume_main([str(run), '--device', 'cpu'])
    assert resumed.p_epoch == 2 and np.isfinite(resumed.train_losses).all()
