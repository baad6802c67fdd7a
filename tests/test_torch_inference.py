"""Both packages' ``inference`` CLIs on one reference-style run directory.

A ``.pt`` checkpoint plus ``model_kwargs.yaml`` / ``cmd_args.yaml``
sidecars (the layout of tests/test_torch_import.py) holds weights of the
JAX model's shapes. ``pointvs_tpu.inference`` and
``pointvs_tpu_torch.inference --device cpu`` must write the same rows in
the same order, probabilities within 2e-3 (the file prints 3 decimals),
given the same ``--num_devices 1``; ``--num_devices 2`` is refused as a
missing feature. Also: the port's entry point refuses to run without CUDA unless asked for
the CPU, and the port imports nothing of JAX or of the JAX package.
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pointvs_tpu.utils import save_yaml
from pointvs_tpu_torch.models.params import state_dict_from_flax
from tests.setup_and_params import ORIGINAL_GRAPH, RESOURCES
from tests.test_torch_egnn import DIM_IN, K, jax_model_and_params

FLAGS = dict(residual=True, normalize=True, tanh=True, graphnorm=True,
             edge_attention=True, softmax_attention=True)
PORT_DIR = Path(__file__).resolve().parents[1] / 'pointvs_tpu_torch'


@pytest.fixture
def run_dir(tmp_path):
    _, params = jax_model_and_params(FLAGS, ORIGINAL_GRAPH, False, seed=4)
    run = tmp_path / 'run'
    (run / 'checkpoints').mkdir(parents=True)
    torch.save({'model_state_dict': state_dict_from_flax(params),
                'p_epoch': 3, 'a_epoch': 0},
               run / 'checkpoints' / 'pose_ckpt_epoch_3.pt')
    save_yaml({'dim_input': DIM_IN, 'k': K, 'dim_output': 1,
               'num_layers': 3, 'act': 'silu', 'dropout': 0.0,
               'model_task': 'classification', 'bf16': False,
               'remat': False, 'scan_layers': False, **FLAGS},
              run / 'model_kwargs.yaml')
    save_yaml({'model': 'egnn', 'batch_size': 2, 'radius': 4,
               'edge_radius': 4, 'estimate_bonds': True, 'compact': True,
               'egnn_attention': True}, run / 'cmd_args.yaml')
    return run


def _rows(path):
    rows = [line.split() for line in path.read_text().splitlines()]
    assert rows
    return rows


def test_cli_predictions_match_jax(run_dir):
    from pointvs_tpu.inference import main as jax_main
    from pointvs_tpu_torch.inference import main as port_main

    args = [str(run_dir), str(RESOURCES / 'test.types'), str(RESOURCES),
            '--num_devices', '1']
    jax_main(args + ['--output_fname', 'jax.txt'])
    trainer = port_main(args + ['--output_fname', 'port.txt', '--device',
                                'cpu', '--top1'])
    want, got = _rows(run_dir / 'pose_jax.txt'), _rows(
        run_dir / 'pose_port.txt')
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == '|' and g[3:] == w[3:]
        assert abs(float(g[2]) - float(w[2])) <= 2e-3
    np.testing.assert_allclose(trainer.val_scores,
                               [float(r[2]) for r in got], atol=5e-4)
    assert trainer.p_epoch == 3


def test_entry_point_raises_without_cuda(run_dir, monkeypatch):
    from pointvs_tpu_torch.inference import main as port_main
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='--device cpu'):
        port_main([str(run_dir), str(RESOURCES / 'test.types'),
                   str(RESOURCES)])


def test_cli_refuses_more_devices_by_name(run_dir):
    """A reference command line with --num_devices 2 gets past argparse
    and is refused as a missing feature, before anything is loaded."""
    from pointvs_tpu_torch.inference import main as port_main
    with pytest.raises(NotImplementedError, match=r'ROADMAP\.md'):
        port_main([str(run_dir), str(RESOURCES / 'test.types'),
                   str(RESOURCES), '--num_devices', '2', '--device', 'cpu'])


def test_orbax_run_dir_is_refused(tmp_path):
    from pointvs_tpu_torch.models.load_model import resolve_run
    (tmp_path / 'checkpoints' / 'pose_ckpt_epoch_1').mkdir(parents=True)
    with pytest.raises(NotImplementedError, match='orbax'):
        resolve_run(tmp_path)


# Modules of the training slice that the walk below must reach.
TRAINING_MODULES = (
    'fused_train', 'inference_engine', 'ops.fused_egnn', 'ops.fused_egnn_bwd',
    'parallel.steps', 'training.checkpoints', 'training.engine',
    'training.losses', 'training.optimisers')


def test_port_imports_no_jax():
    """Importing every port module (no GPU, no nvcc here) loads no JAX and
    nothing of the JAX package."""
    code = (
        'import importlib, pkgutil, sys\n'
        'import pointvs_tpu_torch as p\n'
        'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in\n'
        '             ("jax", "jaxlib", "flax", "optax", "orbax",\n'
        '              "pointvs_tpu"))\n'
        'mods = [m for m in sys.modules\n'
        '        if m.startswith("pointvs_tpu_torch.")]\n'
        'print(len(mods), bad, " ".join(mods))\n'
        'sys.exit(1 if bad else 0)\n')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=PORT_DIR.parent, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count, _, loaded = proc.stdout.split(maxsplit=2)
    assert int(count) >= 30
    loaded = set(loaded.split())
    for name in TRAINING_MODULES:
        assert f'pointvs_tpu_torch.{name}' in loaded, name


def test_port_sources_name_no_jax_module():
    pattern = re.compile(
        r'^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|pointvs_tpu)\b'
        r'(?!_torch)', re.M)
    offenders = [str(p) for p in PORT_DIR.rglob('*.py')
                 if pattern.search(p.read_text())]
    assert not offenders
