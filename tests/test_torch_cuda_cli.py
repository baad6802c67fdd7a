"""The training CLI on the GPU against the same command on the CPU.

Needs a CUDA GPU and nvcc; without a GPU the test skips (inside its
fixture). It imports no JAX, so it runs as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_cli.py``.
A small model (3 layers, k=16, softmax attention, edge dropout 0.1) trains
for 2 epochs at batch 2 on a 12-line types file over the test complexes
with mixed labels (weighted sampling) and one augmented copy of each
active; the GPU run's per-step losses must be within the trajectory gate
(atol 1e-4, rtol 1e-5) of the CPU run's, and its launches must show K2
in every layer of every step. The siamese, dense (``lie_conv``) and
strain-input CLIs run the same way at 2 layers, 4 steps. ``--bf16``
runs the first test's command (without dropout and augmentation) on the
card and on the CPU: per-step losses within ``BF16_GATE`` 1e-2 relative
(the two devices' bf16 GEMMs both accumulate in f32, in different orders,
so a product can round to the next bf16 value), K2 in every layer of
every step in f32 and no K3/K4. ``--double`` on the card exits naming
``--device cpu`` and leaves no run directory.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from pointvs_tpu_torch.main import main as train_main
from pointvs_tpu_torch.ops import segment_kernels as sk

RESOURCES = Path(__file__).parent / 'resources'
LAYERS = 3
BF16_GATE = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    return torch.device('cuda')


def _argv(run, types, device):
    return ['egnn', str(run), '--train_data_root_pose', str(RESOURCES),
            '--train_types_pose', str(types), '--layers', str(LAYERS), '-k',
            '16', '--egnn_attention', '--softmax_attention',
            '--egnn_residual', '--egnn_normalise', '--egnn_tanh',
            '--graphnorm', '--compact', '-b', '2', '-ep', '2', '--radius',
            '4', '--estimate_bonds', '--augmented_actives', '1', '--dropout',
            '0.1', '--device', device]


@pytest.mark.cuda
def test_cli_on_the_gpu_matches_the_cpu(tmp_path, cuda_device):
    del cuda_device
    pairs = ('rec_0.parquet lig_0.parquet', 'rec.parquet lig.parquet')
    types = tmp_path / 'train.types'
    types.write_text(''.join(f'{int(i % 3 == 0)} -1 {0.5 + i:.1f} '
                             f'{pairs[i % 2]}\n' for i in range(12)))
    sk.reset_launch_counts()
    gpu = train_main(_argv(tmp_path / 'gpu', types, 'cuda'))
    counts = sk.launch_counts()
    cpu = train_main(_argv(tmp_path / 'cpu', types, 'cpu'))
    steps = len(gpu.train_losses)
    assert steps == 2 * 8   # 12 items + 4 augmented, batch 2, 2 epochs
    assert counts['softmax_aggregate_sorted'] == LAYERS * steps
    assert counts['segment_sum_sorted'] >= LAYERS * steps
    np.testing.assert_allclose(gpu.train_losses, cpu.train_losses,
                               atol=1e-4, rtol=1e-5)


# The siamese and dense families and the strain input: each CLI run on
# the card against the same command on the CPU, within the trajectory
# gate; the scores of the final validation within 1e-4.
FAMILIES = {
    'siamese': ('siamese', ['--egnn_attention', '--softmax_attention']),
    'lie_conv': ('lie_conv', ['--egnn_normalise', '--egnn_residual']),
    'strain': ('egnn', ['--include_strain_info', '--egnn_attention',
                        '--softmax_attention']),
}


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_family_cli_on_the_gpu_matches_the_cpu(tmp_path, cuda_device, name):
    del cuda_device
    model, flags = FAMILIES[name]
    pairs = ('rec_0.parquet lig_0.parquet', 'rec.parquet lig.parquet')
    types = tmp_path / 'train.types'
    types.write_text(''.join(f'{int(i % 3 == 0)} -1 {0.5 + i:.1f} '
                             f'{pairs[i % 2]} {1.5 * i:.2f} 0.3\n'
                             for i in range(8)))
    runs = {}
    for device in ('cuda', 'cpu'):
        argv = [model, str(tmp_path / device), '--train_data_root_pose',
                str(RESOURCES), '--train_types_pose', str(types),
                '--test_data_root_pose', str(RESOURCES), '--test_types_pose',
                str(types), '--layers', '2', '-k', '16', '--compact', '-b',
                '2', '-ep', '1', '--radius', '4', '--estimate_bonds',
                '--device', device] + flags
        runs[device] = train_main(argv)
    gpu, cpu = runs['cuda'], runs['cpu']
    assert len(gpu.train_losses) == 4
    np.testing.assert_allclose(gpu.train_losses, cpu.train_losses,
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(gpu.val_scores, cpu.val_scores, atol=1e-4)


@pytest.mark.cuda
def test_bf16_cli_on_the_gpu_matches_the_cpu(tmp_path, cuda_device):
    del cuda_device
    pairs = ('rec_0.parquet lig_0.parquet', 'rec.parquet lig.parquet')
    types = tmp_path / 'train.types'
    types.write_text(''.join(f'{int(i % 3 == 0)} -1 {0.5 + i:.1f} '
                             f'{pairs[i % 2]}\n' for i in range(12)))
    runs = {}
    for device in ('cuda', 'cpu'):
        argv = [a for a in _argv(tmp_path / device, types, device)
                if a not in ('--augmented_actives', '1', '--dropout', '0.1')]
        sk.reset_launch_counts()
        runs[device] = train_main(argv + ['--bf16'])
        if device == 'cuda':
            counts = sk.launch_counts()
    gpu, cpu = runs['cuda'], runs['cpu']
    steps = len(gpu.train_losses)
    assert gpu.model.bf16 and steps == 2 * 6
    assert counts['softmax_aggregate_sorted'] == LAYERS * steps
    assert counts['fused_edge_forward'] == counts['fused_edge_backward'] == 0
    assert all(p.dtype == torch.float32 for p in gpu.model.parameters())
    got, want = np.asarray(gpu.train_losses), np.asarray(cpu.train_losses)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= BF16_GATE * np.abs(want)).all()


@pytest.mark.cuda
def test_double_on_the_gpu_exits_naming_device_cpu(tmp_path, cuda_device):
    del cuda_device
    run = tmp_path / 'run'
    with pytest.raises(SystemExit, match='--device cpu'):
        train_main(_argv(run, RESOURCES / 'test.types', 'cuda')
                   + ['--double'])
    assert not run.exists()


@pytest.mark.cuda
def test_scale_out_cli_on_the_gpu_matches_one_device(tmp_path, cuda_device):
    """``--num_devices 2`` (2 ranks sharing the card over gloo) and
    ``--num_devices 2 --graph_shard 2`` against one device, strict
    GraphNorm, no dropout: per-step losses within the trajectory gate,
    validation scores within 5e-4; K2 in every layer on the dp ranks, K1
    and never K2 on the edge-shard ranks."""
    del cuda_device
    pairs = ('rec_0.parquet lig_0.parquet', 'rec.parquet lig.parquet')
    types = tmp_path / 'train.types'
    types.write_text(''.join(f'{int(i % 3 == 0)} -1 {0.5 + i:.1f} '
                             f'{pairs[i % 2]}\n' for i in range(8)))

    def argv(name, extra):
        return (_argv(tmp_path / name, types, 'cuda')
                + ['--dropout', '0', '--strict_graphnorm', '-ep', '1',
                   '--test_data_root_pose', str(RESOURCES),
                   '--test_types_pose', str(types)] + extra)

    one = train_main(argv('one', ['--num_devices', '1']))
    dp = train_main(argv('dp', ['--num_devices', '2']))
    gs = train_main(argv('gs', ['--num_devices', '2', '--graph_shard', '2']))
    for reports in (dp, gs):
        for r in reports:
            np.testing.assert_allclose(r['train_losses'], one.train_losses,
                                       atol=1e-4, rtol=1e-5)
            np.testing.assert_allclose(r['val_scores'], one.val_scores,
                                       atol=5e-4)
    steps = len(one.train_losses)
    for r in dp:
        assert r['launch_counts']['softmax_aggregate_sorted'] >= \
            LAYERS * steps
    for r in gs:
        assert r['launch_counts']['softmax_aggregate_sorted'] == 0
        assert r['launch_counts']['segment_sum_sorted'] >= LAYERS * steps
