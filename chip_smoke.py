#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pointvs_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA GPU, ``nvcc`` and the repository's own files; it exits
non-zero (and prints no result) when any of them is missing or any phase
fails.

Phases:
1. device: the card's name and power limit, torch and CUDA versions;
2. build: both CUDA kernels from ``pointvs_tpu_torch/ops/csrc``, one nvcc
   process per source, all started together;
3. kernels: each kernel (K1 segment_sum_sorted; K2
   softmax_aggregate_sorted in softmax and sigmoid mode) against its plain
   PyTorch version on the card, at a bench shape (N=14336 nodes,
   ~156k edges from a seeded degree distribution) and at edge cases;
   median kernel time by CUDA events with L2 flushed before each launch,
   the plain version's time, one PyTorch library call's time where one
   computes the same function (yardstick only), and the least time the
   card could take (bytes / 3.35 TB/s vs flops / 67 TFLOP/s);
4. serving: 64 poses (seeded rigid perturbations of the test ligand in
   its pocket) scored through ``pointvs_tpu_torch.inference`` at batch 32
   for three models (reference-default flags at 3 layers, the README's
   6-layer softmax-attention model, sigmoid attention at 3 layers). Kernel
   launch counts must equal layers x batches; 64 finite rows must be
   written; scores must match a ``--device cpu`` run within 1e-4.

Then one JSON line describing every kernel, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
RESOURCES = REPO / 'tests' / 'resources'
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
SEED = 0
K1_SOURCE = 'pointvs_tpu_torch/ops/csrc/segment_kernels.cu'
K1_REPLACES = 'pointvs_tpu/ops/pallas/segment_kernels.py:264'
K2_REPLACES = 'pointvs_tpu/ops/pallas/segment_kernels.py:188'
TOL = dict(atol=1e-5, rtol=1e-5)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ----------------------------------------------------------------- 1
def phase_device(torch):
    check(torch.cuda.is_available(), 'torch.cuda.is_available() is False')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f'nvidia-smi failed: {smi.stderr}')
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]} '
          f'device {torch.cuda.get_device_name(0)}')
    return card


# ----------------------------------------------------------------- 2
def phase_build():
    from pointvs_tpu_torch.ops import _build
    start = time.perf_counter()
    seconds = _build.build_all()
    print(f'build: {time.perf_counter() - start:.2f} s wall; per library '
          f'{json.dumps(seconds)}')
    for name in seconds:
        log = _build.library_path(name).with_suffix('.log').read_text()
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')


# ----------------------------------------------------------------- 3
def make_edges(np, rng, n, mean_degree, pad, k, empty_every=0,
               tail_empty=0, ties=False, masked_every=0):
    """Sorted ids (padding = n last) and edge data for one case."""
    deg = rng.poisson(mean_degree, n)
    if empty_every:
        deg[::empty_every] = 0
    if tail_empty:
        deg[n - tail_empty:] = 0
    ids = np.repeat(np.arange(n), deg)
    ids = np.concatenate([ids, np.full(pad, n)]).astype(np.int32)
    e = len(ids)
    logits = (rng.standard_normal(e) * 2).astype(np.float32)
    if ties:
        logits = np.round(logits).astype(np.float32)
    mask = (ids < n).astype(np.float32)
    mask[rng.random(e) < 0.1] = 0.0
    if masked_every:
        mask[(ids % masked_every == 0) & (ids < n)] = 0.0
    return dict(ids=ids, n=n,
                feat=rng.standard_normal((e, k)).astype(np.float32),
                logits=logits,
                trans=rng.standard_normal((e, 3)).astype(np.float32),
                mask=mask)


def time_cuda(torch, fn, flush, reps=25):
    """Median ms of ``fn`` by CUDA events, L2 flushed before each call."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def phase_kernels(torch, np):
    from pointvs_tpu_torch.ops import segment_kernels as sk
    rng = np.random.default_rng(SEED)
    cases = {
        # Bench shape: 32 pocket graphs of ~450 atoms, ~11 edges per atom.
        'bench': make_edges(np, rng, 14336, 10.9, 4000, 40),
        'k13': make_edges(np, rng, 300, 8.0, 200, 13),
        'empty_rows': make_edges(np, rng, 300, 8.0, 50, 16, empty_every=3),
        'padding_tail': make_edges(np, rng, 300, 8.0, 300, 16,
                                   tail_empty=100),
        'ties': make_edges(np, rng, 300, 8.0, 40, 32, ties=True),
        'all_masked_rows': make_edges(np, rng, 300, 8.0, 40, 32,
                                      masked_every=4),
        'small_e': make_edges(np, rng, 40, 6.0, 30, 32),   # E < 4 * 128
    }
    dev = torch.device('cuda')
    err = {'k1': 0.0, 'softmax': 0.0, 'sigmoid': 0.0}
    for name, c in cases.items():
        t = {key: torch.from_numpy(c[key]).to(dev)
             for key in ('ids', 'feat', 'logits', 'trans', 'mask')}
        n = c['n']
        widths = (36, 40) if name == 'bench' else (c['feat'].shape[1],)
        for kw in widths:
            data = t['feat'][:, :kw].contiguous()
            got = sk.windowed_segment_sum(data, t['ids'], n)
            want = sk.windowed_segment_sum_plain(data, t['ids'], n)
            torch.cuda.synchronize()
            check(torch.allclose(got, want, **TOL),
                  f'K1 disagrees with plain on {name} K={kw}')
            err['k1'] = max(err['k1'], (got - want).abs().max().item())
        feat = t['feat'][:, :32].contiguous() if name == 'bench' \
            else t['feat']
        for mode in ('softmax', 'sigmoid'):
            args = (feat, t['logits'], t['trans'], t['mask'], t['ids'], n)
            out, seg_max = sk.fused_softmax_aggregate(*args, mode)
            w_out, w_max = sk.fused_softmax_aggregate_plain(*args, mode)
            torch.cuda.synchronize()
            check(torch.allclose(out, w_out, **TOL)
                  and torch.allclose(seg_max, w_max, **TOL),
                  f'K2 ({mode}) disagrees with plain on {name}')
            err[mode] = max(err[mode], (out - w_out).abs().max().item(),
                            (seg_max - w_max).abs().max().item())
        print(f'kernels: {name} N={n} E={len(c["ids"])} ok')

    # Timing at the bench shape.
    c = cases['bench']
    n = c['n']
    real = int((c['ids'] < n).sum())
    e = len(c['ids'])
    t = {key: torch.from_numpy(c[key]).to(dev)
         for key in ('ids', 'feat', 'logits', 'trans', 'mask')}
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    timings = {}
    for kw in (36, 40):
        data = t['feat'][:, :kw].contiguous()
        ids = t['ids']
        nbytes = real * kw * 4 + real * 4 + n * kw * 4
        timings[f'k1_{kw}'] = dict(
            ms=time_cuda(torch, lambda: sk.windowed_segment_sum(
                data, ids, n), flush),
            plain_ms=time_cuda(torch, lambda: sk.windowed_segment_sum_plain(
                data, ids, n), flush),
            library_ms=time_cuda(torch, lambda: torch.zeros(
                (n + 1, kw), device=dev).index_add_(0, ids, data), flush),
            bound=bound_ms(nbytes, real * kw))
    feat = t['feat'][:, :32].contiguous()
    kf = 32
    for mode in ('softmax', 'sigmoid'):
        args = (feat, t['logits'], t['trans'], t['mask'], t['ids'], n)
        nbytes = real * (kf + 3 + 1 + 1 + 1) * 4 + n * (kf + 7) * 4
        timings[mode] = dict(
            ms=time_cuda(torch, lambda: sk.fused_softmax_aggregate(
                *args, mode), flush),
            plain_ms=time_cuda(torch, lambda: sk.fused_softmax_aggregate_plain(
                *args, mode), flush),
            library_ms=None,
            bound=bound_ms(nbytes, real * (2 * kf + 12)))
    for key, v in timings.items():
        print(f'kernels: {key} N={n} E={e} (real {real}) ms={v["ms"]:.4f} '
              f'plain_ms={v["plain_ms"]:.4f} library_ms={v["library_ms"]} '
              f'bound_ms={v["bound"][0]:.4f} ({v["bound"][1]})')
    return err, timings


# ----------------------------------------------------------------- 4
def _rotation(np, rng, max_deg):
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    theta = np.deg2rad(rng.uniform(0, max_deg))
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def write_pose_set(np, root: Path, n_poses=64):
    """Seeded rigid perturbations of the test ligand in its pocket: the
    first half small (labelled 1), the second half large (labelled 0)."""
    import pyarrow.parquet as pq
    rng = np.random.default_rng(SEED + 1)
    lig = pq.read_table(RESOURCES / 'lig_0.parquet')
    root.mkdir(parents=True)
    (root / 'rec_0.parquet').write_bytes(
        (RESOURCES / 'rec_0.parquet').read_bytes())
    xyz = np.stack([lig.column(c).to_numpy() for c in 'xyz'], axis=1)
    centre = xyz.mean(axis=0)
    lines = []
    for i in range(n_poses):
        active = i < n_poses // 2
        rot = _rotation(np, rng, 20 if active else 180)
        shift = rng.standard_normal(3) * (0.5 if active else 2.0)
        new = (xyz - centre) @ rot.T + centre + shift
        rmsd = float(np.sqrt(((new - xyz) ** 2).sum(1).mean()))
        table = lig
        for j, col in enumerate('xyz'):
            table = table.set_column(table.schema.get_field_index(col), col,
                                     [new[:, j]])
        pq.write_table(table, root / f'lig_{i:02d}.parquet')
        lines.append(f'{int(active)} -1 {rmsd:.3f} rec_0.parquet '
                     f'lig_{i:02d}.parquet')
    (root / 'poses.types').write_text('\n'.join(lines) + '\n')
    return root / 'poses.types', n_poses


SERVING = {
    'default_3l': (dict(num_layers=3), 'segment_sum_sorted'),
    'readme_softmax_6l': (dict(num_layers=6, edge_attention=True,
                               softmax_attention=True),
                          'softmax_aggregate_sorted'),
    'sigmoid_3l': (dict(num_layers=3, edge_attention=True),
                   'softmax_aggregate_sorted'),
}


def write_run_dir(torch, run: Path, flags: dict):
    from pointvs_tpu_torch.models.layers import init_parameters
    from pointvs_tpu_torch.models.registry import build_model
    from pointvs_tpu_torch.utils import save_yaml
    model_kwargs = dict(dim_input=12, k=32, dim_output=1, residual=True,
                        normalize=True, tanh=True, graphnorm=True,
                        model_task='classification', **flags)
    model = build_model('egnn', **model_kwargs)
    init_parameters(model, torch.Generator().manual_seed(SEED))
    (run / 'checkpoints').mkdir(parents=True)
    torch.save({'model_state_dict': model.state_dict(), 'p_epoch': 0,
                'a_epoch': 0}, run / 'checkpoints' / 'pose_ckpt_epoch_0.pt')
    save_yaml(model_kwargs, run / 'model_kwargs.yaml')
    save_yaml({'model': 'egnn', 'batch_size': 32, 'radius': 10,
               'edge_radius': 4.0, 'compact': True,
               'egnn_attention': flags.get('edge_attention', False)},
              run / 'cmd_args.yaml')


def forward_profile(torch, trainer, loader):
    """Device time of one batch's forward: the median over repeats by CUDA
    events (batches prepared and moved first), and one profiled forward's
    kernel time by name. Also the batches' (real N, N_pad, real E, E_pad).
    """
    from torch.profiler import ProfilerActivity, profile

    from pointvs_tpu_torch.data.buckets import to_device
    batches = [to_device(b, trainer.device) for b, _ in loader]
    sizes = [(int(b.node_mask.sum()), b.node_feats.shape[0],
              int(b.edge_mask.sum()), b.senders.shape[0]) for b in batches]
    times = []
    with torch.no_grad():
        for _ in range(5):
            for b in batches:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                trainer.model(b)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.model(batches[0])
            torch.cuda.synchronize()
    by_name = {evt.key: evt.self_device_time_total / 1e3
               for evt in prof.key_averages()
               if evt.self_device_time_total > 0}
    return statistics.median(times[len(batches):]), sizes, by_name


def phase_serving(torch, np):
    from pointvs_tpu_torch import inference
    from pointvs_tpu_torch.ops import segment_kernels as sk
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        types, n_poses = write_pose_set(np, root / 'data')
        batches = -(-n_poses // 32)
        for name, (flags, kernel) in SERVING.items():
            run = root / name
            write_run_dir(torch, run, flags)
            args = [str(run), str(types), str(root / 'data'),
                    '--batch_size', '32']
            sk.reset_launch_counts()
            start = time.perf_counter()
            trainer = inference.main(args + ['--output_fname', 'gpu.txt'])
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            counts = sk.launch_counts()
            expect = flags['num_layers'] * batches
            check(counts[kernel] == expect,
                  f'{name}: {kernel} launched {counts[kernel]} times, '
                  f'expected {expect}')
            for other, count in counts.items():
                check(other == kernel or count == 0,
                      f'{name}: unexpected {other} launches ({count})')
            rows = (run / 'pose_gpu.txt').read_text().splitlines()
            gpu = trainer.val_scores
            check(len(rows) == n_poses and len(gpu) == n_poses
                  and np.isfinite(gpu).all(),
                  f'{name}: expected {n_poses} finite rows, got {len(rows)}')
            cpu = inference.main(args + ['--output_fname', 'cpu.txt',
                                         '--device', 'cpu']).val_scores
            diff = float(np.abs(gpu - cpu).max())
            check(diff <= 1e-4, f'{name}: GPU and CPU scores differ by '
                                f'{diff}')
            fwd, sizes, by_name = forward_profile(
                torch, *inference.get_model_and_test_dl(
                    str(run), str(types), str(root / 'data'),
                    trainer.device, batch_size=32))
            launches[name] = counts[kernel]
            print(f'serving: {name} poses={n_poses} wall={wall:.3f} s '
                  f'poses_per_s={n_poses / wall:.1f} '
                  f'forward_ms_per_batch={fwd:.3f} launches={counts} '
                  f'max|gpu-cpu|={diff:.2e} batch sizes (real N, N_pad, '
                  f'real E, E_pad)={sizes}')
            busy = sum(by_name.values())
            ours = sum(v for k, v in by_name.items() if 'sorted_kernel' in k)
            print(f'profile: {name} one forward: kernels {busy:.3f} ms '
                  f'device time ({len(by_name)} kernel names), of which the '
                  f'segment kernels {ours:.3f} ms; top 8:')
            for key, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
                print(f'  {ms:8.3f} ms  {key[:110]}')
    return launches


def main() -> int:
    try:
        import numpy as np
        import torch
        card = phase_device(torch)
        check((RESOURCES / 'lig_0.parquet').exists(),
              f'{RESOURCES} is missing: run from a checkout of the repo')
        phase_build()
        err, timings = phase_kernels(torch, np)
        launches = phase_serving(torch, np)
    except Exception:  # any phase failing fails the run, with its trace
        traceback.print_exc()
        print('chip_smoke: FAILED', file=sys.stderr)
        return 1

    def entry(name, replaces, launch_key, err_key, timing_key):
        v = timings[timing_key]
        return {'name': name, 'route': 'cuda', 'source': K1_SOURCE,
                'replaces': replaces, 'launches': launches[launch_key],
                'max_abs_err': err[err_key], 'ms': v['ms'],
                'plain_ms': v['plain_ms'], 'bound_ms': v['bound'][0],
                'bound_by': v['bound'][1], 'library_ms': v['library_ms']}

    kernels = [
        entry('segment_sum_sorted', K1_REPLACES, 'default_3l', 'k1',
              'k1_36'),
        entry('softmax_aggregate_sorted[softmax]', K2_REPLACES,
              'readme_softmax_6l', 'softmax', 'softmax'),
        entry('softmax_aggregate_sorted[sigmoid]', K2_REPLACES,
              'sigmoid_3l', 'sigmoid', 'sigmoid'),
    ]
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
