#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pointvs_tpu_torch) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA GPU, ``nvcc`` and the repository's own files; it exits
non-zero (and prints no result) when any of them is missing or any phase
fails.

Phases:
1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source in ``pointvs_tpu_torch/ops/csrc``, one nvcc
   process per source, all started together (ptxas register and spill
   lines are printed);
3. kernels: K1 segment_sum_sorted and K2 softmax_aggregate_sorted (softmax
   and sigmoid mode) against their plain PyTorch versions on the card, at
   a bench shape (N=14336 nodes, ~156k edges from a seeded degree
   distribution) and at edge cases;
4. fused kernels: K3 fused_edge_forward and K4 fused_edge_backward against
   their plain versions at the bench shape (N=14336, ~160k real of 218,624
   edges, K=32) and at edge cases (every attention mode with the edge
   residual on and off, empty and fully masked senders, a padding tail,
   E < 128, one block of senders, K=16, and the tile cases from
   ``tests/test_torch_cuda_kernels.tile_stress_case``: a 350-edge hub
   sender, senders of exactly 64 and 65 edges, tiles straddling senders and
   blocks, a tile of NaN canaries, blocks without edges, K=20 and K=13);
   K3 and K4 run twice must give identical bits. K3's and K4's registers,
   spills, shared memory and resident blocks per SM, and their worst
   |kernel - plain| / (atol + rtol |plain|) over every case (the gate
   fails above 1). For every kernel:
   median time by CUDA events with L2 flushed before each launch, the
   plain version's time, one PyTorch library call's time where one
   computes the same function (yardstick only), and the least time the
   card could take (bytes / 3.35 TB/s vs flops / 67 TFLOP/s f32; for K3
   and K4, whose products run on tensor cores in 3xTF32, also 3 x their
   product flops / 495 TFLOP/s TF32, the bound the JSON line carries);
5. serving: 64 poses (seeded rigid perturbations of the test ligand in
   its pocket) scored at batch 32 through ``pointvs_tpu_torch.inference``
   for three models (reference-default flags at 3 layers, the README's
   6-layer softmax-attention model, sigmoid attention at 3 layers), and
   the 6-layer model once more through ``make_eval_step(use_fused=True)``
   (K3 in every layer). Kernel launch counts must equal layers x batches;
   64 finite rows must be written; scores must match a ``--device cpu``
   run (and the fused scores the module path's) within 1e-4; one profiled
   forward's kernel time, K3's per launch;
6. training: the ``Trainer`` takes 5 steps on the README 6-layer model
   (k=32, batch 32) on the module path (K1/K2 forward and backward) and on
   the fused path (K3 forward, K4 backward). Launch counts per path; each
   loss trajectory against a CPU run, and the two paths against each
   other, within atol 1e-4 / rtol 1e-5; two identical fused backward
   passes give identical parameter gradients; the saved checkpoint reloads
   to the same scores; step time by CUDA events and each path's profiled
   kernel share, K3's and K4's per launch.

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
TF32_FLOPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
SEED = 0
K1_SOURCE = 'pointvs_tpu_torch/ops/csrc/segment_kernels.cu'
K1_REPLACES = 'pointvs_tpu/ops/pallas/segment_kernels.py:264'
K2_REPLACES = 'pointvs_tpu/ops/pallas/segment_kernels.py:188'
K3_SOURCE = 'pointvs_tpu_torch/ops/csrc/fused_egnn.cu'
K3_REPLACES = 'pointvs_tpu/ops/pallas/fused_egnn.py:205'
K4_SOURCE = 'pointvs_tpu_torch/ops/csrc/fused_egnn_bwd.cu'
K4_REPLACES = 'pointvs_tpu/ops/pallas/fused_egnn_bwd.py:260'
TOL = dict(atol=1e-5, rtol=1e-5)
TRAJ_TOL = dict(atol=1e-4, rtol=1e-5)   # the JAX suite's trajectory gate


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


def bound_ms(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
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
MODES = ('none', 'sigmoid', 'tanh', 'relu', 'silu', 'softmax')


def make_edge_pass(np, rng, n, k, mean_degree, pad, residual, holes=True):
    """Edge-major inputs and cotangents of one fused edge pass: sorted
    senders with a padding tail (sender == n); with ``holes``, empty and
    fully masked senders; 5% masked edges; NaN canaries in ``prev`` where
    the mask is 0."""
    deg = rng.poisson(mean_degree, n)
    if holes:
        deg[::9] = 0
        deg[n - n // 10:] = 0
    senders = np.repeat(np.arange(n), deg)
    senders = np.concatenate([senders, np.full(pad, n)]).astype(np.int32)
    e = len(senders)
    mask = (senders < n).astype(np.float32)
    mask[rng.random(e) < 0.05] = 0.0
    if holes:
        mask[(senders % 13 == 5) & (senders < n)] = 0.0
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    attr = np.eye(3)[rng.integers(0, 3, e)]
    case = dict(
        h=f32(rng.standard_normal((n, k))),
        h_dst=f32(rng.standard_normal((e, k))),
        extras=f32(np.concatenate([rng.random((e, 1)) * 16, attr], 1)),
        mask=mask, senders=senders,
        prev=f32(np.where(mask[:, None] > 0,
                          rng.standard_normal((e, k)), np.nan))
        if residual else None)
    scale = lambda fan: 1 / np.sqrt(fan)  # noqa: E731
    params = dict(
        w1=rng.uniform(-1, 1, (k, 2 * k + 4)) * scale(2 * k + 4),
        b1=rng.uniform(-0.3, 0.3, k), w2=rng.uniform(-1, 1, (k, k)) * scale(k),
        b2=rng.uniform(-0.3, 0.3, k),
        cw1=rng.uniform(-1, 1, (k, k)) * scale(k),
        cb1=rng.uniform(-0.3, 0.3, k), cw2=rng.uniform(-1, 1, k) * scale(k),
        attw=rng.uniform(-1, 1, k) * scale(k),
        attb=rng.uniform(-0.3, 0.3, 1))
    case['params'] = {name: f32(v) for name, v in params.items()}
    cot = dict(d_agg=f32(rng.standard_normal((n, k)) * 0.1),
               d_phi=f32(rng.standard_normal(e)),
               d_att=f32(rng.standard_normal(e)),
               d_msg=f32(rng.standard_normal((e, k)) * 0.1)
               if residual else None)
    return case, cot


def gate_ratio(got, want, atol=TOL['atol'], rtol=TOL['rtol']):
    """Worst |got - want| / (atol + rtol |want|): allclose holds at <= 1."""
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def _to(torch, dev, tree):
    move = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa
    return {key: ({p: move(a) for p, a in v.items()} if isinstance(v, dict)
                  else move(v)) for key, v in tree.items()}


def k3_work(real, e, n, k, residual):
    """(bytes, flops, product flops) of one K3 call: inputs read once,
    outputs written once, the edge and coordinate MLPs of every real edge;
    the product flops are those K3 runs on tensor cores."""
    nbytes = 4 * (n * k + real * (k + 5) + e + (real * k if residual else 0)
                  + n * k + e * (k + 2))
    products = real * 2 * (k * (2 * k + 4) + 2 * k * k)
    return nbytes, products + real * 8 * k, products


def k4_work(real, e, n, k, residual):
    """(bytes, flops, product flops) of one K4 call: the recomputed forward
    plus, for each of the three weight matrices, an outer product and a
    transposed product; the product flops are those K4 runs on tensor
    cores."""
    nbytes = 4 * (2 * n * k + real * (k + 7) + e
                  + (3 * real * k if residual else 0) + e * (2 * k + 1))
    products = 3 * real * 2 * (k * (2 * k + 4) + 2 * k * k)
    return nbytes, products + real * 24 * k, products


def phase_fused_kernels(torch, np):
    from pointvs_tpu_torch.ops import fused_egnn as k3
    from pointvs_tpu_torch.ops import fused_egnn_bwd as k4
    from tests.test_torch_cuda_kernels import TILE_STRESS, tile_stress_case
    rng = np.random.default_rng(SEED + 2)
    dev = torch.device('cuda')
    # (name, n, k, mean degree, padding edges, attention, residual, tanh,
    #  holes); the bench shape is the main path's: the README 6-layer
    # softmax model at batch 32 (N_pad 14336, E_pad 218,624; PERF.md).
    cases = [('bench', 14336, 32, 11.2, 57960, 'softmax', False, True,
              False)]
    cases += [(f'{mode}_res{int(res)}', 2000, 32, 8.0, 300, mode, res,
               mode in ('softmax', 'relu'), True)
              for mode in MODES for res in (False, True)]
    cases += [('k16', 500, 16, 6.0, 60, 'softmax', True, True, True),
              ('small_e', 20, 32, 3.0, 9, 'softmax', True, True, True),
              ('one_block', 32, 32, 10.0, 20, 'sigmoid', False, False,
               True)]
    cases += [(name,) for name in TILE_STRESS]
    err = {'k3': 0.0, 'k4': 0.0}
    ratio = {'k3': (0.0, ''), 'k4': (0.0, '')}   # (worst gate ratio, where)

    def note(key, value, where):
        if value > ratio[key][0]:
            ratio[key] = (value, where)

    bench = None
    for name, *spec in cases:
        if spec:
            n, k, deg, pad, mode, res, tanh, holes = spec
            case, cot = make_edge_pass(np, rng, n, k, deg, pad, res, holes)
        else:
            case, cot, mode, res, tanh = tile_stress_case(name)
            n, k = case['h'].shape
        c, d = _to(torch, dev, case), _to(torch, dev, cot)
        args = (c['h'], c['h_dst'], c['extras'], c['mask'], c['senders'],
                c['prev'], c['params'])
        got = k3.fused_edge_forward(*args, mode, tanh)
        want = k3.fused_edge_forward_plain(*args, mode, tanh)
        again = k3.fused_edge_forward(*args, mode, tanh)
        torch.cuda.synchronize()
        for out, g, w, a in zip(('agg', 'phi', 'att', 'msg'), got, want,
                                again):
            check(torch.allclose(g, w, **TOL),
                  f'K3 {out} disagrees with plain on {name}')
            check(torch.equal(g, a), f'K3 {out} not deterministic on {name}')
            err['k3'] = max(err['k3'], (g - w).abs().max().item())
            note('k3', gate_ratio(g, w), f'{name} {out}')
        cots = (d['d_agg'], d['d_phi'], d['d_att'], d['d_msg'])
        got = k4.fused_edge_backward(*args, *cots, mode, tanh)
        want = k4.fused_edge_backward_plain(*args, *cots, mode, tanh)
        again = k4.fused_edge_backward(*args, *cots, mode, tanh)
        torch.cuda.synchronize()
        for out, g, w, a in zip(('d_h_src', 'd_h_dst', 'd_radial', 'd_prev'),
                                got[:4], want[:4], again[:4]):
            if w is None:
                continue
            check(torch.allclose(g, w, **TOL),
                  f'K4 {out} disagrees with plain on {name}')
            check(torch.equal(g, a), f'K4 {out} not deterministic on {name}')
            err['k4'] = max(err['k4'], (g - w).abs().max().item())
            note('k4', gate_ratio(g, w), f'{name} {out}')
        for p in k3.PARAM_NAMES:
            g, w = got[4][p], want[4][p]
            scale = max(1.0, w.abs().max().item())
            check(torch.allclose(g, w, atol=3e-5 * scale, rtol=0),
                  f'K4 d_{p} disagrees with plain on {name}')
            check(torch.equal(g, again[4][p]),
                  f'K4 d_{p} not deterministic on {name}')
            err['k4'] = max(err['k4'], (g - w).abs().max().item() / scale)
            note('k4', gate_ratio(g, w, 3e-5 * scale, 0.0), f'{name} d_{p}')
        real = int((case['senders'] < n).sum())
        print(f'fused kernels: {name} N={n} E={len(case["senders"])} '
              f'(real {real}) K={k} {mode} residual={res} ok')
        if name == 'bench':
            bench = (args, cots, mode, tanh, real, len(case['senders']), n,
                     k, res)

    for key, (value, where) in ratio.items():
        print(f'fused kernels: {key.upper()} worst |kernel - plain| / '
              f'(atol + rtol |plain|) = {value:.4f} (at {where}; gate 1)')
    args, cots, mode, tanh, real, e, n, k, res = bench
    bounds = {}
    for key, mod, work in (('k3', k3, k3_work), ('k4', k4, k4_work)):
        print(f'fused kernels: {key.upper()} resources '
              f'{json.dumps(mod.kernel_info())}')
        nbytes, flops, products = work(real, e, n, k, res)
        # The products run on the tensor cores in 3xTF32: three TF32
        # products for each f32 one.
        bounds[key] = (bound_ms(nbytes, flops),
                       bound_ms(nbytes, 3 * products, TF32_FLOPS_PER_S))
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    timings = {
        'k3': dict(
            ms=time_cuda(torch, lambda: k3.fused_edge_forward(
                *args, mode, tanh), flush),
            plain_ms=time_cuda(torch, lambda: k3.fused_edge_forward_plain(
                *args, mode, tanh), flush),
            library_ms=None, bound=bounds['k3'][1]),
        'k4': dict(
            ms=time_cuda(torch, lambda: k4.fused_edge_backward(
                *args, *cots, mode, tanh), flush),
            plain_ms=time_cuda(torch, lambda: k4.fused_edge_backward_plain(
                *args, *cots, mode, tanh), flush),
            library_ms=None, bound=bounds['k4'][1]),
    }
    for key, v in timings.items():
        print(f'fused kernels: {key} N={n} E={e} (real {real}) K={k} {mode} '
              f'ms={v["ms"]:.4f} plain_ms={v["plain_ms"]:.4f} '
              f'library_ms=none bound_ms={v["bound"][0]:.4f} '
              f'({v["bound"][1]})')
    for key, (f32, tc) in bounds.items():
        print(f'fused kernels: {key} bounds: f32 units {f32[0]:.4f} ms '
              f'({f32[1]}), tensor cores in 3xTF32 {tc[0]:.4f} ms ({tc[1]})')
    return err, timings


# ----------------------------------------------------------------- 5
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


README_6L = dict(num_layers=6, edge_attention=True, softmax_attention=True)
# name -> (flags, counted kernel, other kernels it may launch, fused)
SERVING = {
    'default_3l': (dict(num_layers=3), 'segment_sum_sorted', (), False),
    'readme_softmax_6l': (README_6L, 'softmax_aggregate_sorted', (), False),
    'sigmoid_3l': (dict(num_layers=3, edge_attention=True),
                   'softmax_aggregate_sorted', (), False),
    # K3 in every layer; the coordinate means run on K1.
    'readme_softmax_6l_fused': (README_6L, 'fused_edge_forward',
                                ('segment_sum_sorted',), True),
}
MODEL_KWARGS = dict(dim_input=12, k=32, dim_output=1, residual=True,
                    normalize=True, tanh=True, graphnorm=True,
                    model_task='classification')


def write_run_dir(torch, run: Path, flags: dict):
    from pointvs_tpu_torch.models.layers import init_parameters
    from pointvs_tpu_torch.models.registry import build_model
    from pointvs_tpu_torch.utils import save_yaml
    model_kwargs = dict(MODEL_KWARGS, **flags)
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


def kernel_profile(torch, fn):
    """Device time by kernel name over one profiled call of ``fn``, and the
    port's kernel launches in that call by wrapper name."""
    from torch.profiler import ProfilerActivity, profile
    from pointvs_tpu_torch.ops import segment_kernels as sk
    before = sk.launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = {name: n - before[name]
                for name, n in sk.launch_counts().items()}
    return {evt.key: evt.self_device_time_total / 1e3
            for evt in prof.key_averages()
            if evt.self_device_time_total > 0}, launches


def print_profile(label, profiled, shares):
    """Kernel time of one profiled call, and the share of each
    (label, kernel-name part) in ``shares``; for a kernel-name part that is
    a wrapper's name, also its time per launch."""
    by_name, launches = profiled
    busy = sum(by_name.values())
    parts = []
    for ours_label, ours_key in shares:
        ours = sum(v for k, v in by_name.items() if ours_key in k)
        per = (f', {launches[ours_key]} launches, '
               f'{ours / launches[ours_key]:.4f} ms each'
               if launches.get(ours_key) else '')
        parts.append(f'{ours_label} {ours:.3f} ms '
                     f'({100 * ours / max(busy, 1e-9):.1f}%{per})')
    print(f'profile: {label}: kernels {busy:.3f} ms device time '
          f'({len(by_name)} kernel names), of which {", ".join(parts)}; '
          f'top 8:')
    for key, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f'  {ms:8.3f} ms  {key[:110]}')


def forward_profile(torch, trainer, loader, forward):
    """Device time of one batch's forward: the median over repeats by CUDA
    events (batches prepared and moved first), and one profiled forward's
    kernel time by name. Also the batches' (real N, N_pad, real E, E_pad).
    """
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
                forward(b)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
        profiled = kernel_profile(torch, lambda: forward(batches[0]))
    return statistics.median(times[len(batches):]), sizes, profiled


def phase_serving(torch, np, root: Path, types: Path, n_poses: int):
    from pointvs_tpu_torch import inference
    from pointvs_tpu_torch.inference_engine import fused_forward
    from pointvs_tpu_torch.ops import segment_kernels as sk
    launches, module_scores = {}, {}
    batches = -(-n_poses // 32)
    for name, (flags, kernel, others, fused) in SERVING.items():
        run = root / name
        write_run_dir(torch, run, flags)
        args = [str(run), str(types), str(root / 'data'), '--batch_size',
                '32']
        if fused:
            trainer, loader = inference.get_model_and_test_dl(
                *args[:3], torch.device('cuda'), batch_size=32)
            loader = list(loader)   # featurise before the counted run
        sk.reset_launch_counts()
        start = time.perf_counter()
        if fused:
            trainer.val(loader, predictions_file=run / 'gpu.txt',
                        use_fused=True)
        else:
            trainer = inference.main(args + ['--output_fname', 'gpu.txt'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = sk.launch_counts()
        expect = flags['num_layers'] * batches
        check(counts[kernel] == expect,
              f'{name}: {kernel} launched {counts[kernel]} times, '
              f'expected {expect}')
        for other, count in counts.items():
            check(other == kernel or other in others or count == 0,
                  f'{name}: unexpected {other} launches ({count})')
        rows = (run / 'pose_gpu.txt').read_text().splitlines()
        gpu = trainer.val_scores
        check(len(rows) == n_poses and len(gpu) == n_poses
              and np.isfinite(gpu).all(),
              f'{name}: expected {n_poses} finite rows, got {len(rows)}')
        cpu = inference.main(args + ['--output_fname', 'cpu.txt',
                                     '--device', 'cpu']).val_scores
        diff = float(np.abs(gpu - cpu).max())
        check(diff <= 1e-4, f'{name}: GPU and CPU scores differ by {diff}')
        extra = ''
        if fused:
            module = module_scores['readme_softmax_6l']
            fdiff = float(np.abs(gpu - module).max())
            check(fdiff <= 1e-4, f'{name}: fused and module scores differ '
                                 f'by {fdiff}')
            extra = f' max|fused-module|={fdiff:.2e}'
        module_scores[name] = gpu
        trainer, loader = inference.get_model_and_test_dl(
            *args[:3], trainer.device, batch_size=32)
        forward = ((lambda b, m=trainer.model: fused_forward(m, b)) if fused
                   else trainer.model)
        fwd, sizes, profiled = forward_profile(torch, trainer, loader,
                                               forward)
        launches[name] = counts[kernel]
        print(f'serving: {name} poses={n_poses} wall={wall:.3f} s '
              f'poses_per_s={n_poses / wall:.1f} '
              f'forward_ms_per_batch={fwd:.3f} launches={counts} '
              f'max|gpu-cpu|={diff:.2e}{extra} batch sizes (real N, N_pad, '
              f'real E, E_pad)={sizes}')
        print_profile(f'{name} one forward', profiled,
                      [('K3', 'fused_edge_forward')] if fused
                      else [('the segment kernels', 'sorted_kernel')])
    return launches


# ----------------------------------------------------------------- 6
TRAIN_STEPS = 5
TRAIN_LR = 1e-3


def _fused_grads(torch, model, batch):
    from pointvs_tpu_torch.fused_train import fused_apply
    from pointvs_tpu_torch.training.losses import loss_fn
    model.zero_grad(set_to_none=True)
    loss_sum, weight = loss_fn(fused_apply(model, batch), batch,
                               'classification')
    (loss_sum / torch.clamp_min(weight, 1.0)).backward()
    return [p.grad.clone() for p in model.parameters() if p.grad is not None]


def _step_ms(torch, trainer, batch, fused):
    """Median ms of one optimiser step by CUDA events, and one profiled
    step's kernel time by name and launches."""
    from pointvs_tpu_torch.parallel.steps import make_train_step
    step = make_train_step(trainer.model, trainer.optimiser, 'classification',
                           use_fused=fused)
    for _ in range(2):
        step(batch, TRAIN_LR)
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(batch, TRAIN_LR)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), kernel_profile(
        torch, lambda: step(batch, TRAIN_LR))


def phase_training(torch, np, root: Path, types: Path):
    from pointvs_tpu_torch import inference
    from pointvs_tpu_torch.data.buckets import to_device
    from pointvs_tpu_torch.ops import segment_kernels as sk
    from pointvs_tpu_torch.training.engine import Trainer
    # The pose set's two batches of 32, unaugmented and in file order, as
    # the reference's loader gives them with augmentation off; five steps.
    _, loader = inference.get_model_and_test_dl(
        str(root / 'readme_softmax_6l'), str(types), str(root / 'data'),
        torch.device('cpu'), batch_size=32)
    host = list(loader)
    steps = [host[i % len(host)] for i in range(TRAIN_STEPS)]
    layers = README_6L['num_layers']
    kwargs = dict(MODEL_KWARGS, **README_6L)
    runs, launches = {}, {}
    for device in ('cuda', 'cpu'):
        for fused in (False, True):
            name = f'{"fused" if fused else "module"}_{device}'
            trainer = Trainer('egnn', root / f'train_{name}',
                              torch.device(device), learning_rate=TRAIN_LR,
                              weight_decay=1e-4, seed=SEED,
                              fused_training=fused, **kwargs)
            sk.reset_launch_counts()
            start = time.perf_counter()
            trainer.train_model(steps, epochs=1)
            if device == 'cuda':
                torch.cuda.synchronize()
            wall = time.perf_counter() - start
            counts = sk.launch_counts()
            losses = np.asarray(trainer.train_losses)
            check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(),
                  f'training {name}: losses {losses}')
            runs[name] = trainer
            launches[name] = counts
            print(f'training: {name} steps={TRAIN_STEPS} wall={wall:.3f} s '
                  f'launches={counts} losses={losses.tolist()}')
    expect = layers * TRAIN_STEPS
    module, fused = launches['module_cuda'], launches['fused_cuda']
    check(module['softmax_aggregate_sorted'] == expect
          and module['segment_sum_sorted'] >= expect
          and module['fused_edge_forward'] == 0
          and module['fused_edge_backward'] == 0,
          f'module path launches {module}, expected K2 = {expect}, K1 >= '
          f'{expect}, no K3/K4')
    check(fused['fused_edge_forward'] == expect
          and fused['fused_edge_backward'] == expect
          and fused['softmax_aggregate_sorted'] == 0,
          f'fused path launches {fused}, expected K3 = K4 = {expect}')
    check(all(v == 0 for c in (launches['module_cpu'], launches['fused_cpu'])
              for v in c.values()), 'a CPU run launched a CUDA kernel')
    loss = {name: np.asarray(t.train_losses) for name, t in runs.items()}
    for a, b in (('module_cuda', 'module_cpu'), ('fused_cuda', 'fused_cpu'),
                 ('fused_cuda', 'module_cuda')):
        diff = float(np.abs(loss[a] - loss[b]).max())
        check(np.allclose(loss[a], loss[b], **TRAJ_TOL),
              f'training: {a} and {b} trajectories differ by {diff}')
        print(f'training: max|{a} - {b}| loss = {diff:.3e}')

    # K4 is deterministic: two identical backward passes, identical bits.
    trainer = runs['fused_cuda']
    batch = to_device(host[0][0], trainer.device)
    first = _fused_grads(torch, trainer.model, batch)
    second = _fused_grads(torch, trainer.model, batch)
    check(len(first) == len(second) and all(
        torch.equal(a, b) for a, b in zip(first, second)),
        'fused backward is not deterministic')

    # The saved checkpoint reloads to the same scores.
    ckpt = trainer.save_path / 'checkpoints' / 'pose_ckpt_epoch_1.pt'
    check(ckpt.exists(), f'no checkpoint at {ckpt}')
    trainer.val(host, predictions_file=root / 'trained.txt')
    reloaded = Trainer('egnn', root / 'reloaded', trainer.device,
                       seed=SEED + 1, **kwargs)
    reloaded.load_weights(ckpt)
    reloaded.val(host, predictions_file=root / 'reloaded.txt')
    check(reloaded.p_epoch == 1 and np.array_equal(
        reloaded.val_scores, trainer.val_scores),
        'the reloaded checkpoint scores differently')
    print(f'training: checkpoint {ckpt.name} reloads to identical scores; '
          f'fused gradients bit-identical over two passes')

    for name in ('module_cuda', 'fused_cuda'):
        fused_path = name.startswith('fused')
        ms, profiled = _step_ms(torch, runs[name], batch, fused_path)
        print(f'training: {name} step_ms={ms:.3f} (median of 10, CUDA '
              f'events, batch of 32 poses)')
        print_profile(f'{name} one step', profiled,
                      [('K3', 'fused_edge_forward'),
                       ('K4', 'fused_edge_backward')] if fused_path
                      else [('K1+K2', 'sorted_kernel')])
    return {'k1': module['segment_sum_sorted'],
            'k2': module['softmax_aggregate_sorted'],
            'k3': fused['fused_edge_forward'],
            'k4': fused['fused_edge_backward']}


def main() -> int:
    try:
        import numpy as np
        import torch
        card = phase_device(torch)
        check((RESOURCES / 'lig_0.parquet').exists(),
              f'{RESOURCES} is missing: run from a checkout of the repo')
        phase_build()
        err, timings = phase_kernels(torch, np)
        fused_err, fused_timings = phase_fused_kernels(torch, np)
        err.update(fused_err)
        timings.update(fused_timings)
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            types, n_poses = write_pose_set(np, root / 'data')
            launches = phase_serving(torch, np, root, types, n_poses)
            train_launches = phase_training(torch, np, root, types)
    except Exception:  # any phase failing fails the run, with its trace
        traceback.print_exc()
        print('chip_smoke: FAILED', file=sys.stderr)
        return 1

    def entry(name, source, replaces, count, err_key, timing_key):
        v = timings[timing_key]
        return {'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces, 'launches': count,
                'max_abs_err': err[err_key], 'ms': v['ms'],
                'plain_ms': v['plain_ms'], 'bound_ms': v['bound'][0],
                'bound_by': v['bound'][1], 'library_ms': v['library_ms']}

    kernels = [
        entry('segment_sum_sorted', K1_SOURCE, K1_REPLACES,
              launches['default_3l'], 'k1', 'k1_36'),
        entry('softmax_aggregate_sorted[softmax]', K1_SOURCE, K2_REPLACES,
              launches['readme_softmax_6l'], 'softmax', 'softmax'),
        entry('softmax_aggregate_sorted[sigmoid]', K1_SOURCE, K2_REPLACES,
              launches['sigmoid_3l'], 'sigmoid', 'sigmoid'),
        entry('fused_edge_forward', K3_SOURCE, K3_REPLACES,
              train_launches['k3'], 'k3', 'k3'),
        entry('fused_edge_backward', K4_SOURCE, K4_REPLACES,
              train_launches['k4'], 'k4', 'k4'),
    ]
    print(f'launches on the main paths: serving {launches}; training '
          f'(module path K1/K2, fused path K3/K4) {train_launches}')
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
