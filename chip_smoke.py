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
3. kernels: K1 segment_sum_sorted (at widths 1, 2, 3, 4, 13, 16, 32, 35,
   36 and 40) and K2 softmax_aggregate_sorted (softmax and sigmoid mode)
   against their plain PyTorch versions on the card, evaluated in float64
   (the f32 plain sum adds by atomics in no fixed order and errs on a long
   row by as much as the 1e-5 gate), at a bench shape (N=14336 nodes,
   ~156k edges from a seeded degree distribution), at the same size
   with the real batch's spread of degrees, and at edge cases (a 300-edge
   row, rows of one edge, empty rows, a padding tail, tied and fully masked
   rows, E < 4 * 128); the row offsets (``segment_offsets``) against numpy;
   with offsets passed in, found by the wrapper, and repeated, each kernel
   must give identical bits. Both kernels' registers, spills and resident
   blocks per SM; K1 timed at K = 1, 3, 4, 32, 35, 36 and 40 and K2 in
   both modes (and softmax at a feature width of 4) at the bench shape, K1
   at K=36 and K2 on the skewed one, and the offsets' own time, each by
   CUDA events and by the profiler's device time per launch;
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
   its pocket) scored at batch 32, k=32, through
   ``pointvs_tpu_torch.inference``: egnn with reference-default flags at 3
   layers, the README's 6-layer softmax-attention model, sigmoid
   attention at 3 layers, and the 6-layer model once more through
   ``make_eval_step(use_fused=True)`` (K3 in every layer); the multitask
   model with the README's flags (pose head on the module path, affinity
   head through K3) and with ``--edge_attention_final_only`` (K2 on the
   last layer alone; K3 with each layer's own attention mode); lucid at 6
   layers (attention, coordinate and feature norms, 2 fourier features,
   GraphNorm: K1 over the sorted receivers); en_transformer at 6 layers
   and 4 heads. Each kernel's launches must equal the configuration's
   count per batch (SERVING) x batches, and no other kernel may launch;
   64 finite rows must be written; scores must match a ``--device cpu``
   run (and the fused scores the module path's) within 1e-4; one profiled
   forward's kernel time, K1's, K2's and K3's per launch, and the top
   kernels by name. Then K1 over the first pose batch's
   ``receivers_sorted`` at widths 1, 3, 4, 32 and 33 against its plain
   version in float64, bit-identical on repeat, and timed as in phase 3;
6. training: the ``Trainer`` takes 5 steps on the README 6-layer model
   (k=32, batch 32) on the module path (K1/K2 forward and backward) and on
   the fused path (K3 forward, K4 backward). Launch counts per path (at
   most two offset computations per step); each
   loss trajectory against a CPU run, and the two paths against each
   other, within atol 1e-4 / rtol 1e-5; two identical fused backward
   passes give identical parameter gradients; the saved checkpoint reloads
   to the same scores; step time by CUDA events and each path's profiled
   kernel share, K1's, K2's, K3's and K4's per launch, and the top kernels
   by name;
7. training CLI: ``pointvs_tpu_torch.main.main`` (in process, so the
   launch counters can be read) trains the README 6-layer model (k=32,
   softmax attention, residual, normalise, tanh, GraphNorm, compact) on the
   pose set for 2 epochs at batch 32 with one augmented copy of each
   active, edge dropout 0.1, validation after each epoch, --top1 and
   --end_flag: 96 items, 3 weighted-sampled steps an epoch. Checks the run
   directory's files, K2 at 6 launches per training step and validation
   forward, K1 in every step, at most one offset computation per batch,
   finite losses in metrics.jsonl, and the same command line with
   ``--device cpu`` within the trajectory gate (the dropout seeds come from
   one host generator, so the masks match). Then ``python -m
   pointvs_tpu_torch.resume_training`` in a subprocess continues the run to
   epoch 3 (exit 0, ``pose_ckpt_epoch_3.pt``), and one step's parameter
   gradients with ``--remat`` must be within 1e-6 of the step's without.
   Prints the CLI's step ms by CUDA events (median, p90), each epoch's
   wall time, poses per second, and the host share of an epoch (wall minus
   the profiler's device time of a second run's steps); and the step ms
   and epoch wall of a third run with ``--prefetch 0`` (no loader thread);
8. lucid (3 layers, also with dropout 0.1, whose masks are the
   reference's under the step's JAX key: ``ops/dropout.py``'s kernel, 2 x
   3 sites x 3 layers launches a step) and en_transformer (3 layers, 4
   heads) through the ``Trainer``: 5 steps on the card and on the CPU
   within the trajectory gate, K1 launches, step ms by CUDA events;
9. multitask CLI: ``pointvs_tpu_torch.main multitask ... --model_task both
   -ep 1 -ea 1`` with the README model on the pose set and affinity labels
   drawn from the seed: both checkpoints and predictions files, epoch
   counters, K2 at 6 launches per step and validation forward, the same
   command with ``--device cpu`` within the trajectory gate, step ms by
   CUDA events; the pose head served from the run's newest checkpoint
   (the affinity phase's) and from its pose checkpoint, the scores'
   difference printed;
10. the pair, dense and strain inputs through ``pointvs_tpu_torch.main``:
   ``siamese`` and ``egnn --include_strain_info`` (a types file with dE
   and strain RMSD drawn from the seed) with the README flags, 2 epochs
   at batch 32, and ``lie_conv`` (the dense family) at 6 layers and batch
   ``DENSE_BATCH`` on the card; each against the same command with
   ``--device cpu`` within the trajectory gate and (siamese, strain) its
   validation scores within 1e-4, the dense one cut to 2 layers and batch
   8 (``DENSE_CUT``) for the CPU. Launches: siamese K2 6 and K1 at least
   12 a forward or step, strain K2 6, dense none of K1-K4. Step ms by
   CUDA events and the peak memory of each card run; then
   ``resume_training`` continues the siamese run to epoch 3;
11. the strain model through the ``Trainer``: 5 steps on the module path
   and on the fused path (K3, K4) on the card, the trajectories within the
   gate.

Phase 5 also serves ``siamese`` with the README flags (K2 6 and K1 12 a
batch: the ligand tower's coordinates are frozen, so it aggregates with
K1 at widths 1 and 32), ``dense_egnn`` at 6 layers (no kernel of ours;
its peak memory is printed) and the README model with
``--include_strain_info`` on the strain types file, on the module path
and through K3 (served with dE = 0, as the reference's serving CLI
serves such a run).

Phase 5 also serves the README model and the multitask model with
``--bf16`` (bf16 feature MLPs, K2 in f32: 6 launches a batch), and the
bf16 README model through ``make_eval_step(use_fused=True)``, which takes
the module path as the reference does (no K3); bf16 scores against the
CPU's within ``BF16_SCORE_GATE``. Then:

12. bf16: 5 ``Trainer`` steps of the README model with ``bf16`` on the
   card and on the CPU (module path; K2 6 a step in f32, no K3/K4),
   the trajectories within ``BF16_TRAJ_GATE``; ``main egnn --bf16`` with
   the README flags at batch 32 for one epoch on the card and the CPU,
   then ``resume_training`` of the card's run to epoch 2; and a 48-layer
   k=32 EGNN (module path, batch 32) trained a few steps in bf16 and in
   f32: step ms by CUDA events and ``max_memory_allocated`` of each, the
   reference's claim that bf16 halves activation memory at depth measured
   on this card;
13. SynthPharm: ``main egnn --synthpharm --compact`` with the README
   flags, batch 32, one epoch, on a synthetic-pharmacophore copy of the
   pose set (each ligand atom's ``type`` an atomic number of the nine
   pharmacophore classes, each pocket atom's a class 0-2, drawn from the
   seed), on the card and the CPU within the trajectory gate, launches
   per step printed;
14. ``--double`` on the card: ``python -m pointvs_tpu_torch.main ...
   --double`` exits non-zero naming ``--device cpu`` and leaves no run
   directory.

After phase 5, the screen (``pointvs_tpu_torch.screen.screen``): 256
seeded poses of the test ligand screened against its receptor with the
README model (K2 6 a batch) and ``default_3l`` (K1 3 a batch) at batch 256
and 32, one offset computation a batch and no other kernel; 256 finite
scores; the first 32 ligands' scores against a ``--device cpu`` screen
within 1e-4; poses per second and the host featurisation's share of the
wall; and the host featurisation a pose of the screen's dataset with the
native graph library (``pointvs_tpu_torch/native``) and with its numpy
plain versions in its place, every item array-equal. Then attribution:
the 7zzp pair parsed by the port's parser; ``attribute`` with each of
the 12 method names on the README model (K2) and ``default_3l`` (K1)
runs, on the card against a ``--device cpu`` run of the same call within
1e-4 (a method the model has no values for stops on both); atom masking
timed by CUDA events (masked variants a second, ms a 32-copy chunk) with
K2 6 / K1 3 launches a chunk and K1/K2 on a chunk's own inputs against
their plain versions; ``screen --attribute_top 4``. Then the attribution
tail, each entry point against a ``--device cpu`` run of the same call
within 1e-4: the hotspot CLI (``pointvs_tpu_torch.attribution.hotspot``)
on four seeded rigid copies of the 7zzp ligand with the README model (K2)
and ``default_3l`` (K1), its CSVs and SDFs (rows that no near tie moves),
its K1/K2 launches counted and held against one forward per fragment and
chunk, K1/K2 on a masking chunk's own inputs against their plain
versions; ``constrained_attribution`` with the 7zzp ligand as the core;
``score_and_colour_pdb`` on the PDB's own NHE and 2OP sites (B-factor
PDBs line for line but for the two-decimal rounding step); the AP
statistics of a labelled synthetic-pharmacophore copy of the pose set;
pose selection (``parse_results``, TopN) of the serving phase's
predictions against a plain TopN; hotspot seconds a fragment, masked
variants a second and ``process_pdb`` ms a site. After the K1
receiver check, the dropout mask kernel (``ops/csrc/threefry_dropout.cu``) against its plain version
on lucid's three site shapes of a real batch (masks, values and
gradients bit for bit; the node site's mask against the host's threefry),
on an odd size and a misaligned view, timed against its bound.

After the training CLI, the device-resident dataset
(``pointvs_tpu_torch/data/device_dataset.py``): the 64-pose store built
and uploaded (MB, ms); every batch of a validation and a training pass
collated from item ids on the card and held field by field against the
host collation moved to the card; the rotation matrices against the
CPU's within 1e-6; the README model on the module path (K2) and the
fused path (K3/K4) and ``default_3l`` (K1) trained 3 epochs (6 steps)
from ids and from the host stream in turns, the trajectories within the
gate, each kernel of the ids steps held against its plain version on the
inputs the step gave it (``_first_call_recorder``), step ms by CUDA
events and the last epoch's host share for both; ``main --device_cache
on`` against ``off`` with augmented actives (the hybrid tail), scores
within 1e-5; peak memory. The screen phase also screens the README
model at batch 32 through the host stream (``POINTVS_SCREEN_DEVICE=0``)
and the chunked library (``POINTVS_SCREEN_CHUNK_MB=5``: at least 3
chunks) with exact coordinates and in the half-edge codec
(``POINTVS_SCREEN_CHUNK_RAW=0``), each within 1e-5 of the resident
store's scores, and with the default codecs (coords16: the worst
|score difference|, the top-32 overlap and Spearman's rho), then a cold
and a warm ``--cache_dir`` screen (the warm one loads the cached store).

Last, scale-out (``parallel/``): ``main`` with the README CLI flags
without dropout (one epoch: 64 poses and 32 augmented actives, 3 steps
at batch 32, then 2 validation batches) at ``--num_devices 1`` in
process, then ``--num_devices 2`` (2 spawned ranks sharing the card over
gloo, 16 graphs a rank a step) and ``--num_devices 2 --graph_shard 2``
(one batch's edges over 2 ranks), each rank's losses within the
trajectory gate and its validation scores within 5e-4 of one device's,
and ``--multihost`` as the one rank of a launcher's job over NCCL (in
process). Each rank's launches come back in its report: K2 6 a step and
a validation forward on the dp ranks, K2 never and K1 in every layer on
the edge-shard ranks. K1 on rank 0's edge shard of a real batch against
its plain version in float64. Each rank's step ms and gradient
all-reduce ms a step (pack, all-reduce, unpack) by CUDA events.

After the screen, the streaming wire path (``wire``; ``data/wire.py``)
with the README model on the screen's 256-pose library: batches at ``-b
32`` in the v1, v2 and v3 wire formats and at ``-b 256`` (over 65,536
padded nodes) in v2 and v1 (int32 ids), each compressed and packed on
the host, copied to the card in one transfer and decoded there, every
field bit-identical to the host batch moved array by array; the eval
step on each, and at ``-b 32`` the module (K1/K2) and fused (K3/K4)
training steps, packed and raw in turns from identical models, with
identical outputs and parameters; the streaming screen
(``POINTVS_SCREEN_DEVICE=0``) at ``-b 32`` and ``-b 256``, grouped
(``POINTVS_SCREEN_GROUP``, 8) and scanned (``POINTVS_SCREEN_SCAN=1``),
within 1e-5 of the resident store's scores; for each format the bytes a
batch raw and packed, the host's compress and pack ms, the copy and the
decode ms by CUDA events, and the steps' ms packed and raw. Its K1-K4
launches join the kernels line's counts.

Then the dataset tools (``dataset_tools``): ``replicate_poses train``
writes 64 poses and ``replicate_poses screen`` a 256-pose library from a
source tree laid out from ``tests/resources``, ``synthetic_affinity``
labels the 64 poses, ``main multitask --model_task regression`` with the
README flags trains the affinity head on them for one epoch at batch 32
(K2 6 a step; its first-step loss within 1e-4 of a ``--device cpu``
run's), and ``screen`` scores the library with the README serving run
(K2 6 a batch; the first 32 scores within 1e-4 of the CPU's); their K1
and K2 launches join the kernels line's counts.

Then the wall seconds of every phase, one JSON line describing every
kernel, and as the last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --scale-out-cards N`` instead builds the kernels
and runs the scale_out phase alone with N ranks, each on a card of its
own (NCCL between them); it needs N cards.
``python3 chip_smoke.py --lucid-step ROOT`` instead times the lucid
3-layer ``--dropout 0.1`` Trainer step of the port under ROOT (any
checkout of this repository) and prints one JSON line: run it for two
trees in turns in one call to compare two commits.
``python3 chip_smoke.py --featurise ROOT`` likewise prints the host
featurisation a pose over the screen's 256 poses and a ``default_3l``
screen's poses/s and host share, for the port under ROOT.
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
# --bf16 on the card against the CPU: both devices' bf16 GEMMs accumulate
# in f32 but in different orders, so a product may round to the next bf16
# value; scores (probabilities) and losses are held within these.
BF16_SCORE_GATE = 1e-2
BF16_TRAJ_GATE = 1e-2      # relative, per loss


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
K1_WIDTHS = (1, 2, 3, 4, 13, 16, 32, 35, 36, 40)   # checked on every case
K1_TIMED = (1, 3, 4, 32, 35, 36, 40)                # timed at the bench shape
K2_NARROW = 4   # K2 also timed at this feature width (softmax, bench shape)


def make_edges(np, rng, n, mean_degree, pad, k, empty_every=0,
               tail_empty=0, ties=False, masked_every=0, deg=None):
    """Sorted ids (padding = n last) and edge data for one case; ``deg``
    gives each row's edges in place of Poisson degrees. ``wide`` holds
    [E, 40] rows for K1 at every width."""
    if deg is None:
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
                wide=rng.standard_normal((e, max(K1_WIDTHS))).astype(
                    np.float32),
                logits=logits,
                trans=rng.standard_normal((e, 3)).astype(np.float32),
                mask=mask)


def skewed_degrees(np, rng, graphs=32, atoms=448, tail=36):
    """Per pocket graph, degrees spread like the serving batches' (their
    percentiles are printed by the serving phase): most atoms near the
    median of ~11 edges, and a tail of atoms with 20 to 54 (the ligand
    against the receptor atoms it overlaps in a perturbed pose)."""
    parts = [rng.poisson(10.5, atoms - tail), rng.integers(20, 55, tail)]
    return np.concatenate([np.concatenate(parts) for _ in range(graphs)])


def time_cuda(torch, fn, flush, reps=25, clean=False):
    """Median ms of ``fn`` by CUDA events, L2 flushed before each call: by
    writing a 256 MB buffer (the L2 is left full of dirty lines, which the
    call's own traffic must write back), or with ``clean`` by reading it."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        if clean:
            flush.sum()
        else:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def profiled_ms(torch, fn, flush, kernel, reps=10):
    """Mean device ms per call of the kernels whose name holds ``kernel``,
    by the profiler over ``reps`` calls of ``fn``, L2 flushed by writing
    before each as in ``time_cuda``: the kernel's own time, without the
    launch and event gaps that the CUDA-event time includes."""
    def run():
        for _ in range(reps):
            flush.zero_()
            fn()
    by_name, _ = kernel_profile(torch, run)
    return sum(v for key, v in by_name.items() if kernel in key) / reps


def bound_ms(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def k1_work(real, n, k):
    """(bytes, flops) of one K1 launch given its offsets: the real edges'
    rows and the offsets read once, the sums written once."""
    return 4 * (real * k + (n + 1) + n * k), real * k


def k2_work(real, n, k):
    """(bytes, flops) of one K2 launch given its offsets: feat, trans,
    logit and mask of the real edges and the offsets read once, out
    [N, K+6] and seg_max written once; exp, weight and sums per edge."""
    return 4 * (real * (k + 5) + (n + 1) + n * (k + 7)), real * (2 * k + 12)


def phase_kernels(torch, np):
    from pointvs_tpu_torch.ops import segment_kernels as sk
    rng = np.random.default_rng(SEED)
    cases = {
        # Bench shape: 32 pocket graphs of ~450 atoms, ~11 edges per atom.
        'bench': make_edges(np, rng, 14336, 10.9, 4000, 32),
        # The same size with the real batch's spread of degrees.
        'skewed': make_edges(np, rng, 14336, 0, 4000, 32,
                             deg=skewed_degrees(np, rng)),
    }
    hub = rng.poisson(8.0, 300)
    hub[7] = 300
    one = (rng.random(300) < 0.8).astype(np.int64)   # rows of 0 or 1 edge
    cases.update({
        'k13': make_edges(np, rng, 300, 8.0, 200, 13),
        'empty_rows': make_edges(np, rng, 300, 8.0, 50, 16, empty_every=3),
        'padding_tail': make_edges(np, rng, 300, 8.0, 300, 16,
                                   tail_empty=100),
        'ties': make_edges(np, rng, 300, 8.0, 40, 32, ties=True),
        'all_masked_rows': make_edges(np, rng, 300, 8.0, 40, 32,
                                      masked_every=4),
        'small_e': make_edges(np, rng, 40, 6.0, 30, 32),   # E < 4 * 128
        'hub': make_edges(np, rng, 300, 0, 40, 32, deg=hub),   # 300 edges
        'one_edge': make_edges(np, rng, 300, 0, 40, 16, deg=one),
    })
    dev = torch.device('cuda')
    err = {'k1': 0.0, 'softmax': 0.0, 'sigmoid': 0.0}
    for name, c in cases.items():
        t = {key: torch.from_numpy(c[key]).to(dev)
             for key in ('ids', 'feat', 'wide', 'logits', 'trans', 'mask')}
        n = c['n']
        sk.reset_launch_counts()
        offsets = sk.segment_offsets(t['ids'], n)
        check(np.array_equal(offsets.cpu().numpy(), np.searchsorted(
            c['ids'], np.arange(n + 1))), f'offsets wrong on {name}')
        for kw in K1_WIDTHS:
            data = t['wide'][:, :kw].contiguous()
            got = sk.windowed_segment_sum(data, t['ids'], n, offsets)
            again = sk.windowed_segment_sum(data, t['ids'], n, offsets)
            found = sk.windowed_segment_sum(data, t['ids'], n)
            want = sk.windowed_segment_sum_plain(data.double(), t['ids'],
                                                 n).float()
            torch.cuda.synchronize()
            check(torch.allclose(got, want, **TOL),
                  f'K1 disagrees with plain on {name} K={kw}')
            check(torch.equal(got, again) and torch.equal(got, found),
                  f'K1 not bit-identical on {name} K={kw} (repeat, or '
                  f'offsets found by the wrapper)')
            err['k1'] = max(err['k1'], (got - want).abs().max().item())
        for mode in ('softmax', 'sigmoid'):
            args = (t['feat'], t['logits'], t['trans'], t['mask'], t['ids'],
                    n, mode)
            out, seg_max = sk.fused_softmax_aggregate(*args, offsets)
            again = sk.fused_softmax_aggregate(*args, offsets)
            found = sk.fused_softmax_aggregate(*args)
            w_out, w_max = (w.float() for w in sk.fused_softmax_aggregate_plain(
                *[a.double() for a in args[:4]], *args[4:]))
            torch.cuda.synchronize()
            check(torch.allclose(out, w_out, **TOL)
                  and torch.allclose(seg_max, w_max, **TOL),
                  f'K2 ({mode}) disagrees with plain on {name}')
            check(all(torch.equal(a, b) for a, b in zip(
                (out, seg_max), again)) and all(torch.equal(a, b) for a, b
                                                in zip((out, seg_max), found)),
                  f'K2 ({mode}) not bit-identical on {name}')
            err[mode] = max(err[mode], (out - w_out).abs().max().item(),
                            (seg_max - w_max).abs().max().item())
        counts = sk.launch_counts()
        check(counts['segment_offsets'] == 1 + len(K1_WIDTHS) + 2,
              f'{name}: {counts["segment_offsets"]} offset computations')
        real = int((c['ids'] < n).sum())
        print(f'kernels: {name} N={n} E={len(c["ids"])} (real {real}, max '
              f'{int(np.diff(offsets.cpu().numpy()).max(initial=0))} edges '
              f'a row) ok')
    for variant, info in sk.kernel_info().items():
        print(f'kernels: {variant} resources {json.dumps(info)}')

    # Timing at the bench shape (and K1 at K=36 / K2 on the skewed one),
    # offsets found once beforehand, as the main path passes them.
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    timings = {}
    for name in ('bench', 'skewed'):
        c = cases[name]
        n = c['n']
        real = int((c['ids'] < n).sum())
        t = {key: torch.from_numpy(c[key]).to(dev)
             for key in ('ids', 'feat', 'wide', 'logits', 'trans', 'mask')}
        ids = t['ids']
        offsets = sk.segment_offsets(ids, n)
        tag = '' if name == 'bench' else '_skewed'
        keys = []
        for kw in (K1_TIMED if name == 'bench' else (36,)):
            data = t['wide'][:, :kw].contiguous()
            keys.append(f'k1_{kw}{tag}')
            launch = lambda: sk.windowed_segment_sum(  # noqa: E731
                data, ids, n, offsets)
            timings[keys[-1]] = dict(
                ms=time_cuda(torch, launch, flush),
                clean_ms=time_cuda(torch, launch, flush, clean=True),
                device_ms=profiled_ms(torch, launch, flush,
                                      'segment_sum_sorted'),
                plain_ms=time_cuda(torch, lambda: sk.windowed_segment_sum_plain(
                    data, ids, n), flush),
                library_ms=time_cuda(torch, lambda: torch.zeros(
                    (n + 1, kw), device=dev).index_add_(0, ids, data), flush),
                bound=bound_ms(*k1_work(real, n, kw)))
        k2_runs = [(mode, mode, t['feat']) for mode in ('softmax', 'sigmoid')]
        if name == 'bench':
            k2_runs.append((f'softmax_k{K2_NARROW}', 'softmax',
                            t['wide'][:, :K2_NARROW].contiguous()))
        for key, mode, feat in k2_runs:
            args = (feat, t['logits'], t['trans'], t['mask'], ids, n, mode)
            keys.append(f'{key}{tag}')
            launch = lambda: sk.fused_softmax_aggregate(  # noqa: E731
                *args, offsets)
            timings[keys[-1]] = dict(
                ms=time_cuda(torch, launch, flush),
                clean_ms=time_cuda(torch, launch, flush, clean=True),
                device_ms=profiled_ms(torch, launch, flush,
                                      'softmax_aggregate_sorted'),
                plain_ms=time_cuda(
                    torch, lambda: sk.fused_softmax_aggregate_plain(*args),
                    flush),
                library_ms=None,
                bound=bound_ms(*k2_work(real, n, feat.shape[1])))
        find = lambda: sk.segment_offsets(ids, n)  # noqa: E731
        find_ms = time_cuda(torch, find, flush)
        find_device_ms = profiled_ms(torch, find, flush, 'searchsorted')
        print(f'kernels: segment_offsets on {name} (searchsorted of N+1 '
              f'rows into E ids) ms={find_ms:.4f} (profiler device time '
              f'{find_device_ms:.4f})')
        for key in keys:
            v = timings[key]
            print(f'kernels: {key} N={n} E={len(c["ids"])} (real {real}) '
                  f'ms={v["ms"]:.4f} (clean L2 {v["clean_ms"]:.4f}; '
                  f'profiler device time {v["device_ms"]:.4f}) '
                  f'plain_ms={v["plain_ms"]:.4f} '
                  f'library_ms={v["library_ms"]} '
                  f'bound_ms={v["bound"][0]:.4f} ({v["bound"][1]}) '
                  f'share_of_bound={v["bound"][0] / v["ms"]:.3f}')
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


def _as_double(torch, a):
    """``a`` (a tensor, a dict of tensors or None) in float64."""
    if isinstance(a, dict):
        return {key: v.double() for key, v in a.items()}
    return a.double() if torch.is_tensor(a) and a.is_floating_point() else a


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
        # The plain version in float64 (its float32 sums add by atomics in
        # no fixed order and can reach the gate themselves).
        want = [w.float() for w in k3.fused_edge_forward_plain(
            *[_as_double(torch, a) for a in args], mode, tanh)]
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
LUCID_6L = dict(num_layers=6, attention=True, norm_coords=True,
                norm_feats=True, fourier_features=2, graphnorm=True)
# The multitask runs add a softplus affinity head: relu on random weights
# scores most poses 0, which would hold the GPU to the CPU on zeros.
MULTITASK_6L = dict(README_6L, final_softplus=True)
FINAL_ONLY_6L = dict(MULTITASK_6L, edge_attention_final_only=True)
# The dense family's reference-default flags (its model's own defaults:
# residual, normalise, tanh, no distance cutoff).
DENSE_6L = dict(num_layers=6)
STRAIN_6L = dict(README_6L, include_strain_info=True)
README_6L_BF16 = dict(README_6L, bf16=True)
# name -> (model, flags, task, fused, launches per batch by kernel,
# offset computations per batch). Every other kernel must not launch.
SERVING = {
    'default_3l': ('egnn', dict(num_layers=3), None, False,
                   {'segment_sum_sorted': 3}, 1),
    'readme_softmax_6l': ('egnn', README_6L, None, False,
                          {'softmax_aggregate_sorted': 6}, 1),
    'sigmoid_3l': ('egnn', dict(num_layers=3, edge_attention=True), None,
                   False, {'softmax_aggregate_sorted': 3}, 1),
    'readme_softmax_6l_fused': ('egnn', README_6L, None, True,
                                {'fused_edge_forward': 6,
                                 'segment_sum_sorted': 6}, 1),
    # The multitask model: the pose head on the module path, the affinity
    # head through K3; with a final-only switch K2 runs on the last layer
    # alone (K1 takes the other five) and K3 runs each layer's own mode.
    'multitask_readme_6l': ('multitask', MULTITASK_6L, 'classification',
                            False,
                            {'softmax_aggregate_sorted': 6}, 1),
    'multitask_readme_6l_fused': ('multitask', MULTITASK_6L, 'regression',
                                  True,
                                  {'fused_edge_forward': 6,
                                   'segment_sum_sorted': 6}, 1),
    'multitask_final_only_6l': ('multitask', FINAL_ONLY_6L,
                                'classification', False,
                                {'softmax_aggregate_sorted': 1,
                                 'segment_sum_sorted': 5}, 1),
    'multitask_final_only_6l_fused': ('multitask', FINAL_ONLY_6L,
                                      'classification', True,
                                      {'fused_edge_forward': 6,
                                       'segment_sum_sorted': 6}, 1),
    # lucid: two means at the receivers a layer (K1 over receivers_sorted,
    # whose offsets are found once a batch beside the senders').
    'lucid_6l': ('lucid', LUCID_6L, None, False,
                 {'segment_sum_sorted': 12}, 2),
    # en_transformer: the 4 heads' softmax denominators, the value sum and
    # the coordinate mean, one K1 each a layer.
    'en_transformer_6l': ('en_transformer', dict(num_layers=6, heads=4),
                          None, False, {'segment_sum_sorted': 18}, 1),
    # siamese: the receptor tower K2 a layer; the ligand tower, whose
    # coordinates are frozen, K1 twice a layer (the softmax denominators
    # at width 1, the message sum at 32); each tower finds its offsets.
    'siamese_readme_6l': ('siamese', README_6L, None, False,
                          {'softmax_aggregate_sorted': 6,
                           'segment_sum_sorted': 12}, 2),
    # dense_egnn: all-pairs tensor algebra, no kernel of ours.
    'dense_egnn_6l': ('dense_egnn', DENSE_6L, None, False, {}, 0),
    # The strain model on the module path and through K3 (the serving
    # CLI scores it with dE = 0, as the reference's does).
    'strain_readme_6l': ('egnn', STRAIN_6L, None, False,
                         {'softmax_aggregate_sorted': 6}, 1),
    'strain_readme_6l_fused': ('egnn', STRAIN_6L, None, True,
                               {'fused_edge_forward': 6,
                                'segment_sum_sorted': 6}, 1),
    # --bf16: the feature MLPs in bf16, K2 in f32. The fused request of a
    # bf16 model takes the module path (the reference's supports_fusion
    # rejects bf16): K2, no K3.
    'readme_softmax_6l_bf16': ('egnn', README_6L_BF16, None, False,
                               {'softmax_aggregate_sorted': 6}, 1),
    'readme_softmax_6l_bf16_fused': ('egnn', README_6L_BF16, None, True,
                                     {'softmax_aggregate_sorted': 6}, 1),
    'multitask_readme_6l_bf16': ('multitask',
                                 dict(MULTITASK_6L, bf16=True),
                                 'classification', False,
                                 {'softmax_aggregate_sorted': 6}, 1),
}
MODEL_KWARGS = dict(dim_input=12, k=32, dim_output=1, residual=True,
                    normalize=True, tanh=True, graphnorm=True,
                    model_task='classification')


def write_run_dir(torch, run: Path, flags: dict, model: str = 'egnn'):
    """A run directory of random weights from SEED: a pose checkpoint, and
    for the multitask model an affinity one with the same weights."""
    from pointvs_tpu_torch.models.layers import init_parameters
    from pointvs_tpu_torch.models.registry import build_model
    from pointvs_tpu_torch.utils import save_yaml
    model_kwargs = dict(MODEL_KWARGS, **flags)
    net = build_model(model, **model_kwargs)
    init_parameters(net, torch.Generator().manual_seed(SEED))
    (run / 'checkpoints').mkdir(parents=True)
    tasks = ('pose', 'affinity') if model == 'multitask' else ('pose',)
    for task in tasks:
        torch.save({'model_state_dict': net.state_dict(), 'p_epoch': 0,
                    'a_epoch': 0},
                   run / 'checkpoints' / f'{task}_ckpt_epoch_0.pt')
    save_yaml(model_kwargs, run / 'model_kwargs.yaml')
    save_yaml({'model': model, 'batch_size': 32, 'radius': 10,
               'edge_radius': 4.0, 'compact': True,
               'egnn_attention': flags.get('edge_attention', False),
               'include_strain_info': flags.get('include_strain_info',
                                                False)},
              run / 'cmd_args.yaml')


def write_strain_types(np, types: Path, seed: int) -> Path:
    """The pose set's lines with a strain energy dE (0-30) and a strain
    RMSD (0-2) drawn from ``seed`` appended, as the types files that
    ``--include_strain_info`` reads."""
    rng = np.random.default_rng(seed)
    lines = [f'{line} {rng.uniform(0, 30):.3f} {rng.uniform(0, 2):.3f}'
             for line in types.read_text().splitlines()]
    out = types.parent / 'poses_strain.types'
    out.write_text('\n'.join(lines) + '\n')
    return out


def batch_sizes(torch, b):
    """A batch's sizes: (real N, N_pad, real E, E_pad) and edges per real
    atom (median, p90, p99, max); for a pair each side's, for a dense batch
    (real atoms, graphs, N_pad)."""
    if hasattr(b, 'rec'):
        return {'rec': batch_sizes(torch, b.rec),
                'lig': batch_sizes(torch, b.lig)}
    if hasattr(b, 'p'):
        return (int(b.m.sum()),) + tuple(b.p.shape[:2])
    n = b.node_feats.shape[0]
    deg = torch.bincount(b.senders[b.senders < n].long(), minlength=n)
    deg = deg[b.node_mask > 0].float()
    return ((int(b.node_mask.sum()), n, int(b.edge_mask.sum()),
             b.senders.shape[0]),
            tuple(torch.quantile(deg, torch.tensor(
                [0.5, 0.9, 0.99, 1.0], device=deg.device)).tolist()))


def dense_logits_check(torch, np, gpu, cpu, args):
    """The dense family's logits on the first pose batch, GPU against CPU
    within rtol 1e-4: at random weights over ~430 atoms, all pairs and no
    cutoff, its logits reach ~1e6 and every score saturates, so the scores
    alone would hold nothing."""
    from pointvs_tpu_torch import inference
    from pointvs_tpu_torch.data.buckets import to_device
    _, loader = inference.get_model_and_test_dl(
        *args[:3], torch.device('cpu'), batch_size=32)
    batch = next(iter(loader))[0]
    with torch.no_grad():
        want = cpu.model(to_device(batch, torch.device('cpu'))).numpy()
        got = gpu.model(to_device(batch, gpu.device)).cpu().numpy()
    real = batch.graph_mask > 0
    rel = float((np.abs(got - want) / np.abs(want))[real].max())
    check(np.isfinite(got).all() and rel <= 1e-4,
          f'dense_egnn: GPU and CPU logits differ by {rel:.2e} (relative)')
    return (f' logits |max| {np.abs(want[real]).max():.4g}, max relative '
            f'|gpu-cpu| {rel:.2e}')


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


SEGMENT_SHARES = [('K1', 'segment_sum_sorted'),
                  ('K2', 'softmax_aggregate_sorted'),
                  ('offsets', 'searchsorted')]


def print_profile(label, profiled, shares, top=12):
    """Kernel time of one profiled call, and the share of each
    (label, kernel-name part) in ``shares``; for a kernel-name part that is
    a wrapper's name (its CUDA kernels carry it), also its time per
    launch. Then the ``top`` kernels by device time."""
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
          f'top {top}:')
    for key, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f'  {ms:8.3f} ms  {key[:110]}')


def forward_profile(torch, trainer, loader, forward):
    """Device time of one batch's forward: the median over repeats by CUDA
    events (batches prepared and moved first), and one profiled forward's
    kernel time by name. Also the batches' (real N, N_pad, real E, E_pad).
    """
    from pointvs_tpu_torch.data.buckets import to_device
    batches = [to_device(b, trainer.device) for b, _ in loader]
    sizes = [batch_sizes(torch, b) for b in batches]
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
    launches, module_scores, forward_ms = {}, {}, {}
    batches = -(-n_poses // 32)
    strain_types = write_strain_types(np, types, SEED + 3)
    for name, (model, flags, task, fused, per_batch, offsets) in \
            SERVING.items():
        run = root / name
        write_run_dir(torch, run, flags, model)
        served = (strain_types if flags.get('include_strain_info')
                  else types)
        args = [str(run), str(served), str(root / 'data'), '--batch_size',
                '32'] + (['--model_task', task] if task else [])
        if fused:
            trainer, loader = inference.get_model_and_test_dl(
                *args[:3], torch.device('cuda'), model_task=task,
                batch_size=32)
            loader = list(loader)   # featurise before the counted run
        torch.cuda.reset_peak_memory_stats()
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
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for kernel, count in counts.items():
            expect = per_batch.get(kernel, 0) * batches
            if kernel == 'segment_offsets':
                expect = offsets * batches
            check(count == expect, f'{name}: {kernel} launched {count} '
                                   f'times, expected {expect}')
        prefix = 'affinity' if 'regression' in (task or '') else 'pose'
        rows = (run / f'{prefix}_gpu.txt').read_text().splitlines()
        gpu = trainer.val_scores
        check(len(rows) == n_poses and len(gpu) == n_poses
              and np.isfinite(gpu).all(),
              f'{name}: expected {n_poses} finite rows, got {len(rows)}')
        cpu_trainer = inference.main(args + ['--output_fname', 'cpu.txt',
                                             '--device', 'cpu'])
        cpu = cpu_trainer.val_scores
        diff = float(np.abs(gpu - cpu).max())
        gate = BF16_SCORE_GATE if flags.get('bf16') else 1e-4
        check(diff <= gate, f'{name}: GPU and CPU scores differ by {diff}')
        extra = ''
        if model == 'dense_egnn':
            extra = dense_logits_check(torch, np, trainer, cpu_trainer,
                                       args)
        module_name = name[:-len('_fused')] if fused else None
        if module_name in module_scores and SERVING[module_name][2] == task:
            module = module_scores[module_name]
            fdiff = float(np.abs(gpu - module).max())
            check(fdiff <= 1e-4, f'{name}: fused and module scores differ '
                                 f'by {fdiff}')
            extra = f' max|fused-module|={fdiff:.2e}'
        module_scores[name] = gpu
        trainer, loader = inference.get_model_and_test_dl(
            *args[:3], trainer.device, model_task=task, batch_size=32)
        kw = {'task': task} if model == 'multitask' else {}
        forward = ((lambda b, m=trainer.model: fused_forward(m, b, **kw))
                   if fused else
                   (lambda b, m=trainer.model: m(b, **kw)))
        fwd, sizes, profiled = forward_profile(torch, trainer, loader,
                                               forward)
        launches[name] = counts
        forward_ms[name] = fwd
        if model == 'dense_egnn':
            b, n = sizes[0][1:]
            extra += (f' peak_memory={peak:.3f} GiB (max_memory_allocated '
                      f'over the GPU run; one [{b}, {n}, {n}, 32] f32 pair '
                      f'tensor is {4 * b * n * n * 32 / 2 ** 30:.3f} GiB)')
        print(f'serving: {name} ({model}{", " + task if task else ""}) '
              f'poses={n_poses} wall={wall:.3f} s '
              f'poses_per_s={n_poses / wall:.1f} '
              f'forward_ms_per_batch={fwd:.3f} launches={counts} '
              f'max|gpu-cpu|={diff:.2e}{extra} batch sizes (real N, N_pad, '
              f'real E, E_pad) and edges per real atom (median, p90, p99, '
              f'max); dense: (real atoms, graphs, N_pad)={sizes}')
        print_profile(f'{name} one forward', profiled,
                      [('K3', 'fused_edge_forward')] + SEGMENT_SHARES
                      if fused else SEGMENT_SHARES)
    for name in ('readme_softmax_6l', 'multitask_readme_6l'):
        print(f'serving: {name}: forward_ms_per_batch f32 '
              f'{forward_ms[name]:.3f}, bf16 '
              f'{forward_ms[name + "_bf16"]:.3f} (median by CUDA events, '
              f'this call)')
    return launches


K1_RECEIVER_WIDTHS = (1, 3, 4, 32, 33)   # lucid's means are 3+1 and 32+1


def phase_receiver_sorted(torch, np, root: Path, types: Path):
    """K1 over the real pose batch's receivers_sorted (lucid's
    mean_to_dst), at widths 1, 3, 4, 32 and 33, against its plain version
    in float64 and bit-identical on repeat; timed as the other K1 rows."""
    from pointvs_tpu_torch.data.buckets import to_device
    from pointvs_tpu_torch.data.loader import get_data_loader
    from pointvs_tpu_torch.ops import segment_kernels as sk
    from pointvs_tpu_torch.ops.aggregate import EdgeAggregator
    dev = torch.device('cuda')
    batch = to_device(next(iter(get_data_loader(
        types.parent, types, batch_size=32, radius=10, edge_radius=4,
        polar_hydrogens=False, prefetch=0, mode='val')))[0], dev)
    n = batch.node_feats.shape[0]
    agg = EdgeAggregator(batch.senders, batch.receivers, batch.edge_mask, n,
                         recv_perm=batch.recv_perm)
    ids = agg.receivers_sorted
    offsets = agg.receiver_offsets()
    host_ids = ids.cpu().numpy()
    check(np.array_equal(offsets.cpu().numpy(), np.searchsorted(
        host_ids, np.arange(n + 1))), 'receiver offsets wrong')
    real = int((host_ids < n).sum())
    deg = np.diff(offsets.cpu().numpy())
    rng = np.random.default_rng(SEED + 2)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    err, timings = 0.0, {}
    for kw in K1_RECEIVER_WIDTHS:
        data = torch.from_numpy(rng.standard_normal(
            (len(host_ids), kw)).astype(np.float32)).to(dev)
        got = sk.windowed_segment_sum(data, ids, n, offsets)
        again = sk.windowed_segment_sum(data, ids, n, offsets)
        want = sk.windowed_segment_sum_plain(data.double(), ids, n).float()
        torch.cuda.synchronize()
        check(torch.allclose(got, want, **TOL),
              f'K1 on receivers_sorted disagrees with plain at K={kw}')
        check(torch.equal(got, again),
              f'K1 on receivers_sorted not bit-identical at K={kw}')
        err = max(err, (got - want).abs().max().item())
        launch = lambda: sk.windowed_segment_sum(  # noqa: E731
            data, ids, n, offsets)
        v = dict(ms=time_cuda(torch, launch, flush),
                 device_ms=profiled_ms(torch, launch, flush,
                                       'segment_sum_sorted'),
                 plain_ms=time_cuda(torch, lambda: sk.windowed_segment_sum_plain(
                     data, ids, n), flush),
                 library_ms=time_cuda(torch, lambda: torch.zeros(
                     (n + 1, kw), device=dev).index_add_(0, ids, data),
                     flush),
                 bound=bound_ms(*k1_work(real, n, kw)))
        timings[f'k1r_{kw}'] = v
        print(f'kernels: k1 on receivers_sorted K={kw} N={n} '
              f'E={len(host_ids)} (real {real}, max {int(deg.max())} edges '
              f'a row, {int((deg[:int(batch.node_mask.sum())] == 0).sum())} '
              f'real rows empty) ms={v["ms"]:.4f} (profiler device time '
              f'{v["device_ms"]:.4f}) plain_ms={v["plain_ms"]:.4f} '
              f'library_ms={v["library_ms"]:.4f} bound_ms='
              f'{v["bound"][0]:.4f} ({v["bound"][1]}) share_of_bound='
              f'{v["bound"][0] / v["ms"]:.3f} max_abs_err vs float64 '
              f'{(got - want).abs().max().item():.2e}')
    return err, timings


# ------------------------------------------------------------- screen
SCREEN_POSES = 256
SCREEN_BATCHES = (256, 32)
SCREEN_CPU_POSES = 32
# name -> (serving run directory of phase 5, launches a batch by kernel);
# one offset computation a batch, and no other kernel.
SCREEN_RUNS = {'readme_softmax_6l': {'softmax_aggregate_sorted': 6},
               'default_3l': {'segment_sum_sorted': 3}}


def featurise_ms(np, cls, data: Path, types: Path):
    """Host ms a pose of ``cls``'s items over a screen manifest, cold
    (a fresh dataset), the first item's ms apart (a shared-receptor
    dataset builds the receptor's grid and edges there), and the items."""
    # A dataset that keeps a receptor cache starts it empty.
    getattr(cls, '_shared_cache', {}).clear()
    ds = cls(data, types, radius=10, edge_radius=4, polar_hydrogens=False,
             compact=True, model_task='classification')
    times, items = [], []
    for i in range(len(ds)):
        start = time.perf_counter()
        items.append(ds[i])
        times.append(time.perf_counter() - start)
    return 1e3 * float(np.mean(times[1:])), 1e3 * times[0], items


def _plain_argsort(ids, max_id):
    """``native.build.counting_argsort``'s plain version."""
    import numpy as np
    del max_id
    return np.argsort(np.asarray(ids), kind='stable').astype(np.int32)


def featurise_native_vs_numpy(np, lib: Path, types: Path) -> dict:
    """Host featurisation a pose of the screen's dataset
    (``PointCloudDataset``) over the screen's poses with the native graph
    library (the main path) and with its numpy plain versions
    (``make_box_numpy``, ``generate_edges_numpy``, ``np.lexsort``,
    ``np.argsort``) put in its place; every item's arrays must be
    equal. Returns {'native': ms, 'numpy': ms, 'native_first': ms,
    'numpy_first': ms}."""
    from pointvs_tpu_torch.data import buckets, dataset
    from pointvs_tpu_torch.data import preprocessing as pre
    plain = ((dataset, 'make_box', pre.make_box_numpy),
             (dataset, 'generate_edges', pre.generate_edges_numpy),
             (dataset, 'lexsort_pairs',
              lambda rows, cols, _: np.lexsort((cols, rows))),
             (buckets, 'counting_argsort', _plain_argsort))
    for path in lib.glob('*.parquet'):   # neither pays the first reads
        pre.read_struct(path)
    cls = dataset.PointCloudDataset
    native_ms, native_first, native_items = featurise_ms(np, cls, lib, types)
    saved = [(module, name, getattr(module, name))
             for module, name, _ in plain]
    for module, name, fn in plain:
        setattr(module, name, fn)
    try:
        numpy_ms, numpy_first, numpy_items = featurise_ms(np, cls, lib,
                                                          types)
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    for got, want in zip(native_items, numpy_items):
        for field in ('node_feats', 'coords', 'senders', 'receivers',
                      'edge_attr'):
            check(np.array_equal(getattr(got, field), getattr(want, field)),
                  f'featurisation: native and numpy {field} differ')
    print(f'featurisation: {cls.__name__} over {len(native_items)} poses: '
          f'native {native_ms:.3f} ms a pose (first item '
          f'{native_first:.3f}), numpy plain version {numpy_ms:.3f} ms '
          f'(first {numpy_first:.3f}); numpy / native '
          f'{numpy_ms / native_ms:.2f}; every item array-equal')
    return {'native': native_ms, 'numpy': numpy_ms,
            'native_first': native_first, 'numpy_first': numpy_first}


def phase_screen(torch, np, root: Path, card: str):
    """``pointvs_tpu_torch.screen.screen`` over SCREEN_POSES seeded poses of
    the test ligand against its receptor with the README model (K2) and
    ``default_3l`` (K1) at each of SCREEN_BATCHES: each kernel's launches
    a batch, finite scores for every pose, the first SCREEN_CPU_POSES
    ligands' scores against a ``--device cpu`` screen within 1e-4; poses
    per second and the share of the wall in the host featurisation; then
    the host featurisation a pose with the native graph library against
    its numpy plain versions. Returns each run's launches by kernel,
    summed over the batch sizes."""
    from pointvs_tpu_torch.ops import segment_kernels as sk
    from pointvs_tpu_torch.screen import screen
    types, _ = write_pose_set(np, root / 'library', SCREEN_POSES)
    lib = types.parent
    receptor = lib / 'rec_0.parquet'
    ligands = str(lib / 'lig_*.parquet')
    first = root / 'library_first'
    first.mkdir()
    for path in sorted(lib.glob('lig_*.parquet'))[:SCREEN_CPU_POSES]:
        (first / path.name).write_bytes(path.read_bytes())
    out = {}
    for name, per_batch in SCREEN_RUNS.items():
        run = root / name
        cpu = screen(run, receptor, str(first), output=str(
            root / f'screen_{name}_cpu.csv'), batch_size=32, device='cpu')
        cpu_scores = {Path(r['ligand']).name: r['score'] for r in cpu.rows}
        for b in SCREEN_BATCHES:
            batches = -(-SCREEN_POSES // b)
            sk.reset_launch_counts()
            result = screen(run, receptor, ligands, output=str(
                root / f'screen_{name}_{b}.csv'), batch_size=b)
            torch.cuda.synchronize()
            counts = sk.launch_counts()
            for kernel, count in counts.items():
                expect = (batches if kernel == 'segment_offsets'
                          else per_batch.get(kernel, 0) * batches)
                check(count == expect, f'screen {name} -b {b}: {kernel} '
                                       f'launched {count}, expected {expect}')
            scores = np.asarray([r['score'] for r in result.rows])
            check(len(scores) == SCREEN_POSES and np.isfinite(scores).all(),
                  f'screen {name} -b {b}: {len(scores)} scores')
            gpu_scores = {Path(r['ligand']).name: r['score']
                          for r in result.rows}
            diff = max(abs(gpu_scores[lig] - v)
                       for lig, v in cpu_scores.items())
            check(diff <= 1e-4, f'screen {name} -b {b}: GPU and CPU scores '
                                f'differ by {diff}')
            sec = result.seconds
            out[name] = {kernel: out.get(name, {}).get(kernel, 0) + count
                         for kernel, count in counts.items()}
            check(result.path == 'resident',
                  f'screen {name} -b {b}: took the {result.path} path')
            print(f'screen: {card}: {name} -b {b} ({result.path}): '
                  f'{SCREEN_POSES} poses in '
                  f'{sec["total"]:.3f} s = {result.poses_per_second:.1f} '
                  f'poses/s (load {sec["load"]:.3f}, featurise '
                  f'{sec["featurise"]:.3f}, score {sec["score"]:.3f} s); '
                  f'host featurisation share '
                  f'{sec["featurise"] / sec["total"]:.3f}; launches {counts}'
                  f'; max|gpu - cpu| over the first {SCREEN_CPU_POSES} '
                  f'{diff:.2e}')
            if b == SCREEN_PATH_BATCH and name == SCREEN_PATH_RUN:
                resident = result
            if name == WIRE_RUN:
                RESIDENT_SCORES[b] = {r['ligand']: r['score']
                                      for r in result.rows}
    for key, counts in screen_paths(torch, np, root, receptor, ligands,
                                    resident, card).items():
        out[SCREEN_PATH_RUN] = {k: out[SCREEN_PATH_RUN].get(k, 0) + n
                                for k, n in counts.items()}
    featurise_native_vs_numpy(np, lib, types)
    return out


SCREEN_PATH_RUN = 'readme_softmax_6l'
SCREEN_PATH_BATCH = 32
SCREEN_CHUNK_MB = '5'     # the 256 poses' store is ~20 MB: >= 3 chunks
SCREEN_TOP = 32


def _ranks(np, values):
    ranks = np.empty(len(values))
    ranks[np.argsort(values, kind='stable')] = np.arange(len(values))
    return ranks


def screen_paths(torch, np, root: Path, receptor: Path, ligands: str,
                 resident, card: str) -> dict:
    """The README model's screen at batch 32 on its other paths, against
    the resident store's scores (``resident``): streaming
    (``POINTVS_SCREEN_DEVICE=0``), chunked with exact coordinates and
    chunked in the half-edge codec (``POINTVS_SCREEN_CHUNK_RAW=0``) within
    1e-5; chunked with the default codecs (coords16, lossy): the worst
    |score difference|, the top-32 overlap and Spearman's rho; then a cold
    and a warm screen with ``--cache_dir``, the warm one loading the
    cached store. Each run's launches: K2 6 a batch, one offset
    computation a batch. Returns the runs' launches by name."""
    import os
    from pointvs_tpu_torch import screen as screen_mod
    from pointvs_tpu_torch.ops import segment_kernels as sk
    exact = {r['ligand']: r['score'] for r in resident.rows}
    order = sorted(exact)
    runs = {
        'streaming': ({'POINTVS_SCREEN_DEVICE': '0'}, 'streaming', None),
        'chunked_exact': ({'POINTVS_SCREEN_CHUNK_MB': SCREEN_CHUNK_MB,
                           'POINTVS_CHUNK_COORDS16': '0'}, 'chunked', None),
        'chunked_coords16': ({'POINTVS_SCREEN_CHUNK_MB': SCREEN_CHUNK_MB},
                             'chunked', None),
        'chunked_half': ({'POINTVS_SCREEN_CHUNK_MB': SCREEN_CHUNK_MB,
                          'POINTVS_SCREEN_CHUNK_RAW': '0'}, 'chunked', None),
        'cache_cold': ({}, 'resident', root / 'screen_cache'),
        'cache_warm': ({}, 'resident', root / 'screen_cache'),
    }
    real_plan = screen_mod.plan_chunks
    plans = []

    def plan_chunks(*args, **kwargs):
        plans.append(real_plan(*args, **kwargs))
        return plans[-1]

    screen_mod.plan_chunks = plan_chunks
    out, results = {}, {}
    try:
        for key, (env, path, cache) in runs.items():
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            sk.reset_launch_counts()
            try:
                result = screen_mod.screen(
                    root / SCREEN_PATH_RUN, receptor, ligands,
                    output=str(root / f'screen_path_{key}.csv'),
                    batch_size=SCREEN_PATH_BATCH,
                    cache_dir=None if cache is None else str(cache))
                torch.cuda.synchronize()
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            counts = sk.launch_counts()
            check(result.path == path, f'screen {key}: took the '
                                       f'{result.path} path')
            check(counts['segment_offsets'] > 0
                  and counts['softmax_aggregate_sorted']
                  == 6 * counts['segment_offsets']
                  and counts['fused_edge_forward'] == 0,
                  f'screen {key}: launches {counts}')
            out[key] = counts
            results[key] = result
            scores = {r['ligand']: r['score'] for r in result.rows}
            check(sorted(scores) == order, f'screen {key}: other ligands')
            got = np.asarray([scores[k] for k in order])
            want = np.asarray([exact[k] for k in order])
            worst = float(np.abs(got - want).max())
            extra = ''
            if key == 'chunked_coords16':
                top = len(set(np.argsort(-got)[:SCREEN_TOP])
                          & set(np.argsort(-want)[:SCREEN_TOP]))
                rho = float(np.corrcoef(_ranks(np, got),
                                        _ranks(np, want))[0, 1])
                extra = (f'; top-{SCREEN_TOP} overlap {top}/{SCREEN_TOP}, '
                         f'Spearman rho {rho:.6f}')
            else:
                check(worst <= 1e-5, f'screen {key}: scores differ from the '
                                     f'resident store\'s by {worst}')
            if key.startswith('chunked'):
                n_chunks, cspec = len(plans[-1][0]), plans[-1][1]
                check(n_chunks >= 3, f'screen {key}: {n_chunks} chunks')
                check(cspec.raw == (key != 'chunked_half') and cspec.half,
                      f'screen {key}: chunk codec {cspec}')
                extra += f'; {n_chunks} chunks'
            sec = result.seconds
            print(f'screen: {card}: {SCREEN_PATH_RUN} -b '
                  f'{SCREEN_PATH_BATCH} {key} ({result.path}): '
                  f'{result.poses_per_second:.1f} poses/s, wall '
                  f'{sec["total"]:.3f} s (featurise {sec["featurise"]:.3f}, '
                  f'score {sec["score"]:.3f}); max|score - resident| '
                  f'{worst:.2e}{extra}; launches {counts}')
    finally:
        screen_mod.plan_chunks = real_plan
    print(f'screen: {card}: chunk codecs, {SCREEN_PATH_RUN} -b '
          f'{SCREEN_PATH_BATCH}: ' + ', '.join(
              f'{key} {results[key].poses_per_second:.1f} poses/s'
              for key in ('chunked_exact', 'chunked_coords16',
                          'chunked_half')))
    cold, warm = results['cache_cold'], results['cache_warm']
    print(f'screen: {card}: re-screen with --cache_dir: cold '
          f'{cold.seconds["total"]:.3f} s (featurise '
          f'{cold.seconds["featurise"]:.3f}), warm '
          f'{warm.seconds["total"]:.3f} s (store loaded in '
          f'{warm.seconds["featurise"]:.3f}); resident without the cache '
          f'{resident.seconds["total"]:.3f} s')
    return out


# --------------------------------------------------------------- wire
WIRE_RUN = 'readme_softmax_6l'
WIRE_BATCHES = (32, 256)
WIRE_STEPS = 3          # training steps of each form, in turns
WIRE_REPS = 20          # timed repeats of a copy, a decode or a step
WIRE_GROUP_SCREENS = {'grouped': {}, 'scanned': {'POINTVS_SCREEN_SCAN': '1'}}
# label -> (batch size, POINTVS_WIRE_V3, prefer_v2, wire class)
WIRE_FORMATS = {
    'v1 -b 32': (32, '0', False, 'WireBatch'),
    'v2 -b 32': (32, '1', True, 'WireBatchV2'),
    'v3 -b 32': (32, '1', None, 'WireBatchV3'),
    'v2 -b 256': (256, '1', None, 'WireBatchV2'),   # the default there
    'v1 -b 256': (256, '0', False, 'WireBatch'),    # int32 indices
}
# README screens of the library from phase_screen: batch -> scores.
RESIDENT_SCORES = {}


def _turns_ms(torch, dev, fns: dict, reps=WIRE_REPS) -> dict:
    """Median ms of each of ``fns`` by CUDA events on ``dev`` (the host
    clock on the CPU), the functions called in turns, after one warm-up
    call each."""
    for fn in fns.values():
        fn()
    cuda = dev.type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
    marks = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                marks[name].append((start, end))
            else:
                start = time.perf_counter()
                fn()
                marks[name].append(1e3 * (time.perf_counter() - start))
    if cuda:
        torch.cuda.synchronize()
        return {name: statistics.median(a.elapsed_time(b) for a, b in m)
                for name, m in marks.items()}
    return {name: statistics.median(m) for name, m in marks.items()}


def _with_env(env: dict, fn):
    import os
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_wire(torch, np, root: Path, card: str, dev=None,
               batches=WIRE_BATCHES, min_v2_nodes=65536):
    """The streaming wire path (``data/wire.py``) with the README model on
    the screen's library: (a) batches of the library at ``-b 32`` in v1,
    v2 and v3 and at ``-b 256`` (n_pad >= 65536) in v2 (the default
    there) and v1 (int32 ids), each packed on the host, copied to the
    card and decoded there, every field bit-identical to the host batch
    moved array by array; (b) on each, the eval step packed and raw, and
    at ``-b 32`` (v3) the training step on the module path (K1/K2) and on
    the fused path (K3/K4) from identical models, packed and raw in turns:
    identical outputs and parameters (a second raw model is the control);
    (c) the streaming screen (``POINTVS_SCREEN_DEVICE=0``) at ``-b 32``
    and ``-b 256``, grouped (``POINTVS_SCREEN_GROUP`` 8) and again under
    ``POINTVS_SCREEN_SCAN=1``, within 1e-5 of the resident store's scores
    (phase_screen); (d) for each format the bytes a batch raw and packed,
    the host's compress and pack ms, the H2D copy ms of each by CUDA
    events (from pinned memory), the decode ms and the eval step ms packed
    and raw; the training steps' ms packed and raw. Each packed path's
    launches are counted. Returns the launches by kernel."""
    import copy
    from pointvs_tpu_torch import inference
    from pointvs_tpu_torch import screen as screen_mod
    from pointvs_tpu_torch.data import wire
    from pointvs_tpu_torch.data.buckets import to_device
    from pointvs_tpu_torch.ops import segment_kernels as sk
    from pointvs_tpu_torch.parallel.steps import make_eval_step, \
        make_train_step
    from pointvs_tpu_torch.training.optimisers import build_optimiser
    dev = dev or torch.device('cuda')
    cuda = dev.type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize()

    lib = root / 'library'
    types = lib / 'poses.types'
    run = root / WIRE_RUN
    trainer, _ = inference.get_model_and_test_dl(
        str(run), str(types), str(lib), dev, batch_size=batches[0])
    model = trainer.model
    host = {}
    for b in batches:
        _, loader = inference.get_model_and_test_dl(
            str(run), str(types), str(lib), torch.device('cpu'),
            batch_size=b)
        host[b] = next(iter(loader))[0]
    check(host[batches[1]].node_feats.shape[0] >= min_v2_nodes,
          f'wire: the -b {batches[1]} batch has '
          f'{host[batches[1]].node_feats.shape[0]} padded nodes')
    eval_step = make_eval_step(model, 'classification')
    launches = {'k1': 0, 'k2': 0, 'k3': 0, 'k4': 0}

    def add_launches(counts):
        for key, name in (('k1', 'segment_sum_sorted'),
                          ('k2', 'softmax_aggregate_sorted'),
                          ('k3', 'fused_edge_forward'),
                          ('k4', 'fused_edge_backward')):
            launches[key] += counts.get(name, 0)

    packed_v3 = None
    for label, (b, v3, prefer_v2, cls) in WIRE_FORMATS.items():
        b = batches[0] if b == 32 else batches[1]
        batch = host[b]
        symmetric = batch.inv_recv_perm is not None
        wire_batch = _with_env({'POINTVS_WIRE_V3': v3},
                               lambda: wire.compress(batch, prefer_v2))
        check(type(wire_batch).__name__ == cls,
              f'wire {label}: compressed as {type(wire_batch).__name__}')
        host_ms = _turns_ms(torch, torch.device('cpu'), {'host': lambda: (
            wire.pack(_with_env({'POINTVS_WIRE_V3': v3},
                                lambda: wire.compress(batch, prefer_v2))))},
            reps=5)['host']
        tmpl = wire.template(wire_batch)
        packed = wire.pack(wire_batch)
        raw = to_device(batch, dev)
        staged = wire.upload(packed, dev)
        decoded = wire.decode(staged, tmpl, symmetric)
        sync()
        _assert_batches_equal(torch, decoded, raw, f'wire {label}')
        raw_bytes = sum(a.nbytes for a in batch if a is not None)
        # The copies alone, from pinned memory, by events.
        pinned_raw = [torch.from_numpy(np.ascontiguousarray(a))
                      for a in batch if a is not None]
        pinned_packed = torch.from_numpy(packed)
        if cuda:
            pinned_raw = [t.pin_memory() for t in pinned_raw]
            pinned_packed = pinned_packed.pin_memory()
        buf = wire.ready(staged)
        copy_ms = _turns_ms(torch, dev, {
            'raw': lambda: [t.to(dev, non_blocking=True)
                            for t in pinned_raw],
            'packed': lambda: pinned_packed.to(dev, non_blocking=True),
            'decode': lambda: wire.decode(buf, tmpl, symmetric)})
        packed_batch = ('packed', buf, tmpl, symmetric)
        sk.reset_launch_counts()
        got = eval_step(packed_batch)
        sync()
        counts = sk.launch_counts()
        add_launches(counts)
        want = eval_step(raw)
        check(torch.equal(got, want),
              f'wire {label}: packed and raw eval steps differ by '
              f'{float((got - want).abs().max())}')
        check(not cuda or counts['softmax_aggregate_sorted'] == 6,
              f'wire {label}: packed eval launches {counts}')
        eval_ms = _turns_ms(torch, dev, {
            'raw': lambda: eval_step(raw),
            'packed': lambda: eval_step(packed_batch)})
        print(f'wire: {card}: {label} ({cls}, N {batch.node_feats.shape[0]}'
              f', E {batch.senders.shape[0]}): bytes raw {raw_bytes} packed '
              f'{packed.nbytes} ({raw_bytes / packed.nbytes:.2f}x); host '
              f'compress+pack {host_ms:.3f} ms; H2D copy raw '
              f'{copy_ms["raw"]:.4f} ms (13 arrays) packed '
              f'{copy_ms["packed"]:.4f} ms; decode {copy_ms["decode"]:.4f}'
              f' ms; eval step (in turns) raw '
              f'{eval_ms["raw"]:.3f} packed {eval_ms["packed"]:.3f} ms; '
              f'fields bit-identical, eval outputs '
              f'identical; launches {counts}')
        if label == 'v3 -b 32':
            packed_v3 = (raw, packed_batch)

    # (b) training steps, packed and raw in turns, from identical models.
    raw, packed_batch = packed_v3
    for fused in (False, True):
        models = {form: copy.deepcopy(model) for form in
                  ('raw', 'raw_control', 'packed')}
        steps = {}
        for form, net in models.items():
            opt = build_optimiser(net.parameters(), 'adam', 1e-4, TRAIN_LR)
            steps[form] = make_train_step(net, opt, 'classification',
                                          with_metrics=True,
                                          use_fused=fused)
        outs = {form: [] for form in models}
        counts = {}
        for _ in range(WIRE_STEPS):
            for form in models:
                sk.reset_launch_counts()
                outs[form].append(steps[form](
                    packed_batch if form == 'packed' else raw, TRAIN_LR))
                sync()
                if form == 'packed':
                    for k, n in sk.launch_counts().items():
                        counts[k] = counts.get(k, 0) + n
        add_launches(counts)
        path = 'fused' if fused else 'module'
        control = all(torch.equal(a, c) for a, c in
                      zip(outs['raw'], outs['raw_control'])) and all(
            torch.equal(p, q) for p, q in
            zip(models['raw'].parameters(),
                models['raw_control'].parameters()))
        same = all(torch.equal(a, c) for a, c in
                   zip(outs['raw'], outs['packed'])) and all(
            torch.equal(p, q) for p, q in
            zip(models['raw'].parameters(), models['packed'].parameters()))
        worst = max(float((a - c).abs().max()) for a, c in
                    zip(outs['raw'], outs['packed']))
        check(same, f'wire: {path} training steps packed and raw differ '
                    f'(outputs by {worst}; raw against raw identical: '
                    f'{control})')
        layers = README_6L['num_layers'] * WIRE_STEPS
        if not cuda:   # no launches on the CPU
            pass
        elif fused:
            check(counts['fused_edge_forward'] == layers
                  and counts['fused_edge_backward'] == layers,
                  f'wire: packed fused steps launched {counts}')
        else:
            check(counts['softmax_aggregate_sorted'] == layers
                  and counts['segment_sum_sorted'] > 0,
                  f'wire: packed module steps launched {counts}')
        step_ms = _turns_ms(torch, dev, {
            'raw': lambda: steps['raw'](raw, TRAIN_LR),
            'packed': lambda: steps['packed'](packed_batch, TRAIN_LR)})
        device = ''
        if cuda:   # one profiled step of each: kernel time on the card
            kernel_ms = {form: sum(kernel_profile(torch, lambda: steps[form](
                batch, TRAIN_LR))[0].values())
                for form, batch in (('raw', raw), ('packed', packed_batch))}
            device = (f'; one profiled step\'s kernel time raw '
                      f'{kernel_ms["raw"]:.3f} packed '
                      f'{kernel_ms["packed"]:.3f} ms')
        print(f'wire: {card}: {path} training step -b {batches[0]} (v3): '
              f'{WIRE_STEPS} steps packed and raw in turns identical '
              f'(losses {[float(o[0]) for o in outs["packed"]]}); step ms '
              f'(in turns, CUDA events) raw {step_ms["raw"]:.3f} packed '
              f'{step_ms["packed"]:.3f}{device}; packed launches {counts}')

    # (c) the streaming screen, grouped and scanned.
    receptor = lib / 'rec_0.parquet'
    ligands = str(lib / 'lig_*.parquet')
    real_upload = screen_mod.upload
    copies = []

    def upload(host_bufs, device):
        copies.append(len(host_bufs))
        return real_upload(host_bufs, device)

    screen_mod.upload = upload
    try:
        for b in batches:
            for name, env in WIRE_GROUP_SCREENS.items():
                copies.clear()
                sk.reset_launch_counts()
                result = _with_env(
                    dict(env, POINTVS_SCREEN_DEVICE='0'),
                    lambda: screen_mod.screen(
                        run, receptor, ligands, output=str(
                            root / f'wire_screen_{name}_{b}.csv'),
                        batch_size=b, device=dev.type))
                sync()
                counts = sk.launch_counts()
                add_launches(counts)
                n_batches = -(-len(result.rows) // b)
                calls = sum(copies) if name == 'scanned' else n_batches
                check(result.path == 'streaming' and (
                      not cuda or counts['softmax_aggregate_sorted']
                      == 6 * calls and counts['segment_offsets'] == calls),
                      f'wire screen {name} -b {b}: path {result.path}, '
                      f'launches {counts}, group copies {copies}')
                scores = {r['ligand']: r['score'] for r in result.rows}
                want = RESIDENT_SCORES.get(b)
                worst = float('nan')
                if want is not None:
                    check(sorted(scores) == sorted(want),
                          f'wire screen {name} -b {b}: other ligands')
                    worst = max(abs(scores[k] - want[k]) for k in want)
                    check(worst <= 1e-5, f'wire screen {name} -b {b}: '
                                         f'scores differ from the resident '
                                         f'store\'s by {worst}')
                sec = result.seconds
                print(f'wire: {card}: screen {name} -b {b} (streaming, '
                      f'group copies {copies}): {result.poses_per_second:.1f}'
                      f' poses/s, wall {sec["total"]:.3f} s (featurise '
                      f'{sec["featurise"]:.3f}, score {sec["score"]:.3f}); '
                      f'max|score - resident| {worst:.2e}; launches '
                      f'{counts}')
    finally:
        screen_mod.upload = real_upload
    return launches


# -------------------------------------------------------- attribution
REC_7ZZP = RESOURCES / '7zzp_rec_0.pdb'
LIG_7ZZP = RESOURCES / '7zzp_lig_0.sdf'
# name -> (serving run directory of phase 5, launches a forward by
# kernel); one offset computation a forward, and no other kernel.
ATTRIBUTION_RUNS = {'readme_softmax_6l': {'softmax_aggregate_sorted': 6},
                    'default_3l': {'segment_sum_sorted': 3}}
ATTRIBUTION_GATE = 1e-4     # the card's scores against the CPU's
# Attention values the two devices may order either way (their own
# values agree within about 1e-7).
RANK_TIE_TOL = 1e-6
ATTRIBUTE_TOP = 4


def _first_call_recorder(module, name: str, store: dict, keep=None):
    """Replace ``module.name`` by a wrapper that keeps in ``store[name]``
    the arguments of its first call (of its first call for which
    ``keep(args)`` holds, where given); returns the original."""
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        if keep is None or keep(args):
            store.setdefault(name, (args, kwargs))
        return original(*args, **kwargs)
    # The wrapped function counts its launches on the module's name.
    wrapper.launches = 0
    setattr(module, name, wrapper)
    return original


def _check_recorded_kernels(torch, sk, recorded: dict, label: str) -> dict:
    """K1 and K2 on the inputs a forward gave them, against their plain
    versions in float64; their worst |kernel - plain|."""
    err = {}
    if 'windowed_segment_sum' in recorded:
        args, kwargs = recorded['windowed_segment_sum']
        data, ids, n = args[:3]
        got = sk.windowed_segment_sum(*args, **kwargs)
        want = sk.windowed_segment_sum_plain(data.double(), ids, n).float()
        torch.cuda.synchronize()
        check(torch.allclose(got, want, **TOL),
              f'{label}: K1 disagrees with plain on the chunk\'s inputs')
        err['k1'] = (got - want).abs().max().item()
    if 'fused_softmax_aggregate' in recorded:
        args, kwargs = recorded['fused_softmax_aggregate']
        out, seg_max = sk.fused_softmax_aggregate(*args, **kwargs)
        w_out, w_max = (w.float() for w in sk.fused_softmax_aggregate_plain(
            *[a.double() for a in args[:4]], *args[4:7]))
        torch.cuda.synchronize()
        check(torch.allclose(out, w_out, **TOL)
              and torch.allclose(seg_max, w_max, **TOL),
              f'{label}: K2 disagrees with plain on the chunk\'s inputs')
        err['softmax'] = max((out - w_out).abs().max().item(),
                             (seg_max - w_max).abs().max().item())
    return err


def _near_ties(np, values, tol: float):
    """For each value, how many others lie within ``tol`` of it."""
    ordered = np.sort(values)
    return (np.searchsorted(ordered, values + tol, side='right')
            - np.searchsorted(ordered, values - tol, side='left') - 1)


def rank_slack(torch, np, model, batch, method: str, rows, cols, n: int):
    """Per atom, how far a mean-rank method's score may move when values
    within RANK_TIE_TOL of each other swap ranks: each layer's near
    ties of the ranked values (the CPU's), averaged over the layers (as
    the ranks are), and for edge ranks summed onto both end atoms (as
    ``score_atoms`` maps them)."""
    key = 'node_att_val' if 'node' in method else 'att_val'
    with torch.no_grad():
        layers = model(batch, capture_aux=True)[1]['layers']
    count = n if key == 'node_att_val' else len(rows)
    slack = np.mean([_near_ties(np, aux[key].float().reshape(-1)[:count]
                                .numpy(), RANK_TIE_TOL)
                     for aux in layers[:10] if key in aux], axis=0)
    if key == 'node_att_val':
        return slack
    atoms = np.zeros(n)
    np.add.at(atoms, rows, slack)
    np.add.at(atoms, cols, slack)
    return atoms


def phase_attribution(torch, np, root: Path, card: str):
    """Attribution on the card. The 7zzp pair parsed by the port's parser;
    ``attribute`` with every method name on the ``readme_softmax_6l`` (K2)
    and ``default_3l`` (K1) runs at their full width, each held against a
    ``--device cpu`` run of the same call within ATTRIBUTION_GATE (a
    method the model has no values for must stop on both); atom masking
    timed by CUDA events (masked variants a second, ms a 32-copy chunk)
    with its launches a chunk; K1/K2 on one chunk's own inputs against
    their plain versions; then ``screen --attribute_top`` over the
    screen's poses. Returns (launches by run, worst kernel errors)."""
    from pointvs_tpu_torch.attribution import attribution_fns as fns
    from pointvs_tpu_torch.attribution.attribution import (attribute,
                                                           model_batch,
                                                           pocket_graph)
    from pointvs_tpu_torch.dataset_generation.types_to_parquet import \
        StructuralFileParser
    from pointvs_tpu_torch.models.load_model import load_model
    from pointvs_tpu_torch.ops import segment_kernels as sk
    from pointvs_tpu_torch.screen import screen
    dev = torch.device('cuda')
    lig_frame = StructuralFileParser('ligand').file_to_parquets(LIG_7ZZP)
    rec_frame = StructuralFileParser('receptor').file_to_parquets(REC_7ZZP)
    check(len(lig_frame) == 9 and (lig_frame.bp == 0).all()
          and len(rec_frame) > 1000 and (rec_frame.bp == 1).all(),
          f'7zzp parsed to {len(lig_frame)} + {len(rec_frame)} atoms')
    _, rows, cols, sample = pocket_graph(REC_7ZZP, LIG_7ZZP, radius=10,
                                         edge_radius=4)
    print(f'attribution: 7zzp parsed: ligand {len(lig_frame)} heavy atoms, '
          f'receptor {len(rec_frame)}; the pocket at 10 A: '
          f'{sample.num_nodes} atoms, {sample.num_edges} edges')
    launches, err = {}, {'k1': 0.0, 'softmax': 0.0}
    for name, per_forward in ATTRIBUTION_RUNS.items():
        run = root / name
        compared, stopped = [], []
        for method in sorted(fns.ATTRIBUTION_FNS):
            scored = {}
            for device in ('cuda', 'cpu'):
                try:
                    scored[device] = attribute(
                        method, run, root / f'attribution_{name}_{device}',
                        rec=REC_7ZZP, lig=LIG_7ZZP, radius=10,
                        edge_radius=4, device=device)
                except (KeyError, ValueError) as exc:
                    scored[device] = type(exc)
            gpu, cpu = scored['cuda'], scored['cpu']
            if isinstance(cpu, type):
                check(gpu is cpu, f'attribution {name} {method}: the CPU '
                                  f'stops ({cpu.__name__}), the card gives '
                                  f'{gpu}')
                stopped.append(method)
                continue
            check(not isinstance(gpu, type),
                  f'attribution {name} {method}: the card stops ({gpu})')
            g, c = gpu.attribution.to_numpy(), cpu.attribution.to_numpy()
            diff = np.abs(g - c)
            gate = np.full(len(c), ATTRIBUTION_GATE)
            if method.startswith('mean_'):
                # Ranks are whole numbers: values within the gate of each
                # other may swap ranks between the two devices.
                cpu_trainer = load_model(run, torch.device('cpu'))[0]
                gate += rank_slack(torch, np, *model_batch(
                    cpu_trainer, sample), method, rows, cols, len(c))
            check(len(g) == sample.num_nodes and np.isfinite(g).all()
                  and (diff <= gate).all(),
                  f'attribution {name} {method}: card against CPU '
                  f'{diff.max()} (gate {gate[diff.argmax()]})')
            compared.append(f'{method} {diff.max():.1e}')
        check(len(compared) >= 7, f'attribution {name}: only {compared}')
        print(f'attribution: {card}: {name}: card against CPU, max |diff| '
              f'by method: {", ".join(compared)}; stopped on both (no such '
              f'values in this model): {", ".join(stopped) or "none"}')

        trainer, _, _ = load_model(run, dev)
        model, batch = model_batch(trainer, sample)
        n_real = sample.num_nodes
        gone = np.eye(batch.node_mask.shape[0], dtype=np.float32)[:n_real]
        chunks = -(-n_real // fns._CHUNK)
        fns._masked_deltas(model, batch, gone, trainer.model_task)   # warm
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        deltas = fns._masked_deltas(model, batch, gone, trainer.model_task)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        counts = sk.launch_counts()
        for kernel, count in counts.items():
            expect = (chunks + 1) * (1 if kernel == 'segment_offsets'
                                     else per_forward.get(kernel, 0))
            check(count == expect, f'attribution {name}: {kernel} launched '
                                   f'{count}, expected {expect}')
        check(np.isfinite(deltas).all(), f'attribution {name}: deltas')
        launches[name] = counts
        tiled = fns._tiled_batch(batch, torch.from_numpy(
            gone[:fns._CHUNK]).to(dev))
        times = []
        with torch.no_grad():
            for _ in range(10):
                s0 = torch.cuda.Event(enable_timing=True)
                s1 = torch.cuda.Event(enable_timing=True)
                s0.record()
                model(tiled)
                s1.record()
                torch.cuda.synchronize()
                times.append(s0.elapsed_time(s1))
            print_profile(f'attribution {name}, one chunk forward',
                          kernel_profile(torch, lambda: model(tiled)),
                          SEGMENT_SHARES, top=6)
            recorded = {}
            originals = {k: _first_call_recorder(sk, k, recorded) for k in
                         ('windowed_segment_sum', 'fused_softmax_aggregate')}
            try:
                model(tiled)
            finally:
                for k, fn in originals.items():
                    setattr(sk, k, fn)
        check(set(recorded) == ({'fused_softmax_aggregate'}
                                if 'softmax_aggregate_sorted' in per_forward
                                else {'windowed_segment_sum'}),
              f'attribution {name}: a chunk called {sorted(recorded)}')
        for key, value in _check_recorded_kernels(
                torch, sk, recorded, f'attribution {name}').items():
            err[key] = max(err[key], value)
        per_chunk = {k: (v - v // (chunks + 1)) / chunks
                     for k, v in counts.items()}
        print(f'attribution: {card}: {name}: atom_masking of {n_real} atoms '
              f'in {chunks} chunks of {fns._CHUNK} copies '
              f'({tiled.node_feats.shape[0]} nodes x '
              f'{tiled.senders.shape[0]} edges a chunk) and the original '
              f'forward: {ms:.3f} ms by CUDA events = '
              f'{n_real / ms * 1e3:.1f} masked variants/s, '
              f'{ms / chunks:.3f} ms a chunk; one chunk forward alone '
              f'{statistics.median(times):.3f} ms (median of 10); launches '
              f'{counts}, per chunk {per_chunk}; K1/K2 on a chunk\'s inputs '
              f'against plain {err}')

    lib = root / 'library'
    out = root / 'attribute_top' / 'hits.csv'
    sk.reset_launch_counts()
    result = screen(root / 'readme_softmax_6l', lib / 'rec_0.parquet',
                    str(lib / 'lig_*.parquet'), output=str(out),
                    batch_size=32, attribute_top=ATTRIBUTE_TOP)
    torch.cuda.synchronize()
    counts = sk.launch_counts()
    csvs = {p.name: p for p in (out.parent / 'top_hit_attributions')
            .glob('*.csv')}
    want = [f'{Path(r["ligand"]).stem}_atom_masking.csv'
            for r in result.rows[:ATTRIBUTE_TOP]]
    check(sorted(csvs) == sorted(want), f'attribute_top wrote {sorted(csvs)}')
    forwards = -(-SCREEN_POSES // 32)
    import pandas as pd
    for name in want:
        frame = pd.read_csv(csvs[name])
        check(len(frame) > 9 and np.isfinite(frame.attribution).all(),
              f'attribute_top: {name} has {len(frame)} rows')
        forwards += -(-len(frame) // fns._CHUNK) + 1
    check(counts.get('softmax_aggregate_sorted') == 6 * forwards,
          f'attribute_top: K2 launched {counts}, expected 6 x {forwards}')
    launches['screen_attribute_top'] = counts
    print(f'attribution: {card}: screen --attribute_top {ATTRIBUTE_TOP} of '
          f'{SCREEN_POSES} poses (readme_softmax_6l, -b 32): screen '
          f'{result.seconds["total"]:.3f} s, attributions '
          f'{result.seconds["attribute"]:.3f} s; launches {counts}')
    return launches, err


# --------------------------------------------------- attribution tail
TAIL_FRAGMENTS = 4
TAIL_MAX_DEG = 10.0      # each fragment rotated about its centroid
TAIL_MAX_SHIFT = 0.5     # and shifted (A)
TAIL_RUNS = ('readme_softmax_6l', 'default_3l')   # hotspot: K2, K1
TAIL_CORE_RUN = 'default_3l'
TAIL_CORE_FRAGMENTS = 2   # of the four, for constrained_attribution
TAIL_SITE_RUN = 'default_3l'
# process_pdb: NHE (one copy, 13 heavy atoms) and the first 2OP site,
# which holds the heavy atoms of all three 2OP copies (the reference's
# merged sites).
TAIL_SITES = ('NHE', '2OP:A')
TAIL_SITE_RADIUS = 8     # the merged 2OP site spans three chains: its
#                          pocket at the default 12 A holds 1,485 atoms
TAIL_AP_RUN = 'default_3l'
TAIL_AP_LIGANDS = 2      # labelled complexes of the synthetic set
TAIL_AP_ATOMS = (3, 4)   # labelled ligand and receptor atoms of each


def write_fragments(np, out: Path, n: int = TAIL_FRAGMENTS) -> list:
    """``n`` seeded rigid copies of the 7zzp ligand (9 heavy atoms), each
    rotated by up to TAIL_MAX_DEG about its centroid and shifted by up to
    TAIL_MAX_SHIFT A, written as SDFs by rewriting the atom block."""
    rng = np.random.default_rng(SEED + 14)
    lines = LIG_7ZZP.read_text().splitlines()
    n_atoms = int(lines[3][:3])
    block = lines[4:4 + n_atoms]
    xyz = np.array([[float(line[c:c + 10]) for c in (0, 10, 20)]
                    for line in block])
    centre = xyz.mean(axis=0)
    out.mkdir(parents=True)
    frags = []
    for i in range(n):
        rot = _rotation(np, rng, TAIL_MAX_DEG)
        shift = rng.standard_normal(3)
        shift *= rng.uniform(0, TAIL_MAX_SHIFT) / np.linalg.norm(shift)
        new = (xyz - centre) @ rot.T + centre + shift
        atoms = [f'{x:10.4f}{y:10.4f}{z:10.4f}{line[30:]}'
                 for (x, y, z), line in zip(new, block)]
        path = out / f'frag_{i}.sdf'
        path.write_text('\n'.join(lines[:4] + atoms + lines[4 + n_atoms:])
                        + '\n')
        frags.append(path)
    return frags


def _ranked_frames_agree(np, got, want, score: str, label: str) -> float:
    """Two rankings (frames sorted best first) from the card and the CPU:
    the same columns and rows; each side's i-th score within
    ATTRIBUTION_GATE of the other's (near ties may swap rows); by
    position, every row's score within the gate and its other columns
    equal. Returns the worst |score difference|."""
    check(list(got.columns) == list(want.columns) and len(got) == len(want)
          and len(want) > 0, f'{label}: {len(got)} rows against '
                             f'{len(want)}')
    worst = 0.0
    others = [c for c in want.columns if c not in (score, 'rank')]
    by_position = [f.sort_values(others, kind='mergesort')
                   for f in (got, want)]
    for g, w in ((got[score], want[score]),
                 (by_position[0][score], by_position[1][score])):
        g, w = g.to_numpy(float), w.to_numpy(float)
        finite = np.isfinite(w)
        check((np.isfinite(g) == finite).all()
              and (g[~finite] == w[~finite]).all(),
              f'{label}: the card and the CPU score other atoms')
        diff = np.abs(g[finite] - w[finite])
        worst = max(worst, float(diff.max(initial=0.0)))
        check((diff <= ATTRIBUTION_GATE).all(),
              f'{label}: {score} differs by {worst}')
    for col in others:
        check((by_position[0][col].to_numpy()
               == by_position[1][col].to_numpy()).all(),
              f'{label}: column {col} differs')
    return worst


def _swap_tol(worst: float) -> float:
    """Two scores may come in either order on the card and the CPU only
    when they lie within twice the worst |card - CPU| of each other."""
    return 2 * worst


def _sdf_rows_agree(np, got: Path, want: Path, scores, tol: float,
                    label: str):
    """An SDF of positioned atoms written from the card's and the CPU's
    rankings: the same header, atom count and trailer, and the same atom
    line in every row whose CPU score (``scores``: the candidates the rows
    were taken from, best first) has no other within ``tol``. Returns
    (rows compared, rows equal, rows)."""
    g = got.read_text().splitlines()
    w = want.read_text().splitlines()
    n = int(w[3][:3])
    ties = _near_ties(np, np.asarray(scores, float), tol)
    same = [i for i in range(n) if ties[i] == 0]
    check(len(g) == len(w) and g[:4] == w[:4] and g[4 + n:] == w[4 + n:]
          and all(g[4 + i] == w[4 + i] for i in same),
          f'{label}: the card\'s and the CPU\'s files differ')
    return len(same), sum(g[4 + i] == w[4 + i] for i in range(n)), n


def _bfactor_pdbs_agree(got: Path, want: Path, label: str) -> int:
    """B-factor PDBs of the card's and the CPU's scores: line for line,
    but for atoms whose two scores (within ATTRIBUTION_GATE) round to
    neighbouring steps of the two-decimal B-factor column. Returns the
    number of such lines."""
    g = got.read_text().splitlines()
    w = want.read_text().splitlines()
    check(len(g) == len(w), f'{label}: {len(g)} lines against {len(w)}')
    stepped = 0
    for a, b in zip(g, w):
        if a != b:
            check(a[:60] == b[:60] and a[66:] == b[66:]
                  and abs(float(a[60:66]) - float(b[60:66])) < 0.0101,
                  f'{label}: lines differ: {a!r} / {b!r}')
            stepped += 1
    return stepped


def _top_n_plain(np, scores, rmsds, n: int, threshold: float = 2.0):
    """Whether a pose within ``threshold`` is among the ``n`` best-scored
    (stable order), computed apart from ``Ranking``."""
    order = np.argsort(-np.asarray(scores), kind='stable')
    return float((np.asarray(rmsds)[order[:n]] <= threshold).any())


def write_labelled_synthpharm(np, root: Path, data: Path, types: Path):
    """The synthetic-pharmacophore copy of the pose set in ``root/data``
    with each ligand renamed ``lig<NN>.parquet`` (the AP statistics take
    a ligand's index from the digits after 'lig'), ``labels.yaml``
    marking TAIL_AP_LIGANDS seeded ligands and ``atomic_labels.yaml``
    with TAIL_AP_ATOMS seeded ligand and receptor atoms of each, as
    ``coords_to_string`` keys of the item's coordinates. Returns (types
    file, {labelled index: (receptor flags, labels) of its atoms})."""
    from pointvs_tpu_torch.data.dataset import SynthPharmDataset
    from pointvs_tpu_torch.utils import coords_to_string, save_yaml
    rng = np.random.default_rng(SEED + 15)
    sp_types = write_synthpharm_set(np, data, types, out=root / 'data')
    lines = []
    for line in sp_types.read_text().splitlines():
        lig = line.split()[-1]
        renamed = lig.replace('lig_', 'lig')
        (root / 'data' / lig).rename(root / 'data' / renamed)
        lines.append(line[:-len(lig)] + renamed)
    sp_types.write_text('\n'.join(lines) + '\n')
    labelled = sorted(rng.choice(len(lines), TAIL_AP_LIGANDS,
                                 replace=False).tolist())
    ds = SynthPharmDataset(root / 'data', sp_types, compact=True,
                           polar_hydrogens=False)
    atomic, atoms = {}, {}
    for i in labelled:
        item = ds[i]
        bp = item.node_feats[:, :3].sum(axis=1) > 0
        picks = np.r_[rng.choice(np.flatnonzero(~bp), TAIL_AP_ATOMS[0],
                                 replace=False),
                      rng.choice(np.flatnonzero(bp), TAIL_AP_ATOMS[1],
                                 replace=False)]
        atomic[i] = [coords_to_string(item.coords[j]) for j in picks]
        atoms[i] = (bp, np.isin(np.arange(len(bp)), picks))
    save_yaml({i: int(i in labelled) for i in range(len(lines))},
              root / 'labels.yaml')
    save_yaml(atomic, root / 'atomic_labels.yaml')
    return sp_types, atoms


def _mixed_near_tie(np, scores, labels, tol: float) -> bool:
    """Whether a labelled and an unlabelled atom score within ``tol`` of
    each other: only such a pair can change an average precision or a
    first-hit rank when the card and the CPU order it differently."""
    pos, neg = scores[labels], scores[~labels]
    return bool((np.abs(pos[:, None] - neg[None, :]) <= tol).any())


def phase_attribution_tail(torch, np, root: Path, types: Path, card: str):
    """The attribution and analysis tail on the card, each entry point
    against a ``--device cpu`` run of the same call within
    ATTRIBUTION_GATE: the hotspot CLI on four seeded fragments of the 7zzp
    ligand with both runs (K2 / K1), its launches counted and K1/K2 on a
    masking chunk's own inputs against their plain versions;
    ``constrained_attribution`` with the 7zzp ligand as the core;
    ``score_and_colour_pdb`` on the PDB's own NHE and 2OP sites; the AP
    statistics (``get_stats_from_dir``) of a labelled synthetic-
    pharmacophore copy of the pose set; ``parse_results`` and TopN of the
    serving phase's predictions. Returns (launches by entry point, worst
    kernel errors)."""
    import pandas as pd
    from pointvs_tpu_torch.analysis.pose_selection import parse_results
    from pointvs_tpu_torch.analysis.synthpharm_atomic_auc import \
        get_stats_from_dir
    from pointvs_tpu_torch.attribution import attribution_fns as fns
    from pointvs_tpu_torch.attribution import hotspot
    from pointvs_tpu_torch.attribution.attribution import model_batch, \
        pocket_graph
    from pointvs_tpu_torch.attribution.constrained_attribution import \
        constrained_attribution
    from pointvs_tpu_torch.attribution.process_pdb import \
        score_and_colour_pdb
    from pointvs_tpu_torch.models.load_model import load_model
    from pointvs_tpu_torch.ops import segment_kernels as sk
    dev = torch.device('cuda')
    tail = root / 'attribution_tail'
    frags = write_fragments(np, tail / 'fragments')
    sizes = [pocket_graph(REC_7ZZP, f, radius=12, edge_radius=4)[3]
             for f in frags]
    n_real = [s.num_nodes for s in sizes]
    forwards = sum(-(-n // fns._CHUNK) + 1 for n in n_real)
    edges_one = max(s.num_edges for s in sizes)
    launches, err = {}, {'k1': 0.0, 'softmax': 0.0}
    part_s = {}

    # 1. the hotspot CLI, each run on the card and the CPU
    for name in TAIL_RUNS:
        part = time.perf_counter()
        per_forward = ATTRIBUTION_RUNS[name]
        out = {d: tail / f'hotspot_{name}_{d}' for d in ('cuda', 'cpu')}
        argv = [str(root / name), str(REC_7ZZP)] + [str(f) for f in frags] \
            + ['--apo_protein', str(REC_7ZZP)]
        recorded = {}
        originals = {k: _first_call_recorder(
            sk, k, recorded,
            keep=lambda args: args[0].shape[0] > 8 * edges_one)
            for k in ('windowed_segment_sum', 'fused_softmax_aggregate')}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        try:
            torch.cuda.synchronize()
            sk.reset_launch_counts()
            wall = time.perf_counter()
            start.record()
            hotspot.main(argv + ['-o', str(out['cuda'])])
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - wall
            # Read while the recorders stand: they hold the counts.
            counts = sk.launch_counts()
        finally:
            for k, fn in originals.items():
                setattr(sk, k, fn)
        ms = start.elapsed_time(end)
        for kernel, count in counts.items():
            expect = forwards * (1 if kernel == 'segment_offsets'
                                 else per_forward.get(kernel, 0))
            check(count == expect, f'hotspot {name}: {kernel} launched '
                                   f'{count}, expected {expect}')
        launches[f'hotspot_{name}'] = counts
        check(set(recorded) == ({'fused_softmax_aggregate'}
                                if 'softmax_aggregate_sorted' in per_forward
                                else {'windowed_segment_sum'}),
              f'hotspot {name}: a chunk called {sorted(recorded)}')
        chunk_err = _check_recorded_kernels(torch, sk, recorded,
                                            f'hotspot {name}')
        for key, value in chunk_err.items():
            err[key] = max(err[key], value)
        # The masking alone of the first fragment, by CUDA events.
        model, batch = model_batch(load_model(root / name, dev)[0],
                                   sizes[0])
        fns.atom_masking(model, batch)
        torch.cuda.synchronize()
        start.record()
        fns.atom_masking(model, batch)
        end.record()
        torch.cuda.synchronize()
        mask_ms = start.elapsed_time(end)
        cpu_wall = time.perf_counter()
        hotspot.main(argv + ['-o', str(out['cpu']), '--device', 'cpu'])
        cpu_wall = time.perf_counter() - cpu_wall

        got = {d: {f: pd.read_csv(out[d] / f) for f in (
            'hotspot_ranks.csv', 'pharmacophores.csv',
            'typed_pharmacophores.csv')} for d in out}
        worst = {f: _ranked_frames_agree(
            np, got['cuda'][f], got['cpu'][f],
            'score' if f.startswith('typed') else 'mean_attribution',
            f'hotspot {name} {f}') for f in got['cpu']}
        ranks, typed = (got['cpu']['hotspot_ranks.csv'],
                        got['cpu']['typed_pharmacophores.csv'])
        # Pocket atoms outside the standard residues are not typed.
        check(len(ranks) > 300 and (ranks.n_complexes == TAIL_FRAGMENTS)
              .sum() > 100 and 300 < np.isfinite(typed.score).sum()
              <= len(ranks), f'hotspot {name}: {len(ranks)} ranked atoms, '
                             f'{np.isfinite(typed.score).sum()} typed')
        compared = {}
        rank_tol = _swap_tol(worst['hotspot_ranks.csv'])
        typed_tol = _swap_tol(worst['typed_pharmacophores.csv'])
        for fname, scores, tol in (
                ('hotspots.sdf', ranks.mean_attribution[
                    ranks.n_complexes >= 2], rank_tol),
                ('hba.sdf', typed.score[typed.pharmacophore == 'hba'],
                 typed_tol),
                ('hbd.sdf', typed.score[typed.pharmacophore == 'hbd'],
                 typed_tol)):
            compared[fname] = _sdf_rows_agree(
                np, out['cuda'] / fname, out['cpu'] / fname, scores, tol,
                f'hotspot {name} {fname}')
        check(compared['hotspots.sdf'][2] == 20
              and compared['hba.sdf'][2] == 7,
              f'hotspot {name}: SDF rows {compared}')
        part_s[f'hotspot_{name}'] = time.perf_counter() - part
        print(f'attribution tail: {card}: hotspot {name}: '
              f'{TAIL_FRAGMENTS} fragments (pockets at 12 A of {n_real} '
              f'atoms; {forwards} forwards of up to {fns._CHUNK} copies): '
              f'wall {wall:.3f} s = {wall / TAIL_FRAGMENTS:.3f} s a fragment '
              f'on the card (CPU {cpu_wall / TAIL_FRAGMENTS:.3f} s); '
              f'{ms:.3f} ms by CUDA events = {sum(n_real) / ms * 1e3:.1f} '
              f'masked variants/s (the masking of fragment 0 alone: '
              f'{mask_ms:.3f} ms = {n_real[0] / mask_ms * 1e3:.1f}/s); '
              f'launches {counts}, per fragment '
              f'{ {k: v / TAIL_FRAGMENTS for k, v in counts.items() if v} }; '
              f'{len(ranks)} ranked atoms, card against CPU max |diff| '
              f'{max(worst.values()):.2e}; SDF rows compared (no other '
              f'score within twice that) / equal / written '
              f'{compared}; K1/K2 on a chunk\'s inputs against plain '
              f'{chunk_err}')

    # 2. constrained attribution with the 7zzp ligand as the core
    part = time.perf_counter()
    frames = {}
    for device in ('cuda', 'cpu'):
        sk.reset_launch_counts()
        frames[device] = constrained_attribution(
            root / TAIL_CORE_RUN, REC_7ZZP, frags[:TAIL_CORE_FRAGMENTS],
            core_lig=LIG_7ZZP, device=device)
        if device == 'cuda':
            torch.cuda.synchronize()
            launches['constrained_attribution'] = sk.launch_counts()
    gpu, cpu = frames['cuda'], frames['cpu']
    diff = float(np.abs(gpu.attribution - cpu.attribution).max())
    check(len(gpu) == 9 * TAIL_CORE_FRAGMENTS and (gpu.bp == 0).all()
          and diff <= ATTRIBUTION_GATE
          and (gpu.core_distance == cpu.core_distance).all()
          and gpu.core_distance.between(0, TAIL_MAX_SHIFT + 1.0).all(),
          f'constrained_attribution: {len(gpu)} rows, |diff| {diff}')
    print(f'attribution tail: {card}: constrained_attribution '
          f'({TAIL_CORE_RUN}, {TAIL_CORE_FRAGMENTS} fragments, core = the 7zzp '
          f'ligand): {len(gpu)} ligand atoms, core distances '
          f'{gpu.core_distance.min():.3f}-{gpu.core_distance.max():.3f} A '
          f'(equal on both), max |card - CPU| {diff:.2e}; launches '
          f'{launches["constrained_attribution"]}')
    part_s['constrained_attribution'] = time.perf_counter() - part

    # 3. the PDB's own ligand sites
    part = time.perf_counter()
    site_ms = {}
    outs = {}
    for device in ('cuda', 'cpu'):
        trainer = load_model(root / TAIL_SITE_RUN, torch.device(device))[0]
        outs[device] = tail / f'sites_{device}'
        for site in TAIL_SITES:
            sk.reset_launch_counts()
            start = time.perf_counter()
            written = score_and_colour_pdb(
                trainer, fns.atom_masking, REC_7ZZP, outs[device],
                radius=TAIL_SITE_RADIUS, only_process=site)
            if device == 'cuda':
                torch.cuda.synchronize()
                site_ms[site] = (time.perf_counter() - start) * 1e3
                launches[f'process_pdb_{site}'] = sk.launch_counts()
            check(len(written) == 1, f'process_pdb {site}: {written}')
    parts = []
    for csv in sorted(outs['cpu'].glob('*_scores.csv')):
        site = csv.name[:-len('_scores.csv')]
        g = pd.read_csv(outs['cuda'] / csv.name)
        c = pd.read_csv(csv)
        diff = float(np.abs(g.attribution - c.attribution).max())
        check(list(g.columns) == list(c.columns) and len(g) == len(c)
              and diff <= ATTRIBUTION_GATE and (g.drop(columns='attribution')
                                                == c.drop(columns=
                                                          'attribution'))
              .all().all(), f'process_pdb {site}: |diff| {diff}')
        stepped = _bfactor_pdbs_agree(outs['cuda'] / f'{site}_scored.pdb',
                                      outs['cpu'] / f'{site}_scored.pdb',
                                      f'process_pdb {site}')
        parts.append(f'{site}: {(c.bp == 0).sum()} ligand + '
                     f'{(c.bp == 1).sum()} pocket atoms, max |card - CPU| '
                     f'{diff:.2e}, B-factor lines on the next 0.01 step '
                     f'{stepped}')
    check(len(parts) == len(TAIL_SITES), f'process_pdb wrote {parts}')
    print(f'attribution tail: {card}: process_pdb score_and_colour_pdb '
          f'({TAIL_SITE_RUN}, {TAIL_SITE_RADIUS} A): {"; ".join(parts)}; '
          f'ms a site on the card '
          f'{json.dumps({k: round(v, 1) for k, v in site_ms.items()})}; '
          f'launches '
          f'{ {k: v for k, v in launches.items() if "process" in k} }')
    part_s['process_pdb'] = time.perf_counter() - part

    # 4. AP statistics of a labelled synthetic-pharmacophore set
    part = time.perf_counter()
    sp_types, atoms = write_labelled_synthpharm(
        np, tail / 'synthpharm', types.parent, types)
    labelled = sorted(atoms)
    stats, scores = {}, {}
    for device in ('cuda', 'cpu'):
        scores[device] = []

        def recorded(model, batch, task=None, _to=scores[device]):
            _to.append(fns.atom_masking(model, batch, task=task))
            return _to[-1]
        sk.reset_launch_counts()
        stats[device] = get_stats_from_dir(
            root / TAIL_AP_RUN, sp_types.parent, sp_types, recorded,
            device=device)
        if device == 'cuda':
            torch.cuda.synchronize()
            launches['synthpharm_ap'] = sk.launch_counts()
    gpu, cpu = stats['cuda'], stats['cpu']
    check(len(cpu[1]) == len(cpu[3]) == TAIL_AP_LIGANDS
          and gpu[0] == cpu[0] and gpu[2] == cpu[2],
          f'synthpharm AP: {len(cpu[1])} ligand APs, baselines differ')
    untied = []
    for i, (g_s, c_s) in enumerate(zip(scores['cuda'], scores['cpu'])):
        diff = float(np.abs(g_s - c_s).max())
        check(diff <= ATTRIBUTION_GATE,
              f'synthpharm AP: complex {i} scores differ by {diff}')
        bp, labels = atoms[labelled[i]]
        # (side, its AP list, its first-hit list) in the statistics
        for side, ap, first in (('ligand', 1, 4), ('receptor', 3, 5)):
            atom_side = bp if side == 'receptor' else ~bp
            if not _mixed_near_tie(np, c_s[atom_side], labels[atom_side],
                                   _swap_tol(diff)):
                untied.append(f'{labelled[i]} {side}')
                check(gpu[ap][i] == cpu[ap][i]
                      and gpu[first][i] == cpu[first][i],
                      f'synthpharm AP: complex {labelled[i]} {side} '
                      f'differs with no near tie')
    print(f'attribution tail: {card}: synthpharm AP ({TAIL_AP_RUN}, '
          f'complexes {labelled} labelled): ligand AP '
          f'{np.round(gpu[1], 6).tolist()} (random '
          f'{np.round(gpu[0], 4).tolist()}), receptor AP '
          f'{np.round(gpu[3], 6).tolist()} (random '
          f'{np.round(gpu[2], 4).tolist()}); first-hit ranks '
          f'{[int(r) for r in gpu[4]]} / {[int(r) for r in gpu[5]]}; '
          f'equal to the CPU\'s on the sides without a labelled-unlabelled '
          f'near tie: {untied}; launches {launches["synthpharm_ap"]}')

    part_s['synthpharm_ap'] = time.perf_counter() - part

    # 5. pose selection on the serving phase's predictions
    rows = [line.split() for line in types.read_text().splitlines()]
    rmsd = {int(r[4].split('_')[-1].split('.')[0]): float(r[2])
            for r in rows}
    info = {'rec_0': {'docked_wrt_crystal': rmsd}}
    preds = root / 'readme_softmax_6l' / 'pose_gpu.txt'
    ranking = parse_results(preds, rmsd_info=info)
    served = [line.split() for line in preds.read_text().splitlines()]
    pred_scores = [float(r[2]) for r in served]
    pred_rmsds = [rmsd[int(Path(r[4]).stem.split('_')[-1])] for r in served]
    top = [ranking.get_top_n(n) for n in range(1, 11)]
    check(len(ranking.sorted_scores_and_rmsds) == 1
          and len(ranking.sorted_scores_and_rmsds[0]) == len(rows)
          and top == [_top_n_plain(np, pred_scores, pred_rmsds, n)
                      for n in range(1, 11)],
          f'pose selection: TopN {top}')
    print(f'attribution tail: pose selection of {preds.name} ({len(served)} '
          f'poses, readme_softmax_6l): TopN(1..10) at 2 A {top}; mean RMSD '
          f'of the top pose {ranking.get_mean_top_ranked_rmsd():.3f} A')
    print(f'attribution tail: wall seconds by part (card and CPU runs) '
          f'{json.dumps({k: round(v, 1) for k, v in part_s.items()})}')
    return launches, err


# ------------------------------------------------------- dropout mask
DROPOUT_RATE = 0.1
DROPOUT_SOURCE = 'pointvs_tpu_torch/ops/csrc/threefry_dropout.cu'
# Not a TPU kernel: the flax Dropout whose mask it draws (lucid's MLPs).
DROPOUT_REPLACES = 'pointvs_tpu/models/layers.py:109'


def lucid_site_shapes(root: Path, types: Path):
    """lucid's three dropout sites a layer on the first real pose batch
    (k=32, 2 fourier features, as LUCID_6L): the edge MLP's first Linear
    [E_pad, 2 * (2 * 2 + 3 + 1 + 2k)], the coordinate MLP's [E_pad, 4k]
    and the node MLP's [N_pad, 2k]."""
    from pointvs_tpu_torch.data.loader import get_data_loader
    batch = next(iter(get_data_loader(
        types.parent, types, batch_size=32, radius=10, edge_radius=4,
        polar_hydrogens=False, prefetch=0, mode='val')))[0]
    e, n = batch.senders.shape[0], batch.node_feats.shape[0]
    k = MODEL_KWARGS['k']
    return {'edge': (e, 2 * (2 * LUCID_6L['fourier_features'] + 4 + 2 * k)),
            'coors': (e, 4 * k), 'node': (n, 2 * k)}


def phase_dropout_kernel(torch, np, root: Path, types: Path):
    """The dropout-mask kernel against its plain version on the card, on
    lucid's real site shapes: masks and values bit for bit, forward and
    backward; the node site's mask against the host's numpy threefry
    (``ops/prng.bernoulli``, JAX's bits); a size that is not a multiple of
    4 and a misaligned view (the scalar path). Each site timed against its
    bound (8 bytes an entry, or OPS_PER_ENTRY integer operations at the
    f32 rate) and its plain version."""
    from pointvs_tpu_torch.ops import dropout as dr
    from pointvs_tpu_torch.ops import prng
    dev = torch.device('cuda')
    rng = np.random.default_rng(SEED + 5)
    keep = float(np.float32(1 - DROPOUT_RATE))
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    for name, info in dr.kernel_info().items():
        print(f'dropout kernel: {name}: {info}')
    err, timings = 0.0, {}
    shapes = lucid_site_shapes(root, types)
    for site, shape in shapes.items():
        key = prng.lucid_site_key(prng.step_key(SEED, 3), 1, site, 6, True)
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).requires_grad_()
        got = dr.threefry_dropout(x, key, DROPOUT_RATE)
        grad = torch.randn_like(got)
        got.backward(grad)
        want = dr.threefry_dropout_plain(x.detach(), key, DROPOUT_RATE)
        want_grad = dr.threefry_dropout_plain(grad, key, DROPOUT_RATE)
        again = dr.threefry_dropout(x.detach(), key, DROPOUT_RATE)
        torch.cuda.synchronize()
        check(torch.equal(got == 0, want == 0),
              f'dropout {site}: kernel and plain masks differ')
        check(torch.equal(got, want) and torch.equal(x.grad, want_grad)
              and torch.equal(got, again),
              f'dropout {site}: kernel values or gradient differ from '
              f'plain')
        err = max(err, (got - want).abs().max().item())
        dropped = float((got == 0).float().mean())
        if site == 'node':
            host = prng.bernoulli(key, keep, shape)
            check(np.array_equal((got != 0).cpu().numpy(), host),
                  'dropout: the node mask is not the host threefry draw')
        xd = x.detach()
        launch = lambda: dr.threefry_dropout(  # noqa: E731
            xd, key, DROPOUT_RATE)
        n = xd.numel()
        v = dict(ms=time_cuda(torch, launch, flush),
                 device_ms=profiled_ms(torch, launch, flush,
                                       'threefry_dropout'),
                 plain_ms=time_cuda(torch, lambda: dr.threefry_dropout_plain(
                     xd, key, DROPOUT_RATE), flush),
                 # torch's own dropout draws another (Philox) mask: a
                 # yardstick of speed only, not the same function.
                 torch_dropout_ms=time_cuda(
                     torch, lambda: torch.nn.functional.dropout(
                         xd, DROPOUT_RATE), flush),
                 library_ms=None,
                 bound=bound_ms(8 * n, dr.OPS_PER_ENTRY * n))
        timings[f'dropout_{site}'] = v
        print(f'dropout kernel: site {site} {list(shape)} ({n} entries) '
              f'dropped {dropped:.4f} ms={v["ms"]:.4f} (profiler device '
              f'time {v["device_ms"]:.4f}) plain_ms={v["plain_ms"]:.4f} '
              f'bound_ms={v["bound"][0]:.4f} ({v["bound"][1]}) '
              f'share_of_bound={v["bound"][0] / v["ms"]:.3f} '
              f'torch.nn.functional.dropout (another mask) '
              f'{v["torch_dropout_ms"]:.4f} ms; masks, values and '
              f'gradients equal to plain')
    key = prng.step_key(SEED, 9)
    for label, x in (('odd size', torch.randn(1001, 3, device=dev)),
                     ('misaligned', torch.randn(4097, device=dev)[1:])):
        got = dr.threefry_dropout(x, key, DROPOUT_RATE)
        check(torch.equal(got, dr.threefry_dropout_plain(
            x, key, DROPOUT_RATE)), f'dropout: {label} differs from plain')
    print(f'dropout kernel: odd size and misaligned view equal to plain; '
          f'max_abs_err {err:.2e}')
    return err, timings


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
    # Fused K1 per layer: gather_dst's backward, gather_src(coord)'s (none
    # in the first layer, whose coordinates need no gradient), the edge
    # pass's d_h and the coordinate mean.
    check(fused['fused_edge_forward'] == expect
          and fused['fused_edge_backward'] == expect
          and fused['segment_sum_sorted'] == (4 * layers - 1) * TRAIN_STEPS
          and fused['softmax_aggregate_sorted'] == 0,
          f'fused path launches {fused}, expected K3 = K4 = {expect}, K1 = '
          f'{(4 * layers - 1) * TRAIN_STEPS}')
    for name in ('module_cuda', 'fused_cuda'):
        check(launches[name]['segment_offsets'] <= 2 * TRAIN_STEPS,
              f'{name}: {launches[name]["segment_offsets"]} offset '
              f'computations in {TRAIN_STEPS} steps')
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
                       ('K4', 'fused_edge_backward')] + SEGMENT_SHARES
                      if fused_path else SEGMENT_SHARES)
    return {'k1': module['segment_sum_sorted'],
            'k2': module['softmax_aggregate_sorted'],
            'k3': fused['fused_edge_forward'],
            'k4': fused['fused_edge_backward']}


# ----------------------------------------------------------------- 7
CLI_FLAGS = ['--layers', '6', '-k', '32', '--egnn_attention',
             '--softmax_attention', '--egnn_residual', '--egnn_normalise',
             '--egnn_tanh', '--graphnorm', '--compact', '-b', '32', '-ep',
             '2', '--augmented_actives', '1', '--dropout', '0.1',
             '--radius', '10', '--edge_radius', '4']
CLI_RUN_FILES = ('cmd_args.yaml', 'model_kwargs.yaml', 'output.log',
                 'metrics.jsonl', 'checkpoints/pose_ckpt_epoch_1.pt',
                 'checkpoints/pose_ckpt_epoch_2.pt', 'pose_predictions.txt',
                 'pose_predictions_epoch_1.txt', '_FINISHED')


def cli_argv(run: Path, types: Path, device: str, validate=True,
             extra=()):
    data = str(types.parent)
    argv = ['egnn', str(run), '--train_data_root_pose', data,
            '--train_types_pose', str(types)] + CLI_FLAGS
    if validate:
        argv += ['--test_data_root_pose', data, '--test_types_pose',
                 str(types), '--val_on_epoch_end', '--top1', '--end_flag']
    return argv + ['--device', device] + list(extra)


def _remat_grad_diff(torch, trainer, types: Path):
    """max |grad with remat - grad without| over the parameters, for one
    training forward and backward with dropout on a batch of 32 poses."""
    from pointvs_tpu_torch.data.buckets import to_device
    from pointvs_tpu_torch.data.loader import get_data_loader
    from pointvs_tpu_torch.models.registry import build_model
    from pointvs_tpu_torch.training.losses import loss_fn
    batch = next(iter(get_data_loader(
        types.parent, types, batch_size=32, radius=10, edge_radius=4,
        polar_hydrogens=False, prefetch=0)))[0]
    batch = to_device(batch, trainer.device)
    grads = []
    for remat in (False, True):
        model = build_model('egnn', **dict(trainer.model_kwargs,
                                           remat=remat))
        model.load_state_dict(trainer.model.state_dict())
        model.to(trainer.device).train()
        loss_sum, weight = loss_fn(model(batch, train=True,
                                         dropout_seed=0xC0FFEE),
                                   batch, 'classification')
        (loss_sum / torch.clamp_min(weight, 1.0)).backward()
        grads.append([p.grad for p in model.parameters()])
    return max(float((a - b).abs().max()) for a, b in zip(*grads))


def phase_training_cli(torch, np, root: Path, types: Path, card: str):
    from torch.profiler import ProfilerActivity, profile
    from pointvs_tpu_torch.main import main as train_main
    from pointvs_tpu_torch.ops import segment_kernels as sk
    layers = 6
    run = root / 'cli_cuda'
    sk.reset_launch_counts()
    start = time.perf_counter()
    gpu = train_main(cli_argv(run, types, 'cuda'))
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = sk.launch_counts()
    missing = [f for f in CLI_RUN_FILES if not (run / f).exists()]
    check(not missing, f'training CLI: run directory lacks {missing}')
    items = 64 + 32   # the poses and one augmented copy of each active
    steps = len(gpu.train_losses)
    check(steps == 2 * 3, f'training CLI: {steps} steps, expected 2 x 3')
    val_batches = 4   # 64 poses at batch 32, after epoch 1 and at the end
    check(counts['softmax_aggregate_sorted'] == layers * (steps
                                                          + val_batches)
          and counts['segment_sum_sorted'] >= layers * steps
          and counts['fused_edge_forward'] == 0
          and counts['fused_edge_backward'] == 0,
          f'training CLI launches {counts}: expected K2 = {layers} x '
          f'({steps} steps + {val_batches} validation forwards), K1 >= '
          f'{layers * steps}, no K3/K4')
    check(counts['segment_offsets'] <= steps + val_batches,
          f'training CLI: {counts["segment_offsets"]} offset computations '
          f'for {steps + val_batches} batches')
    logged = [json.loads(line)['Loss (train, pose)']
              for line in (run / 'metrics.jsonl').read_text().splitlines()
              if 'Loss (train, pose)' in line]
    check(logged and np.isfinite(logged).all()
          and np.isfinite(gpu.train_losses).all(),
          f'training CLI: losses {gpu.train_losses}, logged {logged}')

    cpu = train_main(cli_argv(root / 'cli_cpu', types, 'cpu'))
    diff = float(np.abs(np.subtract(gpu.train_losses,
                                    cpu.train_losses)).max())
    check(np.allclose(gpu.train_losses, cpu.train_losses, **TRAJ_TOL),
          f'training CLI: GPU and CPU trajectories differ by {diff}')

    # Resume to epoch 3 as a user would, in a process of its own.
    cmd_args = (run / 'cmd_args.yaml').read_text()
    check('epochs_pose: 2' in cmd_args, 'cmd_args.yaml lacks epochs_pose')
    (run / 'cmd_args.yaml').write_text(
        cmd_args.replace('epochs_pose: 2', 'epochs_pose: 3'))
    resumed = subprocess.run(
        [sys.executable, '-m', 'pointvs_tpu_torch.resume_training',
         str(run)], cwd=REPO, capture_output=True, text=True, timeout=600)
    ckpt = run / 'checkpoints' / 'pose_ckpt_epoch_3.pt'
    check(resumed.returncode == 0 and ckpt.exists(),
          f'resume_training exited {resumed.returncode}:\n'
          f'{resumed.stderr[-3000:]}')
    p_epoch = torch.load(ckpt, map_location='cpu')['p_epoch']
    check(p_epoch == 3, f'resumed checkpoint holds p_epoch {p_epoch}')

    remat_diff = _remat_grad_diff(torch, gpu, types)
    check(remat_diff <= 1e-6, f'--remat changes gradients by {remat_diff}')

    # Device time of the steps: the training alone (no validation) under
    # the profiler, in a run of its own.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = train_main(cli_argv(root / 'cli_profiled', types, 'cuda',
                                       validate=False))
        torch.cuda.synchronize()
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    ) / 1e3 / len(profiled.train_losses)
    # The same training without the loader's producer thread: its
    # featurisation then no longer runs beside the steps' dispatch.
    serial = train_main(cli_argv(root / 'cli_prefetch0', types, 'cuda',
                                 validate=False, extra=['--prefetch', '0']))
    serial_ms = np.asarray(serial.step_ms())
    ms = np.asarray(gpu.step_ms())
    epoch_s = gpu.epoch_seconds
    host = [1 - steps / 2 * device_ms / (1e3 * s) for s in epoch_s]
    print(f'training CLI: {card}: {steps} steps, wall {wall:.3f} s '
          f'(featurisation, training, validation, checkpoints); launches '
          f'{counts}; losses {gpu.train_losses}; max|gpu - cpu| loss '
          f'{diff:.3e}; resumed to p_epoch {p_epoch}; max|remat - plain| '
          f'grad {remat_diff:.3e}')
    print(f'training CLI: {card}: step_ms median {np.median(ms):.3f} p90 '
          f'{np.percentile(ms, 90):.3f} (CUDA events, {len(ms)} steps of '
          f'32 graphs) {ms.round(3).tolist()}; epoch wall s '
          f'{[round(s, 3) for s in epoch_s]} (epoch 1 featurises); poses '
          f'per s {[round(items / s, 1) for s in epoch_s]}; device ms per '
          f'step {device_ms:.3f} (profiled run); host share of the epoch '
          f'{[round(h, 3) for h in host]}')
    print(f'training CLI: {card}: with --prefetch 0 step_ms median '
          f'{np.median(serial_ms):.3f} p90 {np.percentile(serial_ms, 90):.3f} '
          f'{serial_ms.round(3).tolist()}; epoch wall s '
          f'{[round(s, 3) for s in serial.epoch_seconds]}')
    return counts


# ------------------------------------------------------ device dataset
DD_CONFIGS = {   # name -> (model flags, fused training)
    'readme_softmax_6l': (README_6L, False),
    'readme_softmax_6l_fused': (README_6L, True),
    'default_3l': (dict(num_layers=3), False),
}
DD_EPOCHS = 3    # 2 weighted-sampled steps an epoch over the 64 poses
DD_FIELDS_RTOL = 1e-5    # main --device_cache on against off, scores


def _check_recorded_fused(torch, recorded: dict, label: str) -> dict:
    """K3 and K4 on the inputs a step gave them, against their plain
    versions (K3's evaluated in float64); their worst |kernel - plain|."""
    from pointvs_tpu_torch.ops import fused_egnn as k3
    from pointvs_tpu_torch.ops import fused_egnn_bwd as k4
    err = {}
    if 'fused_edge_forward' in recorded:
        args, kwargs = recorded['fused_edge_forward']
        got = k3.fused_edge_forward(*args, **kwargs)
        want = [w.float() for w in k3.fused_edge_forward_plain(
            *[_as_double(torch, a) for a in args], **kwargs)]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(torch.allclose(g, w, **TOL),
                  f'{label}: K3 disagrees with plain on the step\'s inputs')
        err['k3'] = max((g - w).abs().max().item() for g, w in zip(got,
                                                                    want))
    if 'fused_edge_backward' in recorded:
        args, kwargs = recorded['fused_edge_backward']
        got = k4.fused_edge_backward(*args, **kwargs)
        want = k4.fused_edge_backward_plain(*args, **kwargs)
        torch.cuda.synchronize()
        worst = 0.0
        for g, w in zip(got[:4], want[:4]):
            if w is None:
                continue
            check(torch.allclose(g, w, **TOL),
                  f'{label}: K4 disagrees with plain on the step\'s inputs')
            worst = max(worst, (g - w).abs().max().item())
        for p in k3.PARAM_NAMES:
            g, w = got[4][p], want[4][p]
            scale = max(1.0, w.abs().max().item())
            check(torch.allclose(g, w, atol=3e-5 * scale, rtol=0),
                  f'{label}: K4 d_{p} disagrees with plain')
            worst = max(worst, (g - w).abs().max().item() / scale)
        err['k4'] = worst
    return err


def _assert_batches_equal(torch, got, want, label):
    for field in want._fields:
        w, g = getattr(want, field), getattr(got, field)
        if w is None:
            check(g is None, f'{label}: {field} present on one side only')
            continue
        check(g.dtype == w.dtype and g.shape == w.shape
              and torch.equal(g, w), f'{label}: {field} differs')


def phase_device_dataset(torch, np, root: Path, types: Path, card: str):
    """The device-resident dataset on the card: the store of the 64-pose
    set built and uploaded (MB, ms); every batch of a validation and a
    training pass collated from ids on the card and held field by field
    against the host collation moved to the card; the rotations against
    the CPU's; the README model (module path, K2; fused path, K3/K4) and
    ``default_3l`` (K1) trained ``DD_EPOCHS`` epochs from ids and from
    the stream in turns, the trajectories within the gate, every kernel
    of the ids steps held against its plain version on the inputs the
    step gave it, step ms and an epoch's host share for both; ``main
    --device_cache on`` against ``off`` with augmented actives (the hybrid
    tail), predictions within 1e-5; peak memory. Returns the ids paths'
    launches by kernel."""
    from torch.profiler import ProfilerActivity, profile
    from pointvs_tpu_torch.data import device_dataset as dd
    from pointvs_tpu_torch.data.buckets import to_device
    from pointvs_tpu_torch.data.dataset import PointCloudDataset
    from pointvs_tpu_torch.data.loader import GraphDataLoader
    from pointvs_tpu_torch.main import main as train_main
    from pointvs_tpu_torch.ops import fused_egnn as k3
    from pointvs_tpu_torch.ops import fused_egnn_bwd as k4
    from pointvs_tpu_torch.ops import segment_kernels as sk
    from pointvs_tpu_torch.training.engine import Trainer
    dev = torch.device('cuda')
    torch.cuda.reset_peak_memory_stats()
    ds = PointCloudDataset(types.parent, types, radius=10, edge_radius=4,
                           compact=True, polar_hydrogens=False,
                           model_task='classification')
    start = time.perf_counter()
    host = dd.build_host_store(ds)
    built = time.perf_counter()
    store = dd.DeviceGraphStore(host, dev)
    torch.cuda.synchronize()
    uploaded = time.perf_counter()
    print(f'device dataset: {card}: store of {len(ds)} poses '
          f'({int(host.num_nodes.sum())} nodes, {int(host.num_edges.sum())} '
          f'edges, symmetric={host.symmetric}): {host.nbytes / 1e6:.3f} MB, '
          f'built in {1e3 * (built - start):.1f} ms (featurisation '
          f'included), uploaded in {1e3 * (uploaded - built):.1f} ms')

    # Every batch of a validation and a training pass, ids against host.
    collate_ms, host_ms, n_batches = [], [], 0
    for mode in ('val', 'train'):
        stream, ids_dl = (GraphDataLoader(ds, batch_size=32, mode=mode,
                                          prefetch=0, seed=SEED)
                          for _ in range(2))
        ids_dl.enable_device_dataset(store)
        for (sb, _), (ib, _) in zip(stream, ids_dl):
            check(ib[0] == 'ids', f'device dataset: a {mode} batch is '
                                  f'{ib[0]!r}')
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            got = dd.collate_from_ids(store.arrays, ib[1][0], ib[3])
            t1.record()
            h0 = time.perf_counter()
            want = to_device(sb, dev)
            torch.cuda.synchronize()
            host_ms.append(1e3 * (time.perf_counter() - h0))
            collate_ms.append(t0.elapsed_time(t1))
            _assert_batches_equal(torch, got, want,
                                  f'device dataset {mode} batch')
            n_batches += 1
    print(f'device dataset: {card}: {n_batches} batches of 32 collated on '
          f'the card equal the host collation in every field; collation '
          f'{statistics.median(collate_ms):.3f} ms a batch by CUDA events '
          f'(median; the host batch\'s copy to the card '
          f'{statistics.median(host_ms):.3f} ms by the host clock)')

    ids = np.concatenate([np.arange(30), [-1, -1]]).astype(np.int32)
    key = dd.rotation_key(SEED, 3)
    mats = [dd.random_rotations(key, ids, d).cpu()
            for d in (dev, torch.device('cpu'))]
    mat_diff = (mats[0] - mats[1]).abs().max().item()
    check(mat_diff <= 1e-6, f'device dataset: rotations on the card and the '
                            f'CPU differ by {mat_diff}')
    spec = dd.DeviceCollateSpec(16384, 262144, 32, host.symmetric, True)
    coords = [dd.rotate_per_graph(dd.collate_from_ids(
        dd.DeviceGraphStore(host, d).arrays, ids, spec), key, ids,
        32).coords.cpu() for d in (dev, torch.device('cpu'))]
    coord_diff = (coords[0] - coords[1]).abs().max().item()
    # Each coordinate sums three products with matrix entries held at
    # 1e-6: relative to the coordinates' scale, within 3e-6.
    scale = coords[1].abs().max().item()
    check(coord_diff <= 3e-6 * scale, f'device dataset: rotated coordinates '
                                      f'differ by {coord_diff} at scale '
                                      f'{scale}')
    print(f'device dataset: rotations card against CPU: matrices '
          f'{mat_diff:.2e}, coordinates {coord_diff:.2e} (up to '
          f'{scale:.1f} A)')

    launches = {k: 0 for k in ('k1', 'k2', 'k3', 'k4')}
    kernel_err = {}
    for name, (flags, fused) in DD_CONFIGS.items():
        kwargs = dict(MODEL_KWARGS, **flags)
        trainers, loaders = {}, {}
        for src in ('stream', 'ids'):
            trainers[src] = Trainer(
                'egnn', root / f'dd_{name}_{src}', dev,
                learning_rate=TRAIN_LR, weight_decay=1e-4, seed=SEED,
                fused_training=fused, device_cache='off', **kwargs)
            loaders[src] = GraphDataLoader(ds, batch_size=32, mode='train',
                                           prefetch=2, seed=SEED)
        loaders['ids'].enable_device_dataset(store)
        counts = {}
        recorded = {}
        wall, device_s = {}, {}
        for epoch in range(DD_EPOCHS):
            for src in ('stream', 'ids'):    # in turns
                last = epoch == DD_EPOCHS - 1
                originals = {}
                if src == 'ids':
                    sk.reset_launch_counts()
                    originals = {
                        (mod, k): _first_call_recorder(mod, k, recorded)
                        for mod, k in ((sk, 'windowed_segment_sum'),
                                       (sk, 'fused_softmax_aggregate'),
                                       (k3, 'fused_edge_forward'),
                                       (k4, 'fused_edge_backward'))}
                try:
                    if last:
                        with profile(activities=[ProfilerActivity.CUDA]) \
                                as prof:
                            trainers[src].train_model(loaders[src],
                                                      epochs=epoch + 1)
                            torch.cuda.synchronize()
                        device_s[src] = sum(
                            e.self_device_time_total
                            for e in prof.key_averages()) / 1e6
                        wall[src] = trainers[src].epoch_seconds[-1]
                    else:
                        trainers[src].train_model(loaders[src],
                                                  epochs=epoch + 1)
                    torch.cuda.synchronize()
                    # Read while the recorders are in place: a wrapper
                    # counts its launches on the name it is called by.
                    if src == 'ids':
                        for kernel, n in sk.launch_counts().items():
                            counts[kernel] = counts.get(kernel, 0) + n
                finally:
                    for (mod, k), fn in originals.items():
                        setattr(mod, k, fn)
        steps = len(trainers['ids'].train_losses)
        loss = {src: np.asarray(t.train_losses)
                for src, t in trainers.items()}
        diff = float(np.abs(loss['ids'] - loss['stream']).max())
        check(steps == 2 * DD_EPOCHS and np.isfinite(loss['ids']).all()
              and np.allclose(loss['ids'], loss['stream'], **TRAJ_TOL),
              f'device dataset {name}: ids and stream trajectories differ '
              f'by {diff} ({loss})')
        layers = flags['num_layers']
        if fused:
            ok = (counts['fused_edge_forward'] == layers * steps
                  and counts['fused_edge_backward'] == layers * steps
                  and counts['softmax_aggregate_sorted'] == 0)
        elif flags.get('edge_attention'):
            ok = (counts['softmax_aggregate_sorted'] == layers * steps
                  and counts['segment_sum_sorted'] >= layers * steps
                  and counts['fused_edge_forward'] == 0)
        else:
            ok = (counts['segment_sum_sorted'] >= layers * steps
                  and counts['softmax_aggregate_sorted'] == 0
                  and counts['fused_edge_forward'] == 0)
        check(ok and counts['segment_offsets'] <= 2 * steps,
              f'device dataset {name}: ids steps launched {counts}')
        launches['k1'] += counts['segment_sum_sorted']
        launches['k2'] += counts['softmax_aggregate_sorted']
        launches['k3'] += counts['fused_edge_forward']
        launches['k4'] += counts['fused_edge_backward']
        errs = _check_recorded_kernels(torch, sk, recorded,
                                       f'device dataset {name}')
        errs.update(_check_recorded_fused(torch, recorded,
                                          f'device dataset {name}'))
        for k, v in errs.items():
            kernel_err[k] = max(kernel_err.get(k, 0.0), v)
        ms = {src: np.asarray(t.step_ms()) for src, t in trainers.items()}
        share = {src: 1 - device_s[src] / wall[src] for src in wall}
        print(f'device dataset: {card}: {name} {steps} steps from ids and '
              f'from the stream in turns: max|ids - stream| loss {diff:.3e};'
              f' ids launches {counts}; step ms median ids '
              f'{np.median(ms["ids"]):.3f} / stream '
              f'{np.median(ms["stream"]):.3f} (CUDA events; ids '
              f'{ms["ids"].round(3).tolist()}, stream '
              f'{ms["stream"].round(3).tolist()}); epoch {DD_EPOCHS} wall '
              f'ids {wall["ids"]:.3f} s / stream {wall["stream"]:.3f} s, '
              f'device time {device_s["ids"]:.3f} / '
              f'{device_s["stream"]:.3f} s, host share ids '
              f'{share["ids"]:.3f} / stream {share["stream"]:.3f}; kernels '
              f'on the steps\' inputs against plain {errs}')

    # The training CLI with the hybrid tail, on against off.
    cli = {}
    for mode in ('on', 'off'):
        run = root / f'dd_cli_{mode}'
        sk.reset_launch_counts()
        start = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cli[mode] = train_main(cli_argv(run, types, 'cuda', extra=[
                '--device_cache', mode]))
            torch.cuda.synchronize()
        cli_wall = time.perf_counter() - start
        device = sum(e.self_device_time_total
                     for e in prof.key_averages()) / 1e6
        stores = cli[mode]._device_stores
        check((len(stores) == 2) == (mode == 'on'),
              f'main --device_cache {mode}: {len(stores)} stores')
        ms = np.asarray(cli[mode].step_ms())
        print(f'device dataset: {card}: main --device_cache {mode} '
              f'(augmented actives 1, dropout 0.1, 2 epochs, validation): '
              f'wall {cli_wall:.3f} s, device time {device:.3f} s, host '
              f'share of the run {1 - device / cli_wall:.3f}; step ms '
              f'median {np.median(ms):.3f} {ms.round(3).tolist()}; epoch '
              f'wall s {[round(s, 3) for s in cli[mode].epoch_seconds]}; '
              f'launches {sk.launch_counts()}')
    diff = float(np.abs(cli['on'].val_scores - cli['off'].val_scores).max())
    loss_diff = float(np.abs(np.subtract(cli['on'].train_losses,
                                         cli['off'].train_losses)).max())
    check(len(cli['on'].val_scores) == 64 and diff <= DD_FIELDS_RTOL,
          f'main --device_cache on and off: scores differ by {diff}')
    check(np.allclose(cli['on'].train_losses, cli['off'].train_losses,
                      **TRAJ_TOL),
          f'main --device_cache on and off: losses differ by {loss_diff}')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'device dataset: {card}: main --device_cache on against off: '
          f'max|score| {diff:.3e}, max|loss| {loss_diff:.3e}; peak memory '
          f'of the phase {peak:.3f} GiB')
    return launches, kernel_err


# ----------------------------------------------------------------- 8
# The lucid and en_transformer families through the Trainer, 5 steps on
# the card against the same on the CPU (depth cut to 3 layers for the CPU
# runs' time; lucid also with dropout 0.1, whose masks are the
# reference's under the step's JAX key on both devices: the kernel of
# ops/dropout.py on the card, its plain version on the CPU).
FAMILY_TRAIN = {
    'lucid_3l': ('lucid', dict(LUCID_6L, num_layers=3)),
    'lucid_3l_dropout': ('lucid', dict(LUCID_6L, num_layers=3,
                                       dropout=0.1)),
    'en_transformer_3l': ('en_transformer', dict(num_layers=3, heads=4)),
}
# K1 launches a step, at least: lucid's two receiver means a layer and
# its pair gather's backward; en_transformer's three sums a layer and the
# backward of its two gathers and of the denominators' gather.
FAMILY_K1_PER_LAYER = {'lucid': 3, 'en_transformer': 6}


def phase_family_training(torch, np, root: Path, types: Path, card: str):
    from pointvs_tpu_torch import inference
    from pointvs_tpu_torch.ops import segment_kernels as sk
    from pointvs_tpu_torch.training.engine import Trainer
    _, loader = inference.get_model_and_test_dl(
        str(root / 'readme_softmax_6l'), str(types), str(root / 'data'),
        torch.device('cpu'), batch_size=32)
    host = list(loader)
    steps = [host[i % len(host)] for i in range(TRAIN_STEPS)]
    out = {}
    for name, (model, flags) in FAMILY_TRAIN.items():
        losses, counts = {}, {}
        for device in ('cuda', 'cpu'):
            trainer = Trainer(model, root / f'train_{name}_{device}',
                              torch.device(device), learning_rate=TRAIN_LR,
                              weight_decay=1e-4, seed=SEED,
                              **dict(MODEL_KWARGS, **flags))
            sk.reset_launch_counts()
            trainer.train_model(steps, epochs=1)
            counts[device] = sk.launch_counts()
            losses[device] = np.asarray(trainer.train_losses)
            check(len(losses[device]) == TRAIN_STEPS
                  and np.isfinite(losses[device]).all(),
                  f'{name} on {device}: losses {losses[device]}')
            if device == 'cuda':
                ms = np.asarray(trainer.step_ms())
        gpu = counts['cuda']
        k1_min = FAMILY_K1_PER_LAYER[model] * flags['num_layers'] \
            * TRAIN_STEPS
        check(gpu['segment_sum_sorted'] >= k1_min
              and gpu['softmax_aggregate_sorted'] == 0
              and gpu['fused_edge_forward'] == 0
              and gpu['fused_edge_backward'] == 0
              and gpu['segment_offsets'] <= 2 * TRAIN_STEPS,
              f'{name}: launches {gpu}, expected K1 >= {k1_min}, no K2-K4, '
              f'at most 2 offset computations a step')
        drops = 2 * 3 * flags['num_layers'] * TRAIN_STEPS \
            if flags.get('dropout') else 0   # 3 sites a layer, fwd + bwd
        check(gpu['threefry_dropout'] == drops,
              f'{name}: {gpu["threefry_dropout"]} dropout-mask launches, '
              f'expected {drops}')
        check(not any(counts['cpu'].values()),
              f'{name}: a CPU run launched a CUDA kernel')
        diff = float(np.abs(losses['cuda'] - losses['cpu']).max())
        check(np.allclose(losses['cuda'], losses['cpu'], **TRAJ_TOL),
              f'{name}: GPU and CPU trajectories differ by {diff}')
        out[name] = gpu
        print(f'family training: {card}: {name} {TRAIN_STEPS} steps, '
              f'launches {gpu} ({gpu["segment_sum_sorted"] / TRAIN_STEPS:.1f} '
              f'K1 a step); losses {losses["cuda"].tolist()}; max|gpu - cpu| '
              f'loss {diff:.3e}; step_ms median {np.median(ms):.3f} '
              f'(CUDA events) {ms.round(3).tolist()}')
    return out


# ----------------------------------------------------------------- 9
MT_CLI_FLAGS = ['--layers', '6', '-k', '32', '--egnn_attention',
                '--softmax_attention', '--egnn_residual', '--egnn_normalise',
                '--egnn_tanh', '--graphnorm', '--compact', '-b', '32', '-ep',
                '1', '-ea', '1', '--dropout', '0.1', '--radius', '10',
                '--edge_radius', '4', '--model_task', 'both', '--end_flag',
                '--seed', str(SEED)]
MT_RUN_FILES = ('checkpoints/pose_ckpt_epoch_1.pt',
                'checkpoints/affinity_ckpt_epoch_1.pt',
                'pose_predictions.txt', 'affinity_predictions.txt',
                'metrics.jsonl', 'cmd_args.yaml', '_FINISHED')


def write_affinity_types(np, types: Path, seed: int) -> Path:
    """The pose set's complexes with pKi / pKd / IC50 labels drawn from
    ``seed`` (pKi always given; each other label missing, -1, with
    probability 0.3)."""
    rng = np.random.default_rng(seed)
    lines = []
    for line in types.read_text().splitlines():
        rec, lig = line.split()[-2:]
        values = rng.uniform(3.0, 9.0, 3)
        values[1:][rng.random(2) < 0.3] = -1.0
        lines.append(' '.join(f'{v:.3f}' for v in values) + f' {rec} {lig}')
    out = types.parent / 'affinity.types'
    out.write_text('\n'.join(lines) + '\n')
    return out


def phase_multitask_cli(torch, np, root: Path, types: Path, card: str):
    """``pointvs_tpu_torch.main multitask ... --model_task both -ep 1 -ea
    1`` (in process, for the launch counters): the README model trains
    the pose phase, validates, then trains the affinity phase on seeded
    labels and validates; the same on the CPU within the trajectory gate.
    """
    from pointvs_tpu_torch.main import main as train_main
    from pointvs_tpu_torch.ops import segment_kernels as sk
    affinity = write_affinity_types(np, types, SEED)
    data = str(types.parent)

    def argv(run, device):
        return (['multitask', str(run), '--train_data_root_pose', data,
                 '--train_types_pose', str(types), '--test_data_root_pose',
                 data, '--test_types_pose', str(types),
                 '--train_data_root_affinity', data,
                 '--train_types_affinity', str(affinity),
                 '--test_data_root_affinity', data,
                 '--test_types_affinity', str(affinity)] + MT_CLI_FLAGS
                + ['--device', device])

    run = root / 'mt_cli_cuda'
    sk.reset_launch_counts()
    start = time.perf_counter()
    gpu = train_main(argv(run, 'cuda'))
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = sk.launch_counts()
    missing = [f for f in MT_RUN_FILES if not (run / f).exists()]
    check(not missing, f'multitask CLI: run directory lacks {missing}')
    steps = len(gpu.train_losses)
    check(steps == 2 + 2, f'multitask CLI: {steps} steps, expected 2 pose '
                          f'+ 2 affinity')
    check((gpu.p_epoch, gpu.a_epoch) == (1, 1),
          f'multitask CLI: epochs {(gpu.p_epoch, gpu.a_epoch)}')
    forwards = steps + 4   # 2 validation batches after each phase
    check(counts['softmax_aggregate_sorted'] == 6 * forwards
          and counts['segment_sum_sorted'] >= 6 * steps
          and counts['fused_edge_forward'] == 0
          and counts['fused_edge_backward'] == 0
          and counts['segment_offsets'] <= forwards,
          f'multitask CLI launches {counts}: expected K2 = 6 x {forwards} '
          f'forwards, K1 >= {6 * steps}, no K3/K4, one offset computation '
          f'a batch')
    cpu = train_main(argv(root / 'mt_cli_cpu', 'cpu'))
    diff = float(np.abs(np.subtract(gpu.train_losses,
                                    cpu.train_losses)).max())
    check(np.allclose(gpu.train_losses, cpu.train_losses, **TRAJ_TOL),
          f'multitask CLI: GPU and CPU trajectories differ by {diff}')
    for fname in ('pose_predictions.txt', 'affinity_predictions.txt'):
        rows = (run / fname).read_text().splitlines()
        check(len(rows) >= 64, f'multitask CLI: {fname} has {len(rows)} '
                               f'rows')
    # The pose serve of the run: from its newest checkpoint (either task:
    # the affinity phase's trunk, the reference's choice) and from the pose
    # phase's own checkpoint (the port's choice before this check).
    from pointvs_tpu_torch import inference
    served = {}
    for label, path in (('newest', run),
                        ('pose', run / MT_RUN_FILES[0])):
        trainer = inference.main([str(path), str(types), data,
                                  '--model_task', 'both', '--output_fname',
                                  f'served_{label}.txt'])
        served[label] = (trainer.val_scores, (trainer.p_epoch,
                                              trainer.a_epoch))
    check(served['newest'][1] == (1, 1) and served['pose'][1] == (1, 0),
          f'multitask serve: checkpoints {served}')
    choice = np.abs(served['newest'][0] - served['pose'][0])
    print(f'multitask CLI: {card}: pose scores of the {len(choice)} poses, '
          f'newest (affinity-phase) checkpoint against the pose '
          f'checkpoint: max |diff| {choice.max():.4f}, mean '
          f'{choice.mean():.4f}')
    ms = np.asarray(gpu.step_ms())
    print(f'multitask CLI: {card}: {steps} steps (pose, pose, affinity, '
          f'affinity), wall {wall:.3f} s; launches {counts} (K2 '
          f'{counts["softmax_aggregate_sorted"] / forwards:.1f} and K1 '
          f'{counts["segment_sum_sorted"] / forwards:.1f} a forward or '
          f'step); losses {gpu.train_losses}; max|gpu - cpu| loss '
          f'{diff:.3e}; step_ms {ms.round(3).tolist()} (CUDA events, 32 '
          f'graphs) median {np.median(ms):.3f}; epochs p/a '
          f'{gpu.p_epoch}/{gpu.a_epoch}')
    return counts


# ----------------------------------------------------------------- 10
# The pair, dense and strain inputs through the training CLI: siamese and
# the strain input at full width and depth (README flags), the dense
# family at full width and depth on the card, and cut for its CPU
# cross-check.
INPUT_FLAGS = ['-k', '32', '--compact', '--radius', '10', '--edge_radius',
               '4', '--seed', str(SEED), '--end_flag']
README_FLAGS = ['--layers', '6', '--egnn_attention', '--softmax_attention',
                '--egnn_residual', '--egnn_normalise', '--egnn_tanh',
                '--graphnorm', '-b', '32', '-ep', '2']
DENSE_FLAGS = ['--egnn_residual', '--egnn_normalise', '--egnn_tanh']
DENSE_BATCH = 32             # the full run's batch (cut if it cannot fit)
DENSE_CUT = ['--layers', '2', '-b', '8', '-ep', '1']   # CPU cross-check
INPUT_RUNS = {
    # name -> (model, flags, strain types?, devices, validation scores
    # held GPU against CPU within 1e-4?). The dense family's trained
    # logits reach the hundreds and more (its random-weight losses are
    # 1e2-1e7), where f32 rounding alone moves a score by ~1e-4: its
    # trajectory is held, its scores' difference printed.
    'siamese': ('siamese', README_FLAGS, False, ('cuda', 'cpu'), True),
    'strain': ('egnn', README_FLAGS + ['--include_strain_info'], True,
               ('cuda', 'cpu'), True),
    'lie_conv_full': ('lie_conv', DENSE_FLAGS + [
        '--layers', '6', '-b', str(DENSE_BATCH), '-ep', '1'], False,
        ('cuda',), False),
    'lie_conv_cut': ('lie_conv', DENSE_FLAGS + DENSE_CUT, False,
                     ('cuda', 'cpu'), False),
}


def phase_input_cli(torch, np, root: Path, types: Path, n_poses: int,
                    card: str):
    """``pointvs_tpu_torch.main`` for siamese, lie_conv and egnn
    --include_strain_info on the pose set (in process, for the launch
    counters), each with validation on the same set; GPU against CPU
    within the trajectory gate and the validation scores within 1e-4;
    then ``resume_training`` continues the siamese run to epoch 3."""
    from pointvs_tpu_torch.main import main as train_main
    from pointvs_tpu_torch.ops import segment_kernels as sk
    from pointvs_tpu_torch.resume_training import main as resume_main
    strain_types = types.parent / 'poses_strain.types'
    data = str(types.parent)
    out = {}
    for name, (model, flags, strain, devices, gate_scores) in \
            INPUT_RUNS.items():
        served = str(strain_types if strain else types)
        runs = {}
        for device in devices:
            run = root / f'input_{name}_{device}'
            argv = [model, str(run), '--train_data_root_pose', data,
                    '--train_types_pose', served, '--test_data_root_pose',
                    data, '--test_types_pose', served] + INPUT_FLAGS \
                + flags + ['--device', device]
            if device == 'cuda':
                torch.cuda.reset_peak_memory_stats()
                sk.reset_launch_counts()
            start = time.perf_counter()
            runs[device] = train_main(argv)
            if device == 'cuda':
                torch.cuda.synchronize()
                wall = time.perf_counter() - start
                counts = sk.launch_counts()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check((run / '_FINISHED').exists()
                  and (run / 'pose_predictions.txt').exists(),
                  f'{name} on {device}: run directory incomplete')
        gpu = runs['cuda']
        losses = np.asarray(gpu.train_losses)
        steps = len(losses)
        val = -(-n_poses // int(flags[flags.index('-b') + 1]))
        check(steps > 0 and np.isfinite(losses).all()
              and len(gpu.val_scores) == n_poses
              and np.isfinite(gpu.val_scores).all(),
              f'{name}: losses {losses}, {len(gpu.val_scores)} scores')
        forwards = steps + val
        expect = {
            'siamese': counts['softmax_aggregate_sorted'] == 6 * forwards
            and counts['segment_sum_sorted'] >= 12 * forwards,
            'strain': counts['softmax_aggregate_sorted'] == 6 * forwards
            and counts['segment_sum_sorted'] >= 6 * steps,
        }.get(name, not any(counts.values()))
        check(expect and counts['fused_edge_forward'] == 0
              and counts['fused_edge_backward'] == 0,
              f'{name}: launches {counts} for {steps} steps and {val} '
              f'validation batches')
        diff = ''
        if 'cpu' in runs:
            cpu = runs['cpu']
            d = float(np.abs(losses - np.asarray(cpu.train_losses)).max())
            s = float(np.abs(gpu.val_scores - cpu.val_scores).max())
            check(np.allclose(losses, cpu.train_losses, **TRAJ_TOL),
                  f'{name}: GPU and CPU trajectories differ by {d}')
            check(s <= 1e-4 or not gate_scores,
                  f'{name}: GPU and CPU scores differ by {s}')
            diff = f'; max|gpu - cpu| loss {d:.3e}, scores {s:.2e}'
        ms = np.asarray(gpu.step_ms())
        out[name] = counts
        print(f'inputs CLI: {card}: {name} ({model} {" ".join(flags)}): '
              f'{steps} steps, {val} validation batches, wall {wall:.3f} s; '
              f'launches {counts}; losses {losses.tolist()}{diff}; step_ms '
              f'{ms.round(3).tolist()} (CUDA events) median '
              f'{np.median(ms):.3f}; peak memory {peak:.3f} GiB '
              f'(max_memory_allocated over the run)')

    run = root / 'input_siamese_cuda'
    cmd_args = (run / 'cmd_args.yaml').read_text()
    check('epochs_pose: 2' in cmd_args, 'cmd_args.yaml lacks epochs_pose')
    (run / 'cmd_args.yaml').write_text(
        cmd_args.replace('epochs_pose: 2', 'epochs_pose: 3'))
    resumed = resume_main([str(run)])
    check(resumed.p_epoch == 3
          and (run / 'checkpoints' / 'pose_ckpt_epoch_3.pt').exists()
          and np.isfinite(resumed.train_losses).all(),
          f'resume_training: p_epoch {resumed.p_epoch}')
    print(f'inputs CLI: resume_training continued the siamese run to epoch '
          f'{resumed.p_epoch}: losses {resumed.train_losses}')
    return out


def phase_strain_fused(torch, np, root: Path):
    """5 ``Trainer`` steps of the README strain model on the module path
    (K1/K2) and the fused path (K3 forward, K4 backward) on the card, on
    the strain pose batches: the two trajectories within the gate."""
    from pointvs_tpu_torch.data.loader import get_data_loader
    from pointvs_tpu_torch.ops import segment_kernels as sk
    from pointvs_tpu_torch.training.engine import Trainer
    # The training loader of a strain run (the serving CLI's leaves the
    # strain column out, as the reference's does).
    host = list(get_data_loader(
        root / 'data', root / 'data' / 'poses_strain.types', batch_size=32,
        radius=10, edge_radius=4, polar_hydrogens=False, prefetch=0,
        include_strain_info=True))
    check(all(np.abs(b.strain[:, 0]).max() > 0 for b, _ in host),
          'the strain batches carry no dE')
    steps = [host[i % len(host)] for i in range(TRAIN_STEPS)]
    losses, counts, ms = {}, {}, {}
    for fused in (False, True):
        name = 'fused' if fused else 'module'
        trainer = Trainer('egnn', root / f'strain_{name}',
                          torch.device('cuda'), learning_rate=TRAIN_LR,
                          weight_decay=1e-4, seed=SEED, fused_training=fused,
                          **dict(MODEL_KWARGS, **STRAIN_6L))
        sk.reset_launch_counts()
        trainer.train_model(steps, epochs=1)
        counts[name] = sk.launch_counts()
        losses[name] = np.asarray(trainer.train_losses)
        ms[name] = np.asarray(trainer.step_ms())
    expect = 6 * TRAIN_STEPS
    fused = counts['fused']
    check(fused['fused_edge_forward'] == expect
          and fused['fused_edge_backward'] == expect
          and fused['softmax_aggregate_sorted'] == 0
          and counts['module']['softmax_aggregate_sorted'] == expect
          and counts['module']['fused_edge_forward'] == 0,
          f'strain Trainer launches {counts}: expected K3 = K4 = {expect} '
          f'fused, K2 = {expect} module')
    diff = float(np.abs(losses['fused'] - losses['module']).max())
    check(np.isfinite(losses['fused']).all() and np.allclose(
        losses['fused'], losses['module'], **TRAJ_TOL),
        f'strain: fused and module trajectories differ by {diff}')
    print(f'strain Trainer: {TRAIN_STEPS} steps, launches {counts}; '
          f'max|fused - module| loss {diff:.3e}; step_ms module '
          f'{ms["module"].round(3).tolist()} fused '
          f'{ms["fused"].round(3).tolist()} (CUDA events)')
    return fused


# ---------------------------------------------------------------- 12
DEEP_LAYERS = 48


def _deep_step(torch, np, trainer, batch):
    """(median step ms of 5 by CUDA events after 2 warm-up steps, peak
    memory of one step in GiB above what the model, its optimiser state
    and the batch hold, the last loss)."""
    from pointvs_tpu_torch.parallel.steps import make_train_step
    step = make_train_step(trainer.model, trainer.optimiser,
                           'classification')
    for _ in range(2):
        step(batch, TRAIN_LR)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, loss = [], None
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(batch, TRAIN_LR)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    return statistics.median(times), peak, float(loss)


def phase_bf16(torch, np, root: Path, types: Path, n_poses: int,
               card: str):
    """--bf16 training: the README model's Trainer steps on the card
    against the CPU, the CLI and its resume, and the 48-layer model's
    step time and memory in bf16 against f32."""
    from pointvs_tpu_torch import inference
    from pointvs_tpu_torch.data.buckets import to_device
    from pointvs_tpu_torch.main import main as train_main
    from pointvs_tpu_torch.ops import segment_kernels as sk
    from pointvs_tpu_torch.resume_training import main as resume_main
    from pointvs_tpu_torch.training.engine import Trainer
    _, loader = inference.get_model_and_test_dl(
        str(root / 'readme_softmax_6l'), str(types), str(root / 'data'),
        torch.device('cpu'), batch_size=32)
    host = list(loader)
    steps = [host[i % len(host)] for i in range(TRAIN_STEPS)]
    kwargs = dict(MODEL_KWARGS, **README_6L_BF16)
    losses, counts = {}, {}
    for device in ('cuda', 'cpu'):
        trainer = Trainer('egnn', root / f'bf16_train_{device}',
                          torch.device(device), learning_rate=TRAIN_LR,
                          weight_decay=1e-4, seed=SEED, **kwargs)
        sk.reset_launch_counts()
        trainer.train_model(steps, epochs=1)
        counts[device] = sk.launch_counts()
        losses[device] = np.asarray(trainer.train_losses)
        check(np.isfinite(losses[device]).all() and all(
            p.dtype == torch.float32 for p in trainer.model.parameters()),
            f'bf16 Trainer on {device}: losses {losses[device]}')
        if device == 'cuda':
            ms = np.asarray(trainer.step_ms())
    gpu, expect = counts['cuda'], 6 * TRAIN_STEPS
    check(gpu['softmax_aggregate_sorted'] == expect
          and gpu['segment_sum_sorted'] >= expect
          and gpu['fused_edge_forward'] == gpu['fused_edge_backward'] == 0
          and not any(counts['cpu'].values()),
          f'bf16 Trainer launches {counts}: expected K2 = {expect}, K1 >= '
          f'{expect}, no K3/K4, none on the CPU')
    rel = float((np.abs(losses['cuda'] - losses['cpu'])
                 / np.abs(losses['cpu'])).max())
    check(rel <= BF16_TRAJ_GATE,
          f'bf16 Trainer: GPU and CPU trajectories differ by {rel:.3g} '
          f'(relative)')
    print(f'bf16 Trainer: {card}: {TRAIN_STEPS} steps of the README model, '
          f'launches {gpu}; losses {losses["cuda"].tolist()}; max relative '
          f'|gpu - cpu| loss {rel:.3e}; step_ms {ms.round(3).tolist()} '
          f'(CUDA events)')

    data = str(types.parent)
    flags = [f for f in README_FLAGS if f not in ('-ep', '2')]
    runs = {}
    for device in ('cuda', 'cpu'):
        argv = ['egnn', str(root / f'bf16_cli_{device}'),
                '--train_data_root_pose', data, '--train_types_pose',
                str(types), '--test_data_root_pose', data,
                '--test_types_pose', str(types)] + INPUT_FLAGS + flags + [
                    '-ep', '1', '--bf16', '--device', device]
        sk.reset_launch_counts()
        runs[device] = train_main(argv)
        if device == 'cuda':
            cli_counts = sk.launch_counts()
    gpu_run, cpu_run = runs['cuda'], runs['cpu']
    n_steps = len(gpu_run.train_losses)
    forwards = n_steps + -(-n_poses // 32)
    check(gpu_run.model.bf16 and n_steps > 0
          and cli_counts['softmax_aggregate_sorted'] == 6 * forwards
          and cli_counts['fused_edge_forward'] == 0
          and cli_counts['fused_edge_backward'] == 0,
          f'main --bf16: launches {cli_counts} for {n_steps} steps and '
          f'{forwards - n_steps} validation batches')
    cli_rel = float((np.abs(np.subtract(gpu_run.train_losses,
                                        cpu_run.train_losses))
                     / np.abs(cpu_run.train_losses)).max())
    score_diff = float(np.abs(gpu_run.val_scores - cpu_run.val_scores).max())
    check(cli_rel <= BF16_TRAJ_GATE and score_diff <= BF16_SCORE_GATE,
          f'main --bf16: GPU and CPU differ by {cli_rel:.3g} (losses, '
          f'relative), {score_diff:.3g} (scores)')
    run = root / 'bf16_cli_cuda'
    cmd_args = (run / 'cmd_args.yaml').read_text()
    check('epochs_pose: 1' in cmd_args, 'cmd_args.yaml lacks epochs_pose')
    (run / 'cmd_args.yaml').write_text(
        cmd_args.replace('epochs_pose: 1', 'epochs_pose: 2'))
    resumed = resume_main([str(run)])
    check(resumed.p_epoch == 2 and resumed.model.bf16
          and np.isfinite(resumed.train_losses).all(),
          f'resume of the bf16 run: p_epoch {resumed.p_epoch}')
    cli_ms = np.asarray(gpu_run.step_ms())
    print(f'bf16 CLI: {card}: main egnn --bf16 (README flags, batch 32, 1 '
          f'epoch): {n_steps} steps, launches {cli_counts}; max relative '
          f'|gpu - cpu| loss {cli_rel:.3e}, max|gpu - cpu| score '
          f'{score_diff:.3e}; step_ms {cli_ms.round(3).tolist()}; resumed '
          f'to p_epoch {resumed.p_epoch}, losses {resumed.train_losses}')

    batch = to_device(host[0][0], torch.device('cuda'))
    deep = {}
    for bf16 in (False, True):
        trainer = Trainer('egnn', root / f'deep_{bf16}', torch.device('cuda'),
                          learning_rate=TRAIN_LR, weight_decay=1e-4,
                          seed=SEED, silent=True,
                          **dict(MODEL_KWARGS, **dict(
                              README_6L, num_layers=DEEP_LAYERS,
                              bf16=bf16)))
        deep[bf16] = _deep_step(torch, np, trainer, batch)
        del trainer
        torch.cuda.empty_cache()
    check(all(np.isfinite(v[2]) for v in deep.values()),
          f'deep model losses {deep}')
    (f32_ms, f32_gib, _), (bf_ms, bf_gib, _) = deep[False], deep[True]
    print(f'bf16 deep: {card}: {DEEP_LAYERS}-layer k=32 README model, '
          f'module path, batch of 32 poses: step_ms f32 {f32_ms:.3f} bf16 '
          f'{bf_ms:.3f} (median of 5, CUDA events); activation memory '
          f'(max_memory_allocated in a step above the model, optimiser '
          f'state and batch) f32 {f32_gib:.3f} GiB bf16 {bf_gib:.3f} GiB, '
          f'bf16/f32 {bf_gib / f32_gib:.3f}; losses f32 {deep[False][2]:.6f} '
          f'bf16 {deep[True][2]:.6f}')
    return gpu


# ---------------------------------------------------------------- 13
SYNTH_PHARM_ATOMIC_NUMBERS = (6, 7, 8, 9, 15, 16, 17, 35, 53)


def write_synthpharm_set(np, data: Path, types: Path,
                         out: Path = None) -> Path:
    """A synthetic-pharmacophore copy of the pose set (in ``out``, by
    default ``synthpharm`` beside ``data``): every pose's ligand with a
    ``type`` drawn from the nine atomic numbers, and the pocket (receptor
    atoms within 10 A of the test ligand, the box the pose set is
    featurised with) with a ``type`` of 0, 1 or 2, from the seed."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(SEED + 4)
    out = out or data.parent / 'synthpharm'
    out.mkdir(parents=True)

    def xyz(table):
        return np.stack([table.column(c).to_numpy() for c in 'xyz'], 1)

    rec = pq.read_table(data / 'rec_0.parquet')
    lig0 = xyz(pq.read_table(RESOURCES / 'lig_0.parquet'))
    dist = np.sqrt(((xyz(rec)[:, None] - lig0[None]) ** 2).sum(-1))
    rec = rec.take(np.where((dist < 10).any(1))[0])

    def write(table, kinds, bp, path):
        cols = {c: table.column(c) for c in 'xyz'}
        cols['type'] = pa.array(kinds.astype(np.int64))
        cols['bp'] = pa.array(np.full(table.num_rows, bp, np.int64))
        pq.write_table(pa.table(cols), path)

    write(rec, rng.integers(0, 3, rec.num_rows), 1, out / 'rec_0.parquet')
    for line in types.read_text().splitlines():
        lig_name = line.split()[-1]
        lig = pq.read_table(data / lig_name)
        write(lig, rng.choice(SYNTH_PHARM_ATOMIC_NUMBERS, lig.num_rows), 0,
              out / lig_name)
    (out / 'sp.types').write_text(types.read_text())
    return out / 'sp.types'


def phase_synthpharm(torch, np, root: Path, types: Path, card: str):
    from pointvs_tpu_torch.main import main as train_main
    from pointvs_tpu_torch.ops import segment_kernels as sk
    sp_types = write_synthpharm_set(np, types.parent, types)
    data = str(sp_types.parent)
    flags = [f for f in README_FLAGS if f not in ('-ep', '2')]
    runs = {}
    for device in ('cuda', 'cpu'):
        argv = ['egnn', str(root / f'sp_{device}'), '--train_data_root_pose',
                data, '--train_types_pose', str(sp_types),
                '--test_data_root_pose', data, '--test_types_pose',
                str(sp_types), '--synthpharm'] + INPUT_FLAGS + flags + [
                    '-ep', '1', '--device', device]
        sk.reset_launch_counts()
        runs[device] = train_main(argv)
        if device == 'cuda':
            counts = sk.launch_counts()
    gpu, cpu = runs['cuda'], runs['cpu']
    steps = len(gpu.train_losses)
    val = -(-len(sp_types.read_text().splitlines()) // 32)
    check(steps > 0 and np.isfinite(gpu.train_losses).all()
          and counts['softmax_aggregate_sorted'] == 6 * (steps + val)
          and counts['fused_edge_forward'] == 0,
          f'synthpharm: launches {counts} for {steps} steps and {val} '
          f'validation batches')
    diff = float(np.abs(np.subtract(gpu.train_losses,
                                    cpu.train_losses)).max())
    check(np.allclose(gpu.train_losses, cpu.train_losses, **TRAJ_TOL),
          f'synthpharm: GPU and CPU trajectories differ by {diff}')
    ms = np.asarray(gpu.step_ms())
    print(f'synthpharm CLI: {card}: main egnn --synthpharm --compact (README '
          f'flags, batch 32, 1 epoch): {steps} steps, {val} validation '
          f'batches, launches {counts} ('
          f'{counts["softmax_aggregate_sorted"] / (steps + val):.1f} K2 and '
          f'{counts["segment_sum_sorted"] / steps:.1f} K1 a batch); losses '
          f'{gpu.train_losses}; max|gpu - cpu| loss {diff:.3e}; step_ms '
          f'{ms.round(3).tolist()} (CUDA events)')
    return counts


# ------------------------------------------------------------ scale-out
# The README model's CLI flags without dropout (the masks depend on which
# graphs a rank holds) for one epoch: 64 poses and 32 augmented actives,
# 3 steps at batch 32, then the 64 poses scored at batch 32.
SCALE_OUT_FLAGS = list(CLI_FLAGS) + ['--dropout', '0', '-ep', '1']
SCALE_OUT_STEPS, SCALE_OUT_VAL = 3, 2   # steps and validation batches
SCALE_OUT_LAYERS = 6
SCALE_OUT_PRED_TOL = 5e-4   # tests/test_graph_shard.py's CLI bound


def _launch_sums(reports, kernel) -> list:
    return [r['launch_counts'][kernel] for r in reports]


def phase_scale_out(torch, np, root: Path, types: Path, card: str,
                    ranks: int = 2):
    """Scale-out (``parallel/``): ``main --num_devices 1`` in process;
    ``--num_devices ranks`` (spawned ranks, each a stripe of 32 / ranks
    graphs a step: on the one card 2 ranks share cuda:0 over gloo, on
    ``ranks`` cards each has its own over NCCL) and ``--num_devices ranks
    --graph_shard 2`` (ranks / 2 dp rows, each row's edges over 2 ranks)
    against it, per step losses within the trajectory gate and validation
    scores within 5e-4; ``--multihost`` as the one rank of a launcher's job (RANK 0,
    WORLD_SIZE 1) over NCCL, in process. K1/K2 launches per rank: on the
    dp ranks K2 6 a step and validation forward, as on one device; on the
    edge-shard ranks K2 never and K1 in every layer. Then K1 on a rank's
    shard of a real batch against its plain version in float64. Prints
    each rank's step ms and all-reduce ms a step (CUDA events). Returns
    (K1 and K2 launches of the driven runs, K1's worst error)."""
    import os
    from pointvs_tpu_torch.data.loader import get_data_loader
    from pointvs_tpu_torch.data.buckets import to_device
    from pointvs_tpu_torch.main import main as train_main
    from pointvs_tpu_torch.ops import segment_kernels as sk
    from pointvs_tpu_torch.parallel.launch import free_port

    def argv(name, extra):
        return cli_argv(root / name, types, 'cuda', extra=(
            SCALE_OUT_FLAGS + ['--prefetch', '0'] + extra))

    layers, steps, val = SCALE_OUT_LAYERS, SCALE_OUT_STEPS, SCALE_OUT_VAL
    sk.reset_launch_counts()
    one = train_main(argv('so_one', ['--num_devices', '1']))
    torch.cuda.synchronize()
    one_counts = sk.launch_counts()
    check(len(one.train_losses) == steps,
          f'scale-out: {len(one.train_losses)} steps on one device')
    check(one_counts['softmax_aggregate_sorted'] == layers * (steps + val),
          f'scale-out one device: launches {one_counts}')

    start = time.perf_counter()
    dp = train_main(argv('so_dp', ['--num_devices', str(ranks)]))
    dp_wall = time.perf_counter() - start
    start = time.perf_counter()
    gs = train_main(argv('so_gs', ['--num_devices', str(ranks),
                                   '--graph_shard', '2']))
    gs_wall = time.perf_counter() - start
    for label, reports in (('dp', dp), ('graph_shard', gs)):
        check([r['rank'] for r in reports] == list(range(ranks)),
              f'scale-out {label}: reports {[r["rank"] for r in reports]}')
        for r in reports:
            check(np.allclose(r['train_losses'], one.train_losses,
                              **TRAJ_TOL),
                  f'scale-out {label} rank {r["rank"]}: losses '
                  f'{r["train_losses"]} against one device\'s '
                  f'{one.train_losses}')
            diff = float(np.abs(r['val_scores'] - one.val_scores).max())
            check(r['val_scores'].shape == one.val_scores.shape
                  and diff <= SCALE_OUT_PRED_TOL,
                  f'scale-out {label} rank {r["rank"]}: validation scores '
                  f'differ by {diff}')
            check(len(r['allreduce_ms']) == steps,
                  f'scale-out {label}: {len(r["allreduce_ms"])} timed '
                  f'all-reduces for {steps} steps')
    # dp ranks: each scores half of every batch, one K2 a layer.
    for r in dp:
        c = r['launch_counts']
        check(c['softmax_aggregate_sorted'] == layers * (steps + val)
              and c['segment_sum_sorted'] >= layers * steps
              and c['fused_edge_forward'] == c['fused_edge_backward'] == 0,
              f'scale-out dp rank {r["rank"]}: launches {c}')
    # Edge-shard ranks: never K2 (the reference's Pallas path is off when
    # edge-sharded), K1 in every layer's softmax aggregation.
    for r in gs:
        c = r['launch_counts']
        check(c['softmax_aggregate_sorted'] == 0
              and c['segment_sum_sorted'] >= layers * (steps + val),
              f'scale-out graph_shard rank {r["rank"]}: launches {c}')

    env = dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
               LOCAL_WORLD_SIZE='1', MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    sk.reset_launch_counts()
    try:
        mh = train_main(argv('so_mh', ['--multihost', '--node_bucket',
                                       '16384', '--edge_bucket', '262144']))
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    mh_counts = sk.launch_counts()
    check(mh.mesh.backend == 'nccl' and mh.num_devices == 1,
          f'scale-out --multihost: backend {mh.mesh.backend}, '
          f'{mh.num_devices} rank(s)')
    check(np.allclose(mh.train_losses, one.train_losses, **TRAJ_TOL)
          and float(np.abs(mh.val_scores - one.val_scores).max())
          <= SCALE_OUT_PRED_TOL,
          f'scale-out --multihost: losses {mh.train_losses} against '
          f'{one.train_losses}')
    check(mh_counts['softmax_aggregate_sorted'] == layers * (steps + val),
          f'scale-out --multihost: launches {mh_counts}')

    # K1 on rank 0's edge shard of the first validation batch (the
    # sharded softmax's packed width, 32 + 5), against float64.
    loader = get_data_loader(
        types.parent, types, batch_size=32, compact=True, radius=10,
        edge_radius=4, polar_hydrogens=False, prefetch=0, graph_shard=2,
        gp_index=0)
    shard = to_device(next(iter(loader))[0], torch.device('cuda'))
    n = shard.node_feats.shape[0]
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    data = torch.randn(shard.senders.shape[0], 37, device='cuda',
                       generator=gen)
    got = sk.windowed_segment_sum(data, shard.senders, n)
    want = sk.windowed_segment_sum_plain(data.double(), shard.senders,
                                         n).float()
    torch.cuda.synchronize()
    k1_err = (got - want).abs().max().item()
    check(torch.allclose(got, want, **TOL),
          f'scale-out: K1 on an edge shard disagrees with plain by {k1_err}')

    def ms(values):
        return (f'median {np.median(values):.3f} p90 '
                f'{np.percentile(values, 90):.3f}' if len(values) else '-')
    print(f'scale-out: {card}: one device step_ms {ms(one.step_ms())}; '
          f'launches {one_counts}')
    for label, reports, wall in ((f'dp {ranks} x gp 1', dp, dp_wall),
                                 (f'dp {ranks // 2} x gp 2', gs, gs_wall)):
        for r in reports:
            print(f'scale-out: {card}: {label} rank {r["rank"]} '
                  f'({r["backend"]}, {r["device"]}): step_ms '
                  f'{ms(r["step_ms"])} '
                  f'{np.round(r["step_ms"], 3).tolist()}; all-reduce ms a '
                  f'step {ms(r["allreduce_ms"])} '
                  f'{np.round(r["allreduce_ms"], 3).tolist()}; launches '
                  f'{r["launch_counts"]}')
        print(f'scale-out: {card}: {label} CLI wall {wall:.3f} s ({ranks} '
              f'processes started, featurisation, {steps} steps, '
              f'validation); losses {reports[0]["train_losses"]} vs one '
              f'device {one.train_losses}')
    print(f'scale-out: {card}: --multihost (nccl, 1 rank) step_ms '
          f'{ms(mh.step_ms())}; all-reduce ms a step '
          f'{ms(mh.allreduce_ms())}; launches {mh_counts}; K1 on an edge '
          f'shard max|kernel - plain| {k1_err:.3e}')
    launches = {'k1': one_counts['segment_sum_sorted']
                + mh_counts['segment_sum_sorted']
                + sum(_launch_sums(dp + gs, 'segment_sum_sorted')),
                'k2': one_counts['softmax_aggregate_sorted']
                + mh_counts['softmax_aggregate_sorted']
                + sum(_launch_sums(dp + gs, 'softmax_aggregate_sorted'))}
    return launches, k1_err


# ---------------------------------------------------------------- 14
def phase_double_refused(root: Path, types: Path):
    run = root / 'double_cuda'
    data = str(types.parent)
    proc = subprocess.run(
        [sys.executable, '-m', 'pointvs_tpu_torch.main', 'egnn', str(run),
         '--train_data_root_pose', data, '--train_types_pose', str(types),
         '--layers', '2', '-b', '32', '--double'],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    check(proc.returncode != 0 and '--device cpu' in proc.stderr
          and not run.exists(),
          f'--double on the card: exit {proc.returncode}, run directory '
          f'{"left" if run.exists() else "absent"}:\n{proc.stderr[-2000:]}')
    print(f'double: main --double on the card exited {proc.returncode}: '
          f'{proc.stderr.strip().splitlines()[-1]}')


# ------------------------------------------------------- dataset tools
TOOLS_COPIES = 32            # of each of the source tree's 2 poses: 64
TOOLS_SCREEN_POSES = 256
TOOLS_CPU_POSES = 32
# The multitask CLI phase's README flags, the affinity phase alone.
TOOLS_AFFINITY_FLAGS = ['regression' if flag == 'both' else flag
                        for flag in MT_CLI_FLAGS]


def write_tools_source(src: Path) -> Path:
    """A source tree laid out from ``tests/resources``:
    ``receptors/rec_0.parquet``, ``ligands/rec_0_actives/lig_0.parquet``
    and ``ligands/rec_0_decoys/lig_1.parquet`` (the test ligand twice; the
    library names its copies by stem) and a types file labelling them 1
    and 0."""
    (src / 'receptors').mkdir(parents=True)
    (src / 'receptors' / 'rec_0.parquet').write_bytes(
        (RESOURCES / 'rec_0.parquet').read_bytes())
    lines = []
    for label, kind in ((1, 'actives'), (0, 'decoys')):
        sub = src / 'ligands' / f'rec_0_{kind}'
        sub.mkdir(parents=True)
        (sub / f'lig_{1 - label}.parquet').write_bytes(
            (RESOURCES / 'lig_0.parquet').read_bytes())
        lines.append(f'{label} -1 -1.0 receptors/rec_0.parquet '
                     f'ligands/rec_0_{kind}/lig_{1 - label}.parquet')
    (src / 'src.types').write_text('\n'.join(lines) + '\n')
    return src / 'src.types'


def phase_dataset_tools(torch, np, root: Path, card: str):
    """The dataset tools feeding the card, in process: ``replicate_poses
    train`` writes 64 poses and ``replicate_poses screen`` a 256-pose
    library from a source tree laid out from ``tests/resources``;
    ``synthetic_affinity`` labels the 64 poses; ``main multitask
    --model_task regression`` with the multitask CLI phase's README flags
    trains the affinity head on them for one epoch at batch 32 (K2 6 a
    step, no K3/K4), its first-step loss within 1e-4 of a ``--device cpu``
    run's; ``screen`` scores the library with the README serving run (K2
    6 a batch, one offset computation a batch), its first 32 ligands
    within 1e-4 of a ``--device cpu`` screen. Returns the K1 and K2
    launches."""
    from pointvs_tpu_torch.dataset_generation import replicate_poses, \
        synthetic_affinity
    from pointvs_tpu_torch.main import main as train_main
    from pointvs_tpu_torch.ops import segment_kernels as sk
    from pointvs_tpu_torch.screen import screen
    src_types = write_tools_source(root / 'tools_source')
    src = src_types.parent
    train, lib = root / 'tools_train', root / 'tools_library'
    start = time.perf_counter()
    replicate_poses.main(['train', str(src), str(src_types), str(train),
                          '--copies', str(TOOLS_COPIES), '--seed',
                          str(SEED)])
    replicate_poses.main(['screen', str(src), 'rec_0', str(lib),
                          '--n_poses', str(TOOLS_SCREEN_POSES), '--seed',
                          str(SEED)])
    n_train = len((train / 'scale.types').read_text().splitlines())
    library = sorted(lib.glob('*.parquet'))
    check(n_train == 2 * TOOLS_COPIES
          and len(library) == TOOLS_SCREEN_POSES,
          f'dataset tools: {n_train} training poses, {len(library)} '
          f'library poses')
    affinity = synthetic_affinity.make_types(train, train / 'scale.types',
                                             train / 'affinity.types')
    pks = np.asarray([float(line.split()[1]) for line in
                      affinity.read_text().splitlines()])
    check(len(pks) == n_train and np.isfinite(pks).all() and pks.std() > 0,
          f'synthetic_affinity: labels {pks}')
    tools_s = time.perf_counter() - start

    def argv(run, device):
        return (['multitask', str(run), '--train_data_root_affinity',
                 str(train), '--train_types_affinity', str(affinity)]
                + TOOLS_AFFINITY_FLAGS + ['--device', device])

    sk.reset_launch_counts()
    start = time.perf_counter()
    gpu = train_main(argv(root / 'tools_affinity_cuda', 'cuda'))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    counts = sk.launch_counts()
    steps = len(gpu.train_losses)
    check(steps == n_train // 32 and np.isfinite(gpu.train_losses).all(),
          f'affinity CLI: losses {gpu.train_losses}')
    check(counts['softmax_aggregate_sorted'] == 6 * steps
          and counts['fused_edge_forward'] == 0
          and counts['fused_edge_backward'] == 0,
          f'affinity CLI launches {counts}: expected K2 = 6 x {steps} '
          f'steps, no K3/K4')
    launches = {'k1': counts['segment_sum_sorted'],
                'k2': counts['softmax_aggregate_sorted']}
    cpu = train_main(argv(root / 'tools_affinity_cpu', 'cpu'))
    first = abs(gpu.train_losses[0] - cpu.train_losses[0])
    check(first <= 1e-4, f'affinity CLI: first-step losses differ by '
                         f'{first}')
    ms = np.asarray(gpu.step_ms())
    print(f'dataset tools: {card}: replicate_poses ({n_train} training, '
          f'{len(library)} library poses) and synthetic_affinity (pK mean '
          f'{pks.mean():.3f}, std {pks.std():.3f}) {tools_s:.3f} s; affinity '
          f'CLI {steps} steps, wall {train_s:.3f} s, step_ms '
          f'{ms.round(3).tolist()} (CUDA events); losses '
          f'{gpu.train_losses}; first-step |gpu - cpu| {first:.3e}; '
          f'launches {counts}')

    run = root / SCREEN_PATH_RUN
    receptor = src / 'receptors' / 'rec_0.parquet'
    first_dir = root / 'tools_library_first'
    first_dir.mkdir()
    for path in library[:TOOLS_CPU_POSES]:
        (first_dir / path.name).write_bytes(path.read_bytes())
    cpu_scores = {Path(r['ligand']).name: r['score'] for r in screen(
        run, receptor, str(first_dir), output=str(root / 'tools_cpu.csv'),
        batch_size=32, device='cpu').rows}
    sk.reset_launch_counts()
    result = screen(run, receptor, str(lib), output=str(
        root / 'tools_screen.csv'), batch_size=32)
    torch.cuda.synchronize()
    counts = sk.launch_counts()
    batches = -(-TOOLS_SCREEN_POSES // 32)
    check(counts['softmax_aggregate_sorted'] == 6 * batches
          and counts['segment_offsets'] == batches
          and counts['segment_sum_sorted'] == 0,
          f'tools screen launches {counts}: expected K2 = 6 x {batches}')
    scores = {Path(r['ligand']).name: r['score'] for r in result.rows}
    check(len(scores) == TOOLS_SCREEN_POSES
          and np.isfinite(list(scores.values())).all(),
          f'tools screen: {len(scores)} scores')
    diff = max(abs(scores[lig] - v) for lig, v in cpu_scores.items())
    check(diff <= 1e-4, f'tools screen: GPU and CPU scores differ by {diff}')
    launches['k1'] += counts['segment_sum_sorted']
    launches['k2'] += counts['softmax_aggregate_sorted']
    print(f'dataset tools: {card}: screen of the replicated library '
          f'({result.path}): {TOOLS_SCREEN_POSES} poses at '
          f'{result.poses_per_second:.1f} poses/s; max|gpu - cpu| over the '
          f'first {TOOLS_CPU_POSES} {diff:.2e}; launches {counts}')
    return launches


LUCID_STEP_FLAGS = dict(LUCID_6L, num_layers=3, dropout=DROPOUT_RATE)
LUCID_STEP_COUNT = 12


def lucid_step_ms(package_root: str) -> int:
    """``--lucid-step ROOT``: the lucid 3-layer ``--dropout 0.1`` step of
    the port found under ROOT (a checkout of any commit of this
    repository), as ``Trainer.train_model`` takes it on the pose set at
    batch 32: step ms by CUDA events, printed as one JSON line. Run it for
    two trees in turns in one call to compare them."""
    sys.path.insert(0, str(Path(package_root).resolve()))
    import numpy as np
    import torch
    import pointvs_tpu_torch
    from pointvs_tpu_torch.data.loader import get_data_loader
    from pointvs_tpu_torch.training.engine import Trainer
    check(torch.cuda.is_available(), 'torch.cuda.is_available() is False')
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        types, _ = write_pose_set(np, root / 'data')
        host = list(get_data_loader(types.parent, types, batch_size=32,
                                    radius=10, edge_radius=4,
                                    polar_hydrogens=False, prefetch=0))
        steps = [host[i % len(host)] for i in range(LUCID_STEP_COUNT)]
        trainer = Trainer('lucid', root / 'run', torch.device('cuda'),
                          learning_rate=TRAIN_LR, weight_decay=1e-4,
                          seed=SEED, **dict(MODEL_KWARGS, **LUCID_STEP_FLAGS))
        trainer.train_model(steps, epochs=1)
        ms = trainer.step_ms()
    print(json.dumps({'package': str(Path(
        pointvs_tpu_torch.__file__).parent), 'lucid_step_flags':
        LUCID_STEP_FLAGS, 'step_ms': [round(v, 3) for v in ms],
        'median_ms_after_2': statistics.median(ms[2:]),
        'losses': trainer.train_losses}))
    return 0


def featurise_tree(package_root: str) -> int:
    """``--featurise ROOT``: the host featurisation a pose of the port
    found under ROOT (any checkout of this repository) over the screen's
    SCREEN_POSES poses, by ``PointCloudDataset`` and, in a tree that has
    it, ``SharedReceptorDataset``, and a ``default_3l`` screen of them at
    batch 32 on the card (poses/s and the host featurisation share, the
    second of two screens), printed as one JSON line. Run it for two
    trees in turns in one call to compare them."""
    sys.path.insert(0, str(Path(package_root).resolve()))
    import numpy as np
    import torch
    import pointvs_tpu_torch
    from pointvs_tpu_torch.data.dataset import PointCloudDataset
    from pointvs_tpu_torch.screen import screen
    check(torch.cuda.is_available(), 'torch.cuda.is_available() is False')
    datasets = [PointCloudDataset]
    try:   # the screen's own dataset up to PR 11
        from pointvs_tpu_torch.data.shared_receptor import \
            SharedReceptorDataset
        datasets.insert(0, SharedReceptorDataset)
    except ImportError:
        pass
    out = {'package': str(Path(pointvs_tpu_torch.__file__).parent)}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        types, _ = write_pose_set(np, root / 'library', SCREEN_POSES)
        lib = types.parent
        from pointvs_tpu_torch.data.preprocessing import read_struct
        for path in lib.glob('*.parquet'):   # neither pays the first reads
            read_struct(path)
        for cls in datasets:
            ms, first, _ = featurise_ms(np, cls, lib, types)
            out[cls.__name__] = {'ms_a_pose': ms, 'first_ms': first}
        run = root / 'default_3l'
        write_run_dir(torch, run, dict(num_layers=3))
        for rep in range(2):
            result = screen(run, lib / 'rec_0.parquet',
                            str(lib / 'lig_*.parquet'),
                            output=str(root / f'hits_{rep}.csv'),
                            batch_size=32)
        sec = result.seconds
        out['screen_default_3l_b32'] = {
            'poses_per_s': result.poses_per_second,
            'host_share': sec['featurise'] / sec['total'],
            'seconds': sec}
    print(json.dumps(out))
    return 0


def main() -> int:
    phase_seconds = {}

    def timed(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        phase_seconds[name] = round(time.perf_counter() - start, 1)
        return out

    try:
        import numpy as np
        import torch
        card = phase_device(torch)
        check((RESOURCES / 'lig_0.parquet').exists(),
              f'{RESOURCES} is missing: run from a checkout of the repo')
        timed('build', phase_build)
        err, timings = timed('kernels', phase_kernels, torch, np)
        fused_err, fused_timings = timed('fused_kernels',
                                         phase_fused_kernels, torch, np)
        err.update(fused_err)
        timings.update(fused_timings)
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            types, n_poses = write_pose_set(np, root / 'data')
            launches = timed('serving', phase_serving, torch, np, root,
                             types, n_poses)
            screen_launches = timed('screen', phase_screen, torch, np, root,
                                    card)
            wire_launches = timed('wire', phase_wire, torch, np, root, card)
            attr_launches, attr_err = timed('attribution', phase_attribution,
                                            torch, np, root, card)
            err['k1'] = max(err['k1'], attr_err['k1'])
            err['softmax'] = max(err['softmax'], attr_err['softmax'])
            tail_launches, tail_err = timed(
                'attribution_tail', phase_attribution_tail, torch, np, root,
                types, card)
            for key, value in tail_err.items():
                err[key] = max(err[key], value)
            recv_err, recv_timings = timed(
                'receiver_sorted', phase_receiver_sorted, torch, np, root,
                types)
            err['k1'] = max(err['k1'], recv_err)
            timings.update(recv_timings)
            err['dropout'], drop_timings = timed(
                'dropout_kernel', phase_dropout_kernel, torch, np, root,
                types)
            timings.update(drop_timings)
            train_launches = timed('training', phase_training, torch, np,
                                   root, types)
            cli_launches = timed('training_cli', phase_training_cli, torch,
                                 np, root, types, card)
            dd_launches, dd_err = timed('device_dataset',
                                        phase_device_dataset, torch, np,
                                        root, types, card)
            for key, value in dd_err.items():
                err[key] = max(err[key], value)
            family_launches = timed('family_training',
                                    phase_family_training, torch, np, root,
                                    types, card)
            mt_launches = timed('multitask_cli', phase_multitask_cli, torch,
                                np, root, types, card)
            input_launches = timed('input_cli', phase_input_cli, torch, np,
                                   root, types, n_poses, card)
            strain_launches = timed('strain_fused', phase_strain_fused,
                                    torch, np, root)
            bf16_launches = timed('bf16', phase_bf16, torch, np, root,
                                  types, n_poses, card)
            sp_launches = timed('synthpharm', phase_synthpharm, torch, np,
                                root, types, card)
            so_launches, so_err = timed('scale_out', phase_scale_out, torch,
                                        np, root, types, card)
            err['k1'] = max(err['k1'], so_err)
            tools_launches = timed('dataset_tools', phase_dataset_tools,
                                   torch, np, root, card)
            timed('double_refused', phase_double_refused, root, types)
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

    def served(kernel, names=None):
        """Launches of ``kernel`` over the serving runs (or ``names``),
        the screens, the attributions and the attribution tail."""
        return sum(counts.get(kernel, 0) for name, counts in
                   list(launches.items()) + list(screen_launches.items())
                   + list(attr_launches.items())
                   + list(tail_launches.items())
                   if names is None or name in names)

    softmax_runs = [name for name in SERVING if name != 'sigmoid_3l'] + [
        'screen_attribute_top'] + list(tail_launches)
    kernels = [
        entry('segment_sum_sorted', K1_SOURCE, K1_REPLACES,
              served('segment_sum_sorted') + dd_launches['k1']
              + so_launches['k1'] + tools_launches['k1']
              + wire_launches['k1'], 'k1', 'k1_36'),
        entry('softmax_aggregate_sorted[softmax]', K1_SOURCE, K2_REPLACES,
              served('softmax_aggregate_sorted', softmax_runs)
              + dd_launches['k2'] + so_launches['k2']
              + tools_launches['k2'] + wire_launches['k2'], 'softmax',
              'softmax'),
        entry('softmax_aggregate_sorted[sigmoid]', K1_SOURCE, K2_REPLACES,
              served('softmax_aggregate_sorted', ['sigmoid_3l']),
              'sigmoid', 'sigmoid'),
        entry('fused_edge_forward', K3_SOURCE, K3_REPLACES,
              train_launches['k3'] + dd_launches['k3']
              + wire_launches['k3'], 'k3', 'k3'),
        entry('fused_edge_backward', K4_SOURCE, K4_REPLACES,
              train_launches['k4'] + dd_launches['k4']
              + wire_launches['k4'], 'k4', 'k4'),
        entry('threefry_dropout', DROPOUT_SOURCE, DROPOUT_REPLACES,
              family_launches['lucid_3l_dropout']['threefry_dropout'],
              'dropout', 'dropout_edge'),
    ]
    print(f'launches on the main paths: serving {launches}; training '
          f'(module path K1/K2, fused path K3/K4) {train_launches}; '
          f'training CLI {cli_launches}; ids steps of the device-resident '
          f'dataset {dd_launches}; lucid / en_transformer training '
          f'{family_launches}; multitask CLI {mt_launches}; siamese, '
          f'strain and dense CLIs {input_launches}; strain Trainer on the '
          f'fused path {strain_launches}; bf16 Trainer {bf16_launches}; '
          f'synthpharm CLI {sp_launches}; screens {screen_launches}; '
          f'attribution {attr_launches}; attribution tail {tail_launches}; '
          f'scale-out (every rank) {so_launches}; dataset tools '
          f'{tools_launches}; packed wire paths {wire_launches}')
    print(f'phase wall seconds: {json.dumps(phase_seconds)}')
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def scale_out_cards(ranks: int) -> int:
    """``--scale-out-cards N``: the build and the scale_out phase with N
    ranks, each on a card of its own (NCCL); needs N cards. Exits 0 when
    the phase passes."""
    try:
        import numpy as np
        import torch
        card = phase_device(torch)
        check(torch.cuda.device_count() >= ranks,
              f'{ranks} ranks need {ranks} cards, '
              f'{torch.cuda.device_count()} visible')
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            types, _ = write_pose_set(np, root / 'data')
            start = time.perf_counter()
            phase_scale_out(torch, np, root, types, card, ranks)
            print(f'scale_out phase {time.perf_counter() - start:.1f} s')
    except Exception:
        traceback.print_exc()
        print('chip_smoke --scale-out-cards: FAILED', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    if len(sys.argv) == 3 and sys.argv[1] == '--scale-out-cards':
        sys.exit(scale_out_cards(int(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == '--lucid-step':
        sys.exit(lucid_step_ms(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == '--featurise':
        sys.exit(featurise_tree(sys.argv[2]))
    sys.exit(main())
