"""Library screening: rank a ligand library against one receptor with a
trained model (counterpart of ``pointvs_tpu/screen.py``).

The library (a directory searched for ``*.parquet``, a glob or one file)
is sorted by file size, so that batches hold poses of similar size, and
written as an unlabelled ``<receptor> <ligand>`` manifest beside the
output. The run directory's model serves with the run's own graph flags
(``cmd_args.yaml``) through the standard pipeline (``PointCloudDataset``;
the reference's ``SharedReceptorDataset`` gives the same graphs, and the
port's native graph builder takes less time a pose than its shared
receptor grid, PERF.md). The serving eval step (the module path: K2 with
attention, K1 without) scores every batch, the logits stay on the device
until the last batch is dispatched and come back in one copy. Scores are
the sigmoid of the pose logit (classification) or the mean of the
outputs (regression), written ranked as ``ligand,score,rank``. Rows come
in library order before the ranking sort, on every path.

How the library reaches the device (the reference's store decision):

- **Resident** (the default, ``POINTVS_SCREEN_DEVICE=1``): the library is
  featurised once into a device-resident store
  (``data/device_dataset.py``), one node and one edge bucket are pinned
  for the whole screen from the store's size arrays, and each batch is
  collated on the device from its item ids. With ``--cache_dir`` the
  built store is cached there, keyed by the manifest, each input file's
  (size, mtime_ns) and the graph flags, so a re-screen skips
  featurisation and a rewritten pose invalidates it.
- **Chunked**: a store past ``POINTVS_DD_BUDGET_MB`` (default 2048), or
  any store when ``POINTVS_SCREEN_CHUNK_MB`` is set, goes to the device
  in item ranges of that many MB (``plan_chunks``, ``pack_chunk``,
  ``expand_chunk``; the codecs ``POINTVS_CHUNK_DEGREES``, ``_COORDS16``,
  ``_RPERM12`` and ``_DEG8``, all on by default; coords16 is lossy within
  half a fixed-point step; ``POINTVS_SCREEN_CHUNK_RAW=0`` takes the
  reference's other codec: exact coordinates and uint16 edge lists, of a
  mirrored store only the half with sender < receiver). Each chunk's poses are scored in budget
  batches: contiguous poses until ``POINTVS_SCREEN_EDGE_BUDGET`` edges
  (default 131072) or ``POINTVS_SCREEN_MAX_BS`` poses (default four
  batches) fill one fixed (nodes, edges) shape.
- **Streaming** (``POINTVS_SCREEN_DEVICE=0``, and always under
  ``POINTVS_SCREEN_SCAN=1``): the host collates every batch, after one
  sizing pass over the library, and the loader's producer thread
  compresses and packs it (``data/wire.py``). ``POINTVS_SCREEN_GROUP``
  (default 8) packed batches of one wire template go to the device as one
  ``[G, nbytes]`` copy from pinned memory; the eval step then decodes and
  scores each of them, or under ``POINTVS_SCREEN_SCAN=1`` the scan eval
  step scores the whole group in one call, a short last group padded by
  repeating its last buffer (``parallel/steps.make_scan_eval_step``).

With ``--attribute_top N`` the N best hits are attributed with the method
``--attribution`` names (``attribution.score_atoms``, the run's radius and
edge radius) into ``top_hit_attributions/<ligand>_<method>.csv`` beside
the output. A run trained with ``--include_strain_info`` is scored with
dE = 0, as the reference's screen scores it (its loader carries no strain
column; ROADMAP.md, Queue 3).

``--num_devices D`` (the reference's ``_auto_num_devices``: at most the
visible cards, a divisor of the batch size, and here at most the
library's size) screens on D spawned ranks (``parallel/launch.py``): rank
r featurises and scores the stripe ``library[r::D]`` of the size-sorted
library at ``batch_size / D`` poses a batch, so that the ranks' batch j
together are one device's batch j, and every rank makes as many eval
calls as the longest stripe needs (a whole-batch GraphNorm statistic
sums over the ranks in each). The ranks agree on the path (any rank's
store past the budget chunks them all); rank 0 gathers every rank's
rows, restores library order, and writes the CSV, the manifest and the
top hits' attributions one device writes.

A profiler running in the caller sees the call as ten spans
(``tracing.py``) that tile it in order: ``pointvs.screen.collect``,
``load_model``, ``dataset``, ``cache_key``, ``store_load``, ``bucket``,
``store_upload``, ``eval``, ``drain``, ``rank_write`` (the store's three
only on the resident and chunked paths, the cache key only with
``--cache_dir``). In a re-screen from ``--cache_dir``, ``store_load`` is
the cached store's read; in a first screen it is the featurisation. The
profiler's run also keeps the counts ``pointvs.screen.real_edges`` (the
library's edges) and ``pointvs.screen.padded_edges`` (the edges of the eval
batches' buckets, every one of which each layer computes).

Refused as runs the reference's screen stops on (``ValueError`` naming the flag):
``--extended_atom_types``, ``--synthpharm`` and the receptor/ligand pair
and dense layouts. The reference's one-shot and repeated scoring
programs (``POINTVS_SCREEN_ONESHOT``, ``_REPEAT``) and its scan's
unrolling (``POINTVS_SCREEN_UNROLL``) tune XLA programs; they give the
scores of these paths and the port reads none of them (README.md).

Usage:
    python -m pointvs_tpu_torch.screen <run_dir> <receptor.parquet> \\
        <ligand_dir_or_glob> --output hits.csv --batch_size 256 \\
        [--attribute_top N --attribution atom_masking] [--cache_dir DIR] \\
        [--num_devices D] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import csv
import glob
import hashlib
import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pointvs_tpu_torch.data.buckets import pick_bucket
from pointvs_tpu_torch.data.device_dataset import (
    STORE_FORMAT, DeviceCollateSpec, DeviceGraphStore, build_host_store,
    expand_chunk, load_host_store, pack_chunk, plan_chunks,
    save_host_store, upload_chunk)
from pointvs_tpu_torch.data.loader import BatchMeta, get_data_loader
from pointvs_tpu_torch.data.wire import Staged, compress, pack, template, \
    upload
from pointvs_tpu_torch.device import refuse_double_on_cuda, resolve_device
from pointvs_tpu_torch.inference import _auto_num_devices
from pointvs_tpu_torch.models.load_model import load_model, run_args
from pointvs_tpu_torch.models.registry import model_input_kind
from pointvs_tpu_torch.parallel.launch import spawn
from pointvs_tpu_torch.parallel.mesh import Mesh
from pointvs_tpu_torch.parallel.steps import make_eval_step, \
    make_scan_eval_step
from pointvs_tpu_torch.tracing import count, span
from pointvs_tpu_torch.utils import expand_path, get_logger, mkdir

LOG = get_logger()
# Run flags the reference's screen leaves out of its loader, where it then
# stops (ROADMAP.md, Queue 3). It also leaves out --include_strain_info,
# and scores such a run with dE = 0, as this screen does.
UNSERVED_FLAGS = ('extended_atom_types', 'synthpharm')
# What pathlib would rewrite in an absolute path: '//', a '.' part, a
# trailing '/'.
_UNNORMALISED = re.compile(r'//|/\.(/|$)|./$')
# A directory opened only to stat its files by name (O_PATH needs no read
# permission on it, as a stat by path needs none).
_DIR_FLAGS = os.O_DIRECTORY | getattr(os, 'O_PATH', os.O_RDONLY)


@dataclass
class ScreenResult:
    """The ranked rows (``ligand``, ``score``, ``rank``, best first), the
    screen's wall seconds by part: ``load`` (model), ``featurise`` (the
    store's build or its load from the cache, or the streaming path's
    sizing pass, which builds and caches every graph), ``score``
    (uploads, collation, the eval steps and the drain) and ``total``; with
    ``--attribute_top``, ``attribute`` (the top hits' attributions, after
    ``total``); and the ``path`` the library took: ``resident``,
    ``chunked`` or ``streaming``."""
    rows: list
    seconds: dict = field(default_factory=dict)
    path: str = 'streaming'

    @property
    def poses_per_second(self) -> float:
        return len(self.rows) / max(self.seconds.get('total', 0.0), 1e-12)


def _collect_ligands(ligands) -> list:
    """Absolute paths of the library: every ``*.parquet`` under a
    directory, the matches of a glob, or the one file, sorted by name."""
    path = Path(ligands)
    if path.is_dir():
        found = sorted(str(p) for p in path.glob('**/*.parquet'))
    elif any(ch in str(ligands) for ch in '*?['):
        found = sorted(glob.glob(str(ligands), recursive=True))
    else:
        found = [str(path)]
    # The manifest resolves against '/', so its paths are absolute, each as
    # expand_path gives it. A match already in that form (joined to the
    # working directory where it is relative) is kept as it is, which
    # spares a library of thousands three Path objects a file.
    cwd = os.getcwd() if any(p[:1] != '/' for p in found) else ''
    absolute = []
    for p in found:
        q = p if p[:1] == '/' else f'{cwd}/{p}'
        if p[:1] == '~' or '$' in p or _UNNORMALISED.search(q):
            q = str(expand_path(p))
        absolute.append(q)
    return absolute


def _stat_files(paths: list) -> tuple:
    """Each file's (size, mtime_ns), (0, 0) where it cannot be statted,
    and the number of stat calls made: one a file, by its name against an
    open descriptor of its directory, so that the directory's path is
    looked up once and not once a file. Serial: threads sharing the calls
    took longer on a file system that answers one stat at a time (9p,
    PERF.md)."""
    fingerprints = [(0, 0)] * len(paths)
    by_dir = {}
    for i, p in enumerate(paths):
        head, sep, name = p.rpartition('/')
        by_dir.setdefault(head or sep or '.', []).append((i, name))
    made = 0
    for head, files in by_dir.items():
        try:
            fd = os.open(head, _DIR_FLAGS)
        except OSError:   # each file by its path then: it fails alike
            fd, files = None, [(i, paths[i]) for i, _ in files]
        try:
            for i, name in files:
                made += 1
                try:
                    st = os.stat(name, dir_fd=fd)
                except OSError:
                    continue
                fingerprints[i] = (st.st_size, st.st_mtime_ns)
        finally:
            if fd is not None:
                os.close(fd)
    return fingerprints, made


def _scan_library(ligands, receptor) -> tuple:
    """One pass over the library: its files in screening order, the
    (size, mtime_ns) of the receptor and then of each file in that order
    (what keys the store cache), and the stat calls made, one a file.
    The order is by name, then stably by size (a stat, not a parquet read,
    a file): batches of similar poses waste less padding under the one
    pinned bucket."""
    files = _collect_ligands(ligands)
    fingerprints, calls = _stat_files([str(receptor)] + files)
    order = sorted(range(len(files)), key=lambda i: fingerprints[i + 1][0])
    return ([files[i] for i in order],
            fingerprints[:1] + [fingerprints[i + 1] for i in order], calls)


def refuse_unserved(cmd_args: dict) -> None:
    """Raise for a run the reference's screen stops on."""
    for flag in UNSERVED_FLAGS:
        if cmd_args.get(flag):
            raise ValueError(
                f'--{flag}: the screen builds its graphs without it, as the '
                f'reference screen does, which then stops on a --{flag} '
                f'run (see ROADMAP.md, Queue 3)')
    model = cmd_args.get('model', 'egnn')
    kind = model_input_kind(model)
    if kind != 'graph':
        raise ValueError(
            f'model {model!r} takes {kind} batches; the screen builds graph '
            f'batches only, as the reference screen does (see ROADMAP.md, '
            f'Queue 3)')


def _store_cache_path(cache_dir, manifest: Path, fingerprints: list,
                      cmd_args: dict, defaults: dict) -> Path:
    """The store's file under ``cache_dir``: a digest of the manifest,
    the (size, mtime_ns) of its receptor and then of each of its ligand
    files, as the library's scan found them (a pose rewritten at its path
    invalidates it), and the graph flags."""
    params = (manifest.read_text(), list(fingerprints),
              cmd_args.get('compact', True),
              cmd_args.get('radius', defaults['radius']),
              cmd_args.get('edge_radius', defaults['edge_radius']),
              cmd_args.get('estimate_bonds', defaults['estimate_bonds']),
              cmd_args.get('prune', False),
              cmd_args.get('use_atomic_numbers', False),
              cmd_args.get('hydrogens', False), STORE_FORMAT)
    digest = hashlib.sha1(repr(params).encode()).hexdigest()[:24]
    return Path(cache_dir) / f'torch_store_{digest}.bin'


def _host_store(dataset, store_path):
    """The library's host store, loaded from ``store_path`` where it was
    cached, else built (and cached there)."""
    if store_path is not None:
        host = load_host_store(store_path)
        if host is not None:
            LOG.info(f'Host store loaded from {store_path} '
                     f'({host.nbytes / 1e6:.0f} MB)')
            return host
    host = build_host_store(dataset)
    if store_path is not None:
        save_host_store(host, store_path)
        LOG.info(f'Host store cached to {store_path}')
    return host


def _budget_batches(host, lo: int, hi: int, n_bud: int, e_bud: int,
                    max_bs: int) -> list:
    """Contiguous item spans of [lo, hi) that each fill at most ``n_bud``
    nodes, ``e_bud`` edges and ``max_bs`` poses (a single larger pose is
    a span of its own)."""
    spans, i = [], lo
    while i < hi:
        n = e = 0
        j = i
        while (j < hi and j - i < max_bs
               and n + host.num_nodes[j] <= n_bud
               and e + host.num_edges[j] <= e_bud):
            n += int(host.num_nodes[j])
            e += int(host.num_edges[j])
            j += 1
        spans.append((i, max(j, i + 1)))
        i = max(j, i + 1)
    return spans


def _agreed_max(mesh: Mesh, value: int, device) -> int:
    """The largest ``value`` over the mesh's ranks."""
    if not mesh.distributed:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def _score_chunked(host, chunk_budget: float, eval_fn, device,
                   batch_size: int, mesh: Mesh):
    """Score the library through device-resident chunks: pack a range of
    items on the host, upload and expand it on the device, score its
    budget batches (on a mesh, padded with empty ones to the most any
    rank has). Returns (logits, metas) in library order."""
    ranges, cspec = plan_chunks(
        host, chunk_budget,
        raw=os.environ.get('POINTVS_SCREEN_CHUNK_RAW', '1') == '1')
    LOG.info(f'Chunked screen: {len(ranges)} chunks of <= {cspec.items} '
             f'poses ({cspec.n_fix} nodes x {cspec.eh_fix} '
             f'{"half-" if cspec.half and not cspec.raw else ""}edge slots)')
    nn, ne = host.num_nodes, host.num_edges
    max_bs = int(os.environ.get('POINTVS_SCREEN_MAX_BS',
                                str(batch_size * 4)))
    e_bud = max(int(os.environ.get('POINTVS_SCREEN_EDGE_BUDGET', '131072')),
                int(ne.max(initial=1)))
    n_bud = max(int(e_bud * (nn.sum() / max(ne.sum(), 1)) * 1.4),
                int(nn.max(initial=1)))
    n_bud, e_bud = -(-n_bud // 256) * 256, -(-e_bud // 256) * 256
    spans = {r: _budget_batches(host, *r, n_bud, e_bud, max_bs)
             for r in ranges}
    num_graphs = max(j - i for chunk in spans.values() for i, j in chunk)
    spec = DeviceCollateSpec(n_pad=n_bud, e_pad=e_bud,
                             num_graphs=num_graphs,
                             symmetric=host.symmetric, rotate=False)
    LOG.info(f'Chunked screen: {sum(map(len, spans.values()))} budget '
             f'batches of <= {num_graphs} poses ({n_bud} nodes x {e_bud} '
             f'edges)')
    calls = _agreed_max(mesh, sum(map(len, spans.values())), device)
    logits, metas = [], []
    for lo, hi in ranges:
        arrays = expand_chunk(upload_chunk(pack_chunk(host, lo, hi, cspec),
                                           device), cspec)
        for b_lo, b_hi in spans[(lo, hi)]:
            ids = np.full((1, num_graphs), -1, np.int32)
            ids[0, :b_hi - b_lo] = np.arange(b_lo - lo, b_hi - lo)
            logits.append(eval_fn(('ids', ids, arrays, spec)))
            graph_mask = (ids >= 0).astype(np.float32)
            metas.append(BatchMeta(host.lig_fnames[b_lo:b_hi],
                                   host.rec_fnames[b_lo:b_hi], None,
                                   graph_mask))
    for _ in range(calls - len(logits)):
        eval_fn(('ids', np.full((1, num_graphs), -1, np.int32), arrays,
                 spec))
    count('pointvs.screen.padded_edges', calls * e_bud)
    return logits, metas


def _pack_host(batch) -> tuple:
    """A host batch compressed and packed on the host: ``('host_packed',
    bytes, template, symmetric)``."""
    wire = compress(batch)
    return ('host_packed', pack(wire), template(wire),
            batch.inv_recv_perm is not None)


def _score_streaming(loader, eval_fn, scan_fn, device, calls: int):
    """Score the loader's batches, packed in its producer thread, in
    groups of ``POINTVS_SCREEN_GROUP`` batches of one template: one copy
    of the group's bytes to the device, then the eval step on each member,
    or ``scan_fn`` on the whole group, a short last group padded by
    repeating its last buffer. A stripe with fewer than ``calls`` batches
    scores placeholders after its own, so that every rank makes the same
    calls in the same groups. Returns (logits, metas) in library order."""
    group_size = max(1, int(os.environ.get('POINTVS_SCREEN_GROUP', '8')))
    loader.transfer_fn = _pack_host
    loader.prefetch = max(loader.prefetch, 3)

    def stream():
        n = 0
        for item in loader:
            n += 1
            yield item
        for _ in range(calls - n):
            yield _pack_host(loader.placeholder()), None

    logits, metas, group = [], [], []
    scan_len = None

    def flush(final: bool):
        nonlocal scan_len
        _, _, tmpl, symmetric = group[0][0]
        bufs = [batch[1] for batch, _ in group]
        if scan_fn is not None:
            if scan_len is None:
                scan_len = (len(bufs) if final and len(bufs) < group_size
                            else group_size)
            bufs += [bufs[-1]] * (scan_len - len(bufs))
        staged = upload(bufs, device)
        if scan_fn is not None:
            out = scan_fn(staged, tmpl, symmetric)
        else:
            out = [eval_fn(('packed', Staged(staged.data[i], staged.event),
                            tmpl, symmetric)) for i in range(len(group))]
        for (_, meta), row in zip(group, out):
            if meta is not None:
                logits.append(row)
                metas.append(meta)
        group.clear()

    def kind(batch):   # batches of one kind share a group
        return type(batch[2]), batch[2], batch[3]

    for batch, meta in stream():
        if group and kind(batch) != kind(group[0][0]):
            flush(False)
        group.append((batch, meta))
        if len(group) == group_size:
            flush(False)
    if group:
        flush(True)
    return logits, metas


def screen(model_path, receptor, ligands, output='screen_results.csv',
           batch_size: int = 256, radius: float = 10,
           edge_radius: float = 4, estimate_bonds: bool = False,
           attribute_top: int = 0, attribution: str = 'atom_masking',
           num_devices=None, cache_dir=None,
           device: str = 'cuda') -> ScreenResult:
    """Score every ligand against ``receptor`` and write the ranked CSV
    (and the top hits' attributions). ``radius``, ``edge_radius`` and
    ``estimate_bonds`` apply where the run's ``cmd_args.yaml`` does not
    set them. Spawned over ``num_devices`` ranks, rank 0's result."""
    from pointvs_tpu_torch.attribution.attribution_fns import \
        ATTRIBUTION_FNS
    if attribute_top > 0 and attribution not in ATTRIBUTION_FNS:
        raise ValueError(f'--attribution must be one of '
                         f'{sorted(ATTRIBUTION_FNS)}')
    saved = run_args(model_path)
    refuse_unserved(saved)
    refuse_double_on_cuda(saved.get('double', False), device)
    torch_device = resolve_device(device)
    start = time.perf_counter()

    receptor = expand_path(receptor)
    with span('pointvs.screen.collect'):
        lig_files, fingerprints, stat_calls = _scan_library(ligands,
                                                            receptor)
        if not lig_files:
            raise SystemExit(f'No ligand files found under {ligands}')
    job = dict(model_path=model_path, receptor=receptor,
               lig_files=lig_files, fingerprints=fingerprints,
               stat_calls=stat_calls, output=Path(output),
               batch_size=batch_size, radius=radius,
               edge_radius=edge_radius, estimate_bonds=estimate_bonds,
               attribute_top=attribute_top, attribution=attribution,
               cache_dir=cache_dir, start=start)
    world = min(_auto_num_devices(batch_size, device, num_devices),
                len(lig_files))
    if world > 1:
        return spawn(_screen_rank, world, device, job,
                     report=_screen_report)[0]
    return _screen_rank(torch_device, job)


def _screen_report(result: ScreenResult) -> ScreenResult:
    """A spawned rank's report: its result as it is."""
    return result


def _screen_rank(torch_device, job: dict) -> ScreenResult:
    """The screen on one rank (or the one device): featurise and score
    this rank's stripe of the library; rank 0 writes the outputs."""
    from pointvs_tpu_torch.attribution.attribution_fns import \
        ATTRIBUTION_FNS
    mesh = Mesh()
    receptor, output = job['receptor'], job['output']
    radius, edge_radius = job['radius'], job['edge_radius']
    estimate_bonds = job['estimate_bonds']
    lig_files = job['lig_files']
    stripe = lig_files[mesh.dp_rank::mesh.n_dp]
    fingerprints = job['fingerprints']
    fingerprints = (fingerprints[:1]
                    + fingerprints[1:][mesh.dp_rank::mesh.n_dp])
    batch_size = job['batch_size'] // mesh.n_dp
    manifest = output.with_suffix('.types')
    with span('pointvs.screen.load_model'):
        if mesh.chief:
            LOG.info(f'Screening {len(lig_files)} ligands against '
                     f'{receptor.name} ({job["stat_calls"]} stat calls in '
                     f'the library scan)')
            mkdir(output.parent if output.parent != Path('') else '.')
            manifest.write_text(''.join(f'{receptor} {lig}\n'
                                        for lig in lig_files))
        # A rank reads its own stripe's manifest.
        rank_manifest = manifest
        if mesh.distributed:
            rank_manifest = Path(tempfile.mkdtemp()) / 'stripe.types'
            rank_manifest.write_text(''.join(f'{receptor} {lig}\n'
                                             for lig in stripe))

        trainer, model_kwargs, cmd_args = load_model(job['model_path'],
                                                     torch_device, mesh=mesh)
        task = model_kwargs.get('model_task', 'classification')
        trainer.set_task('classification' if task == 'both' else task)
    loaded = time.perf_counter()

    with span('pointvs.screen.dataset'):
        loader = get_data_loader(
            '/', rank_manifest, batch_size=batch_size,
            compact=cmd_args.get('compact', True),
            radius=cmd_args.get('radius', radius),
            use_atomic_numbers=cmd_args.get('use_atomic_numbers', False),
            rot=False, polar_hydrogens=cmd_args.get('hydrogens', False),
            mode='val', model_task=trainer.model_task,
            edge_radius=cmd_args.get('edge_radius', edge_radius),
            estimate_bonds=cmd_args.get('estimate_bonds', estimate_bonds),
            prune=cmd_args.get('prune', False), cache_dir=job['cache_dir'])

    dataset = loader.dataset
    host = None
    scan = os.environ.get('POINTVS_SCREEN_SCAN', '0') == '1'
    if os.environ.get('POINTVS_SCREEN_DEVICE', '1') == '1' and not scan:
        store_path = None
        if job['cache_dir'] is not None:
            with span('pointvs.screen.cache_key'):
                store_path = _store_cache_path(
                    job['cache_dir'], rank_manifest, fingerprints,
                    cmd_args, dict(radius=radius, edge_radius=edge_radius,
                                   estimate_bonds=estimate_bonds))
        with span('pointvs.screen.store_load'):
            host = _host_store(dataset, store_path)
    with span('pointvs.screen.bucket'):
        max_n, max_e = _batch_sizes(host, dataset, batch_size)
        loader.node_buckets = [pick_bucket(max_n, loader.node_buckets)]
        loader.edge_buckets = [pick_bucket(max_e, loader.edge_buckets)]
        LOG.info(f'Screen bucket: {loader.node_buckets[0]} nodes x '
                 f'{loader.edge_buckets[0]} edges (max batch '
                 f'{max_n}/{max_e})')
        featurised = time.perf_counter()
        eval_fn = make_eval_step(trainer.model, trainer.model_task,
                                 multitask=trainer.multitask)
    path = 'streaming'
    if host is not None:
        with span('pointvs.screen.store_upload'):
            budget = float(os.environ.get('POINTVS_DD_BUDGET_MB',
                                          '2048')) * 1e6
            chunk_mb = float(os.environ.get('POINTVS_SCREEN_CHUNK_MB', '0'))
            chunked = _agreed_max(mesh, int(host.nbytes > budget
                                            or bool(chunk_mb)), torch_device)
            if not chunked:
                loader.enable_device_dataset(DeviceGraphStore(host,
                                                              torch_device))
                path = 'resident'
            else:
                path = 'chunked'
    # The longest stripe's batches, on every rank: a shorter stripe
    # scores one more batch without a pose.
    calls = -(-(-(-len(lig_files) // mesh.n_dp)) // batch_size)
    with span('pointvs.screen.eval'):
        if path == 'chunked':
            logits, metas = _score_chunked(host, chunk_mb * 1e6 or budget,
                                           eval_fn, torch_device,
                                           batch_size, mesh)
        elif path == 'resident':
            logits, metas = [], []
            for batch, meta in loader:
                logits.append(eval_fn(batch))
                metas.append(meta)
            for _ in range(calls - len(logits)):
                eval_fn(('ids', np.full_like(batch[1], -1)) + batch[2:])
        else:
            scan_fn = (make_scan_eval_step(trainer.model,
                                           trainer.model_task,
                                           multitask=trainer.multitask)
                       if scan else None)
            logits, metas = _score_streaming(loader, eval_fn, scan_fn,
                                             torch_device, calls)
        if path != 'chunked':
            count('pointvs.screen.padded_edges',
                  calls * loader.edge_buckets[0])
    with span('pointvs.screen.drain'):
        rows = _drain(logits, metas, trainer.model_task)
        if mesh.distributed:
            # Library order again: rank r's k-th row is pose r + k * D.
            gathered = [None] * mesh.world
            dist.all_gather_object(gathered, rows)
            rows = [None] * len(lig_files)
            for r, part in enumerate(gathered):
                rows[r::mesh.world] = part
    scored = time.perf_counter()

    with span('pointvs.screen.rank_write'):
        rows.sort(key=lambda r: -r['score'])
        for rank, row in enumerate(rows, start=1):
            row['rank'] = rank
        if mesh.chief:
            with open(output, 'w', newline='', encoding='utf-8') as f:
                writer = csv.DictWriter(f, fieldnames=('ligand', 'score',
                                                       'rank'))
                writer.writeheader()
                writer.writerows(rows)
    end = time.perf_counter()
    result = ScreenResult(rows, {
        'load': loaded - job['start'], 'featurise': featurised - loaded,
        'score': scored - featurised, 'total': end - job['start']}, path)
    LOG.info(f'Scored {len(rows)} poses ({path}) in '
             f'{result.seconds["total"]:.1f}s ({result.poses_per_second:.0f} '
             f'poses/s end to end); ranked results written to {output}')
    if job['attribute_top'] > 0 and mesh.chief:
        _attribute_top_hits(trainer, receptor, rows[:job['attribute_top']],
                            ATTRIBUTION_FNS[job['attribution']],
                            job['attribution'], output,
                            cmd_args.get('radius', radius),
                            cmd_args.get('edge_radius', edge_radius))
        result.seconds['attribute'] = time.perf_counter() - end
    return result


def _batch_sizes(host, dataset, batch_size: int) -> tuple:
    """The most nodes and edges of one batch of ``batch_size`` poses in
    library order: from the store's size arrays, or else by one pass over
    the library, which also builds every graph into the dataset's memory
    cache. One bucket of that size is pinned for the whole screen. The
    library's edges are kept as the count ``pointvs.screen.real_edges``."""
    if host is not None:
        nn = np.concatenate([[0], np.cumsum(host.num_nodes)])
        ne = np.concatenate([[0], np.cumsum(host.num_edges)])
        bounds = np.minimum(np.arange(0, len(host.num_nodes) + batch_size,
                                      batch_size), len(host.num_nodes))
        count('pointvs.screen.real_edges', int(ne[-1]))
        return (int(np.max(np.diff(nn[bounds]), initial=1)),
                int(np.max(np.diff(ne[bounds]), initial=1)))
    sizes = [(dataset[i].num_nodes, dataset[i].num_edges)
             for i in range(len(dataset))]
    max_n = max_e = 1
    for lo in range(0, len(sizes), batch_size):
        chunk = sizes[lo:lo + batch_size]
        max_n = max(max_n, sum(s[0] for s in chunk))
        max_e = max(max_e, sum(s[1] for s in chunk))
    count('pointvs.screen.real_edges', sum(s[1] for s in sizes))
    return max_n, max_e


def _drain(logits: list, metas: list, model_task: str) -> list:
    """Every batch's scores of its real poses as ``{'ligand', 'score'}``
    rows, after one copy back of all the batches' logits."""
    drained = torch.stack(logits).float().cpu().numpy()
    rows = []
    for out, meta in zip(drained, metas):
        scores = out[meta.graph_mask.reshape(-1) > 0]
        if model_task == 'classification':
            scores = 1 / (1 + np.exp(-scores[:, 0]))
        else:
            scores = scores.mean(axis=1)
        rows += [{'ligand': lig, 'score': float(score)}
                 for lig, score in zip(meta.lig_fnames, scores)]
    return rows


def _attribute_top_hits(trainer, receptor, hits, attribution_fn,
                        method: str, output: Path, radius: float,
                        edge_radius: float) -> None:
    """``top_hit_attributions/<ligand>_<method>.csv`` beside ``output``
    for each hit, as the reference's screen writes them."""
    from pointvs_tpu_torch.attribution.attribution import score_atoms
    out_dir = mkdir(output.parent / 'top_hit_attributions')
    for hit in hits:
        scored = score_atoms(trainer, receptor, hit['ligand'],
                             attribution_fn, radius=radius,
                             edge_radius=edge_radius)
        scored.to_csv(out_dir / f'{Path(hit["ligand"]).stem}_{method}.csv',
                      index=False)
    LOG.info(f'Attributions for the top {len(hits)} hits in {out_dir}')


def main(argv=None) -> ScreenResult:
    parser = argparse.ArgumentParser()
    parser.add_argument('model', help='Trained run directory or checkpoint')
    parser.add_argument('receptor', help='Receptor parquet')
    parser.add_argument('ligands', help='Ligand dir, glob or single file')
    parser.add_argument('--output', '-o', default='screen_results.csv')
    parser.add_argument('--batch_size', '-b', type=int, default=256)
    parser.add_argument('--attribute_top', type=int, default=0)
    parser.add_argument('--attribution', default='atom_masking')
    parser.add_argument('--num_devices', type=int, default=None)
    parser.add_argument('--cache_dir', default=None,
                        help='On-disk featurisation cache (libraries are '
                             'screened repeatedly; do not re-featurise)')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = parser.parse_args(argv)
    return screen(args.model, args.receptor, args.ligands,
                  output=args.output, batch_size=args.batch_size,
                  attribute_top=args.attribute_top,
                  attribution=args.attribution,
                  num_devices=args.num_devices, cache_dir=args.cache_dir,
                  device=args.device)


if __name__ == '__main__':
    main()
