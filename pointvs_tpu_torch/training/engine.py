"""Trainer: training, checkpoints and scoring, on one device or one rank.

Counterpart of ``pointvs_tpu/training/engine.py``: ``set_task``,
``training_setup``, ``train_model`` (epoch/batch loop, the learning rate
from the schedule each step, a NaN guard, mean active/decoy training
predictions), ``on_epoch_end``, ``save``, ``load_weights``,
``import_torch_weights``, ``val`` and the predictions-file format
(``<label> | <prob> <rec> <lig>``, three decimals). Checkpoints are ``.pt``
files in the reference layout (``training/checkpoints.py``). Unless
``silent``, the Trainer writes ``model_kwargs.yaml`` and appends the
reference's records to ``metrics.jsonl`` (``MetricsLogger``).

Each training step takes the reference's dropout key, computed on the
host (``ops/prng.step_key``): ``fold_in(fold_in(split(PRNGKey(seed))[1],
global_iter), 0)``, the reference Trainer's key for the step folded with
the one device's index. The EGNN families draw their edge-dropout seed
from it and the lucid family its masks, as the reference's flax models
do, so the port drops the edges and entries that the reference drops, on
the CPU and on the GPU. ``global_iter`` counts the Trainer's steps from
0; a Trainer rebuilt to resume starts it at 0 again, as the reference's
does. ``set_task`` switches the task,
and with it the multitask model's head and the epoch counter that
``epoch`` reads (``p_epoch`` for pose, ``a_epoch`` for affinity).
``profile`` traces steps 3-8 of the first epoch with ``torch.profiler``
into ``<save_path>/profile``; the trace carries the port's spans
(``tracing.py``: ``pointvs.train.*`` in ``train_model``, ``pointvs.step.*``
in the step) beside the device's kernels, as does any caller's profiler.
On a GPU every step is bracketed by CUDA events (``step_ms``);
``epoch_seconds`` holds each epoch's wall time.

``double`` is the reference's ``Trainer(double=True)`` (``--double``):
every float parameter, and so the optimiser state and the checkpoints, is
float64, and the steps take float64 batches. It runs on the CPU only, as
the reference's does. A ``fused_training`` Trainer whose model
``supports_fusion`` rejects (a bf16 or float64 model among them) raises
``ValueError`` at its first step, from ``fused_train.fused_apply``.

``device_cache`` (``auto``, ``on`` or ``off``; the CLI's
``--device_cache``) is the reference's device-resident dataset: where a
``GraphDataLoader``'s dataset is eligible (``device_dataset.
store_eligibility``: no label noise, no entity dropout, augmented actives
only through the hybrid tail) and fits the budget, ``train_model`` and
``val`` build its store once (kept per dataset), put it on the Trainer's
device and switch the loader to ids batches, collated on the device in
the step. ``auto`` takes it under the reference's estimates and
thresholds (``POINTVS_DD_BUDGET_MB``, default 2048, and
``POINTVS_DD_AUTO_MB``, default 512) and otherwise streams, logging why;
``on`` takes it past both and raises ``ValueError`` where the store
cannot serve (another layout, an ineligible dataset);
``POINTVS_DEVICE_DATASET=0`` turns it off. A rotating dataset's
rotation moves into the step, keyed by the step's JAX key
(``device_dataset.rotate_per_graph``).

Scale-out (``mesh``; the reference's ``num_devices`` and
``graph_shard``): in a process group (``parallel/launch.py``) the Trainer
is one rank of a ``Mesh`` of ``n_dp`` data-parallel rows by ``n_gp``
edge shards. Every rank builds the model from the same seed and takes rank 0's
parameters (``mesh.replicate``); the model's aggregations sum over the
rank's gp group (``edge_shard_axis``), and under ``graphnorm_whole_batch``
its strict GraphNorm over the dp group (``batch_shard_axis``), both kept
out of ``model_kwargs.yaml`` and the checkpoints, so a sharded run loads
on one device. The steps reduce over the mesh (``parallel/steps.py``)
with the dropout key folded with the dp rank. Rank 0 alone writes the
checkpoints, ``model_kwargs.yaml``, ``metrics.jsonl`` and the
predictions files; ``val`` gathers every rank's scored rows to it and
writes each global batch's rows in dataset order, as one device writes
them. The fused path (``fused_training``) runs per rank without graph
sharding; the device-resident dataset is off under graph sharding.
``allreduce_ms`` holds each step's gradient all-reduce time on a GPU.

``train_model`` takes any loader that yields ``(batch, meta)`` and has a
``len()``; the batch is the model's input kind (``input_kind``: a
``GraphBatch``, a ``SiamesePair`` or a ``DenseBatch``), whose ``y`` and
``graph_mask`` the losses and metrics read (a pair's are its receptor
side's), and ``meta`` names each slot's files. ``train_model`` and
``val`` set a ``GraphDataLoader``'s ``transfer_fn`` to ``_to_device``, as
the reference's engine does: each host ``GraphBatch`` is compressed,
packed into one buffer and copied to the device in the loader's producer
thread (``data/wire.py``), and the step decodes it.
"""
from __future__ import annotations

import math
import os
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from pointvs_tpu_torch.analysis.top_n import regression_pearson, top_n
from pointvs_tpu_torch.data.buckets import GraphBatch, SiamesePair, \
    to_device
from pointvs_tpu_torch.data.wire import carries_exactly, is_packed, \
    num_graphs, pack_batch
from pointvs_tpu_torch.models.layers import init_parameters
from pointvs_tpu_torch.models.params import load_reference_checkpoint
from pointvs_tpu_torch.models.registry import build_model, \
    model_input_kind
from pointvs_tpu_torch.data.device_dataset import rotation_key
from pointvs_tpu_torch.ops.prng import step_key
from pointvs_tpu_torch.parallel.mesh import Mesh, replicate
from pointvs_tpu_torch.parallel.steps import is_ids_batch, \
    make_eval_step, make_train_step
from pointvs_tpu_torch.tracing import span
from pointvs_tpu_torch.training.checkpoints import checkpoint_path, \
    save_checkpoint
from pointvs_tpu_torch.training.metrics_logger import MetricsLogger
from pointvs_tpu_torch.training.optimisers import build_optimiser, \
    make_lr_schedule
from pointvs_tpu_torch.utils import expand_path, format_time, get_logger, \
    mkdir, save_yaml

LOG = get_logger()

VALID_TASKS = ('classification', 'regression', 'multi_regression')
PROFILE_STEPS = (3, 8)   # first epoch's traced batches: [start, stop)


def _slots(batch) -> int:
    """Graph slots of a batch (an ids batch's from its spec, a packed
    one's from its template)."""
    if is_ids_batch(batch):
        return batch[3].num_graphs
    if is_packed(batch):
        return num_graphs(batch[2])
    return batch.graph_mask.shape[0]


def _timed_batches(loader):
    """The loader's items, each fetched inside ``pointvs.train.next_batch``
    (the first fetch runs the loader's ``__iter__`` set-up, the last finds
    the end)."""
    batches = iter(loader)
    while True:
        with span('pointvs.train.next_batch'):
            item = next(batches, None)
        if item is None:
            return
        yield item


def _on_device(batch) -> bool:
    """Whether a batch's arrays are tensors already."""
    if isinstance(batch, SiamesePair):
        batch = batch.rec
    return torch.is_tensor(batch[0])


def _merge_rows(parts):
    """One global batch from its dp rows' (items, logits, y_true, recs,
    ligs): (logits, y_true, meta), in the order of the dataset indices
    where every row knows them."""
    logits = np.concatenate([p[1] for p in parts])
    y_true = np.concatenate([p[2] for p in parts])
    recs = [name for p in parts for name in p[3]]
    ligs = [name for p in parts for name in p[4]]
    if len(parts) > 1 and all(p[0] is not None for p in parts):
        order = np.argsort(np.concatenate([np.asarray(p[0], np.int64)
                                           for p in parts]), kind='stable')
        logits, y_true = logits[order], y_true[order]
        recs, ligs = [recs[i] for i in order], [ligs[i] for i in order]
    return logits, y_true, SimpleNamespace(rec_fnames=recs, lig_fnames=ligs)


class _NullLogger:
    """The records of a rank other than 0: none."""

    def log(self, record):
        del record


class Trainer:
    """Owns a model and its optimiser on ``device``; trains and scores."""

    def __init__(self, model_name: str, save_path, device: torch.device,
                 learning_rate: float = 1e-3,
                 weight_decay: Optional[float] = None,
                 optimiser: str = 'adam', use_1cycle: bool = False,
                 warm_restarts: bool = False,
                 only_save_best_models: bool = False,
                 regression_loss: str = 'mse', log_interval: int = 10,
                 seed: int = 2, fused_training: bool = False,
                 wandb_project: Optional[str] = None,
                 wandb_run: Optional[str] = None, wandb_dir=None,
                 silent: bool = False, profile: bool = False,
                 num_devices: Optional[int] = None, double: bool = False,
                 device_cache: str = 'auto', mesh: Optional[Mesh] = None,
                 **model_kwargs):
        if use_1cycle and warm_restarts:
            raise ValueError('1cycle and warm restarts are mutually '
                             'exclusive')
        self.mesh = mesh if mesh is not None else Mesh()
        self.graph_shard = self.mesh.n_gp
        self.num_devices = self.mesh.world
        if num_devices not in (None, self.num_devices):
            raise ValueError(
                f'num_devices={num_devices} but this process group has '
                f'{self.num_devices} rank(s): the CLIs start one process '
                f'per rank (parallel/launch.py)')
        if self.graph_shard > 1 and fused_training:
            raise ValueError('fused_training runs whole edge passes per '
                             'rank; it does not take graph_shard > 1')
        silent = silent or not self.mesh.chief
        if double and device.type != 'cpu':
            raise ValueError('double=True (float64) runs on the CPU only, '
                             'as in the reference package')
        if device_cache not in ('auto', 'on', 'off'):
            raise ValueError(f'device_cache must be auto/on/off, got '
                             f'{device_cache!r}')
        self.device_cache = device_cache
        # id(dataset) -> (dataset, DeviceGraphStore); the dataset is held
        # so that its id cannot be reused while the entry lives.
        self._device_stores: dict = {}
        self.save_path = expand_path(save_path)
        self.device = device
        self.double = double
        self.silent = silent
        self.predictions_file = self.save_path / 'predictions.txt'
        self.lr = learning_rate
        self.weight_decay = weight_decay
        self.optimiser_name = optimiser
        self.use_1cycle = use_1cycle
        self.warm_restarts = warm_restarts
        self.only_save_best_models = only_save_best_models
        self.regression_loss = regression_loss
        self.log_interval = log_interval
        self.fused_training = fused_training
        self.profile = profile
        self.model_kwargs = dict(model_kwargs)
        self.model_name = model_name
        # The multitask model takes the task (its head) in every step.
        self.multitask = model_name == 'multitask'
        # 'graph', 'pair' or 'dense': the batches the model takes.
        self.input_kind = model_input_kind(model_name)
        build_kwargs = dict(model_kwargs)
        if self.mesh.edge_axis is not None:
            build_kwargs['edge_shard_axis'] = self.mesh.edge_axis
        if model_kwargs.get('graphnorm_whole_batch') \
                and self.mesh.batch_axis is not None:
            build_kwargs['batch_shard_axis'] = self.mesh.batch_axis
        self.model = build_model(model_name, **build_kwargs)
        init_parameters(self.model, torch.Generator().manual_seed(seed))
        if double:
            self.model.double()
        self.model.to(device).eval()
        replicate(self.mesh, self.model)
        self.optimiser = build_optimiser(self.model.parameters(), optimiser,
                                         weight_decay, learning_rate)
        self.seed = seed
        self.set_task(model_kwargs.get('model_task', 'classification'))
        self.p_epoch = 0
        self.a_epoch = 0
        self.global_iter = 0
        self.test_metric = 0.0
        self.decoy_mean_pred, self.active_mean_pred = 0.5, 0.5
        self.scheduler = None
        # Every training step's loss, in order (fetched at log intervals).
        self.train_losses: list = []
        self.epoch_seconds: list = []
        self._step_events: list = []
        self._allreduce_ms: list = []
        # Raw scores of the last val() call, in predictions-file row order
        # (probabilities for classification, outputs otherwise).
        self.val_scores = np.zeros((0,), np.float32)
        if not silent:
            mkdir(self.save_path)
            save_yaml(self.model_kwargs, self.save_path / 'model_kwargs.yaml')
        self.logger = (MetricsLogger(
            self.save_path, wandb_project=wandb_project, wandb_run=wandb_run,
            wandb_dir=wandb_dir, config={**self.model_kwargs,
                                         'model': model_name})
            if self.mesh.chief else _NullLogger())
        if not silent:
            LOG.info(f'Model parameters: {self.param_count}')
        self.logger.log({'Parameters': self.param_count})

    @property
    def param_count(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    def set_task(self, task: str):
        if task not in VALID_TASKS:
            raise ValueError('Argument for set_task must be one of '
                             'classification, regression or multi_regression')
        self.model_task = task
        self.model_task_for_fnames = ('affinity' if 'regression' in task
                                      else 'pose')

    @property
    def epoch(self) -> int:
        return self.a_epoch if 'regression' in self.model_task \
            else self.p_epoch

    def step_ms(self) -> list:
        """Each GPU training step's time by its CUDA events, in order."""
        if self._step_events:
            torch.cuda.synchronize(self.device)
        return [a.elapsed_time(b) for a, b in self._step_events]

    def allreduce_ms(self) -> list:
        """Each GPU training step's gradient all-reduce time by its CUDA
        events, in order (empty on one rank)."""
        return list(self._allreduce_ms)

    def _to_device(self, batch):
        """A host ``GraphBatch`` compressed, packed into one buffer and
        copied to the Trainer's device in one transfer
        (``wire.pack_batch``); a ``SiamesePair``, a ``DenseBatch``, an
        edge shard of ``--graph_shard`` and a ``GraphBatch`` that the wire
        form cannot carry exactly (``wire.carries_exactly``: no collator
        makes one) moved array by array (``to_device``); an ids batch, a
        packed batch and a batch already on a device as they are. The
        loaders run it in their producer thread (``transfer_fn``)."""
        if is_ids_batch(batch) or is_packed(batch) or _on_device(batch):
            return batch
        if isinstance(batch, GraphBatch) and self.graph_shard == 1 \
                and carries_exactly(batch):
            return pack_batch(batch, self.device)
        return to_device(batch, self.device)

    def _maybe_enable_device_dataset(self, loader) -> None:
        """Switch ``loader`` to the device-resident dataset where
        ``device_cache`` and the dataset allow it (the reference's rules,
        ``pointvs_tpu/training/engine.py``)."""
        from pointvs_tpu_torch.data import device_dataset as dd
        from pointvs_tpu_torch.data.loader import GraphDataLoader
        if (self.device_cache == 'off'
                or os.environ.get('POINTVS_DEVICE_DATASET', '1') == '0'):
            return
        demanded = self.device_cache == 'on'
        if not isinstance(loader, GraphDataLoader) or \
                loader.layout != 'graph' or loader.graph_shard > 1 \
                or self.graph_shard > 1:
            if demanded:
                raise ValueError('--device_cache on requires the graph '
                                 'layout without graph sharding')
            return
        if loader.device_store is not None:
            return
        reason = dd.store_eligibility(loader.dataset)
        if reason is not None:
            if demanded:
                raise ValueError(f'--device_cache on: {reason}')
            LOG.info(f'Device-resident dataset disabled: {reason}')
            return
        hit = self._device_stores.get(id(loader.dataset))
        if hit is None:
            store = self._build_device_store(loader.dataset, demanded)
            if store is None:
                return
            self._device_stores[id(loader.dataset)] = (loader.dataset,
                                                       store)
        else:
            store = hit[1]
        loader.enable_device_dataset(store)

    def _build_device_store(self, dataset, demanded: bool):
        """The dataset's ``DeviceGraphStore`` on the Trainer's device, or
        None where ``auto`` streams instead."""
        from pointvs_tpu_torch.data import device_dataset as dd
        budget = float(os.environ.get('POINTVS_DD_BUDGET_MB', '2048')) * 1e6
        # Estimate the upload from up to 32 items before the full pass
        # (the items are cached, so the build reuses the work), with the
        # rotation off so that the probe draws nothing from the dataset's
        # rotation stream.
        n = len(dataset)
        probe = [dd._norot_getitem(dataset, i)
                 for i in range(0, n, max(1, n // 32))[:32]]
        per_item = (sum(s.node_feats.nbytes // 4 + s.coords.nbytes
                        + 7 * s.num_edges for s in probe)
                    / max(1, len(probe)))
        estimate = per_item * n
        if estimate > budget and not demanded:
            LOG.info(f'Device-resident dataset disabled: estimated '
                     f'{estimate / 1e6:.0f} MB exceeds the '
                     f'{budget / 1e6:.0f} MB budget (POINTVS_DD_BUDGET_MB)')
            return None
        # The 'auto' preference, apart from the hard budget: above it the
        # reference measured streaming faster. --device_cache on forces
        # the store.
        auto_mb = float(os.environ.get('POINTVS_DD_AUTO_MB', '512'))
        if estimate > auto_mb * 1e6 and not demanded:
            LOG.info(f'Device-resident dataset not auto-enabled: estimated '
                     f'{estimate / 1e6:.0f} MB > {auto_mb:.0f} MB '
                     f'(POINTVS_DD_AUTO_MB); --device_cache on overrides')
            return None
        host = dd.build_host_store(dataset)
        if host.nbytes > budget and not demanded:
            LOG.info(f'Device-resident dataset disabled: '
                     f'{host.nbytes / 1e6:.0f} MB exceeds the budget')
            return None
        return dd.DeviceGraphStore(host, self.device)

    # ------------------------------------------------------------------ #
    def training_setup(self, data_loader, epochs: int,
                       model_task: Optional[str] = None):
        if model_task is not None:
            self.set_task(model_task)
        self.scheduler = make_lr_schedule(
            self.lr, steps_per_epoch=len(data_loader), epochs=epochs,
            use_1cycle=self.use_1cycle, warm_restarts=self.warm_restarts)
        return self.epoch, time.time()

    def _log_step(self, epoch_idx, batch_idx, steps_per_epoch, epochs,
                  loss_val, lr_now, slots, eta):
        """The reference's per-interval records and log line."""
        task = self.model_task_for_fnames
        if self.model_task == 'classification':
            self.logger.log({
                'Mean active prediction (train)': self.active_mean_pred,
                'Mean inactive prediction (train)': self.decoy_mean_pred})
        self.logger.log({
            f'Loss (train, {task})': loss_val,
            f'Learning rate (train, {task})': lr_now,
            f'Batch (train, {task})':
                epoch_idx * steps_per_epoch + batch_idx + 1,
            f'Examples seen (train, {task})': self.global_iter * slots,
            f'Time remaining (train, {task})': format_time(eta)})
        if not self.silent:
            LOG.info(f'Epoch {epoch_idx + 1}/{epochs} batch '
                     f'{batch_idx + 1}/{steps_per_epoch} loss '
                     f'{loss_val:.4f} lr {lr_now:.2e} mean active/decoy '
                     f'prediction {self.active_mean_pred:.3f}/'
                     f'{self.decoy_mean_pred:.3f} eta {format_time(eta)}')

    def _profiler(self, epoch_idx, init_epoch, batch_idx, prof):
        """Start or stop the trace of the first epoch's window; returns
        the running profiler or None."""
        if not self.profile or epoch_idx != init_epoch \
                or not self.mesh.chief:
            return prof
        if batch_idx == PROFILE_STEPS[0] and prof is None:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.__enter__()
        elif batch_idx == PROFILE_STEPS[1] and prof is not None:
            prof = self._stop_profiler(prof)
        return prof

    def _stop_profiler(self, prof):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = mkdir(self.save_path / 'profile') / (
            f'trace_{self.model_task_for_fnames}_epoch_{self.epoch + 1}'
            f'.json')
        prof.export_chrome_trace(str(out))
        LOG.info(f'Wrote a profile of steps {PROFILE_STEPS[0]}-'
                 f'{PROFILE_STEPS[1] - 1} to {out}')
        return None

    def train_model(self, data_loader, epochs: int = 1,
                    epoch_end_validation_set=None,
                    top1_on_end: bool = False):
        """Epoch/batch loop (ref ``train_model``)."""
        with span('pointvs.train.epoch_setup'):
            init_epoch, start = self.training_setup(data_loader, epochs)
            self._maybe_enable_device_dataset(data_loader)
            if hasattr(data_loader, 'transfer_fn'):
                data_loader.transfer_fn = self._to_device
            step_fn = make_train_step(
                self.model, self.optimiser, self.model_task,
                self.regression_loss, with_metrics=True,
                use_fused=self.fused_training, multitask=self.multitask,
                mesh=self.mesh)
        timed = self.device.type == 'cuda'
        steps_per_epoch = len(data_loader)
        total_steps = max(1, (epochs - init_epoch) * steps_per_epoch)
        sched_step = init_epoch * steps_per_epoch
        done_steps = 0
        prof = None
        for epoch_idx in range(init_epoch, epochs):
            epoch_start = time.time()
            losses, pending = [], []
            for batch_idx, (batch, _) in enumerate(
                    _timed_batches(data_loader)):
                prof = self._profiler(epoch_idx, init_epoch, batch_idx, prof)
                lr_now = self.scheduler(sched_step)
                dropout_rng = step_key(self.seed, self.global_iter,
                                       self.mesh.dp_rank)
                rot_key = (rotation_key(self.seed, self.global_iter)
                           if is_ids_batch(batch) and batch[3].rotate
                           else None)
                batch = self._to_device(batch)
                if timed:
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record()
                with span('pointvs.train.step'):
                    stats = step_fn(batch, lr_now, dropout_rng, rot_key)
                if timed:
                    events[1].record()
                    self._step_events.append(events)
                sched_step += 1
                self.global_iter += 1
                done_steps += 1
                # The stats stay on the device until the log interval, so
                # a step never waits for the previous one to finish; the
                # NaN guard fires within log_interval steps.
                pending.append((batch_idx, stats))
                last = batch_idx == steps_per_epoch - 1
                if batch_idx % self.log_interval and not last:
                    continue
                with span('pointvs.train.fetch_stats'):
                    self._fetch_stats(pending, losses, epoch_idx)
                    if not batch_idx % self.log_interval:
                        eta = ((time.time() - start) / done_steps
                               * (total_steps - done_steps))
                        self._log_step(epoch_idx, batch_idx,
                                       steps_per_epoch, epochs, losses[-1],
                                       lr_now, _slots(batch), eta)
            with span('pointvs.train.epoch_end'):
                if prof is not None:   # an epoch shorter than the window
                    prof = self._stop_profiler(prof)
                self.epoch_seconds.append(time.time() - epoch_start)
                if not self.silent:
                    mean = np.mean(losses) if losses else float('nan')
                    LOG.info(f'Epoch {epoch_idx + 1} done in '
                             f'{self.epoch_seconds[-1]:.1f}s, mean loss '
                             f'{mean:.4f}')
                dataset = getattr(data_loader, 'dataset', None)
                if getattr(dataset, 'aug_rejects', 0):
                    self.logger.log({
                        'Augmented rotation redraws (cumulative)':
                            dataset.aug_rejects,
                        'Augmented rotation fallbacks (cumulative)':
                            dataset.aug_fallbacks})
                self.on_epoch_end(epoch_end_validation_set, epochs,
                                  top1_on_end)
        self._allreduce_ms += step_fn.allreduce_ms()

    def _fetch_stats(self, pending: list, losses: list, epoch_idx: int):
        """Copy the pending steps' stats to the host (the loop's one wait
        for the device), record their losses and the mean predictions, and
        stop at a NaN loss."""
        for p_idx, p_stats in pending:
            vec = p_stats.float().cpu().numpy().reshape(-1)
            loss_val = float(vec[0])
            losses.append(loss_val)
            self.train_losses.append(loss_val)
            if math.isnan(loss_val):
                LOG.error('We have hit a NaN loss value.')
                raise FloatingPointError(
                    f'NaN loss at epoch {epoch_idx} batch {p_idx}')
            if vec[2] > 0:
                self.active_mean_pred = float(vec[1] / vec[2])
            if vec[4] > 0:
                self.decoy_mean_pred = float(vec[3] / vec[4])
        pending.clear()

    def on_epoch_end(self, epoch_end_validation_set, epochs: int,
                     top1_on_end: bool):
        """Per-epoch checkpoint and optional validation (ref
        ``on_epoch_end``)."""
        if 'regression' in self.model_task:
            self.a_epoch += 1
        else:
            self.p_epoch += 1
        epoch = self.epoch
        if not self.only_save_best_models:
            self.save()
        if epoch_end_validation_set is not None and epoch < epochs:
            fname = Path(self.predictions_file.parent,
                         f'predictions_epoch_{epoch}.txt')
            best = self.val(epoch_end_validation_set, predictions_file=fname,
                            top1_on_end=top1_on_end)
            if self.only_save_best_models and best:
                self.save()

    def save(self, save_path=None) -> Path:
        """Write ``<save_path>/checkpoints/<task>_ckpt_epoch_<n>.pt`` (rank
        0 alone; every rank holds the same state)."""
        path = (checkpoint_path(self.save_path, self.model_task_for_fnames,
                                self.epoch)
                if save_path is None else expand_path(save_path))
        if self.mesh.chief:
            save_checkpoint(path, self.model, self.optimiser, self.p_epoch,
                            self.a_epoch, self.lr, self.weight_decay)
            LOG.info(f'Saved checkpoint to {path}')
        return path

    def load_weights(self, checkpoint_file):
        """Load a reference-schema ``.pt`` checkpoint (strict: missing or
        unexpected keys raise) and its epoch counters, with the optimiser
        state where the file holds one (the counterpart of the reference
        restoring its orbax state)."""
        meta = self._load_state(checkpoint_file)
        if 'optimiser_state_dict' in meta:
            self.optimiser.load_state_dict(meta['optimiser_state_dict'])
        LOG.info(f'Loaded weights from {checkpoint_file}')

    def import_torch_weights(self, checkpoint_file):
        """Weights and epoch counters of a reference-schema ``.pt``
        checkpoint, with a fresh optimiser (ref ``import_torch_weights``)."""
        self._load_state(checkpoint_file)
        self.optimiser = build_optimiser(self.model.parameters(),
                                         self.optimiser_name,
                                         self.weight_decay, self.lr)
        LOG.info(f'Imported weights from {checkpoint_file}')

    def _load_state(self, checkpoint_file) -> dict:
        state_dict, meta = load_reference_checkpoint(
            expand_path(checkpoint_file))
        self.model.load_state_dict(state_dict, strict=True)
        self.p_epoch = int(meta['p_epoch'])
        self.a_epoch = int(meta['a_epoch'])
        return meta

    # ------------------------------------------------------------------ #
    def val(self, data_loader, predictions_file=None,
            top1_on_end: bool = False, use_fused: bool = False) -> bool:
        """Score every batch and write ``<task>_<name>`` beside
        ``predictions_file``; with ``top1_on_end``, log its top-1 (or
        Pearson r) score. Returns False only when that tracked metric
        failed to improve and only the best models are saved.

        On a mesh every rank scores its rows; one gather brings each dp
        row's scored rows to every rank, and each global batch's rows are
        written (by rank 0) in the order of their dataset indices
        (``BatchMeta.items``): one device's order."""
        predictions_file = Path(predictions_file or self.predictions_file)
        predictions_file = predictions_file.parent / (
            f'{self.model_task_for_fnames}_{predictions_file.name}')
        if self.mesh.chief:
            mkdir(predictions_file.parent)
        self._maybe_enable_device_dataset(data_loader)
        if hasattr(data_loader, 'transfer_fn'):
            data_loader.transfer_fn = self._to_device
        eval_fn = make_eval_step(self.model, self.model_task, use_fused,
                                 multitask=self.multitask)
        local = []
        for batch, meta in data_loader:
            logits = eval_fn(self._to_device(batch))
            logits = logits.float().cpu().numpy()
            real = meta.graph_mask.reshape(-1) > 0
            local.append((meta.items, logits[real],
                          meta.y.reshape(len(real), -1)[real],
                          list(meta.rec_fnames), list(meta.lig_fnames)))
        per_row = [local]
        if self.mesh.distributed:
            per_row = [None] * self.mesh.world
            dist.all_gather_object(per_row, local)
            per_row = per_row[::self.mesh.n_gp]   # one rank per dp row
        rows, scores = [], []
        for parts in zip(*per_row):
            logits, y_true, meta = _merge_rows(parts)
            text, batch_scores = self._format_predictions(logits, y_true,
                                                          meta)
            rows.append(text)
            scores.append(batch_scores)
            self._update_mean_preds(logits, y_true)
        self.val_scores = (np.concatenate(scores) if scores
                           else np.zeros((0,), np.float32))
        if not self.mesh.chief:
            return True
        predictions_file.write_text(''.join(rows), encoding='utf-8')
        if top1_on_end:
            return self._score_and_track(predictions_file)
        return True

    def _format_predictions(self, logits: np.ndarray, y_true: np.ndarray,
                            meta):
        """(prediction rows, raw scores) as the reference writes them."""
        recs, ligs = meta.rec_fnames, meta.lig_fnames
        lines = []
        if self.model_task == 'classification':
            scores = 1 / (1 + np.exp(-logits[:, 0]))
            for i, pred in enumerate(scores):
                truth = y_true[i, 0]
                if truth >= 0:
                    lines.append(f'{int(truth):.3f} | {pred:.3f} '
                                 f'{recs[i]} {ligs[i]}')
                else:
                    lines.append(f'{pred:.3f} | {recs[i]} {ligs[i]}')
        elif self.model_task == 'multi_regression':
            scores = logits
            names = ('pki', 'pkd', 'ic50')
            for i in range(logits.shape[0]):
                labelled = np.where(y_true[i] > -0.5)[0]
                for j in labelled:
                    lines.append(f'{y_true[i, j]:.3f} | {logits[i, j]:.3f} '
                                 f'{recs[i]} {ligs[i]} | {names[j]}')
                if not len(labelled):
                    lines.append(f'{logits[i, 0]:.3f} {logits[i, 1]:.3f} '
                                 f'{logits[i, 2]:.3f} | {recs[i]} {ligs[i]}')
        else:
            scores = logits[:, 0]
            for i in range(logits.shape[0]):
                lines.append(f'{y_true[i, 0]:.3f} | {logits[i, 0]:.3f} '
                             f'{recs[i]} {ligs[i]}')
        return '\n'.join(lines) + ('\n' if lines else ''), scores

    def _update_mean_preds(self, logits: np.ndarray, y_true: np.ndarray):
        """Mean active/decoy validation predictions (ref
        ``_update_mean_preds``)."""
        if self.model_task != 'classification':
            return
        preds = 1 / (1 + np.exp(-logits[:, 0]))
        labels = y_true[:, 0]
        if (labels > 0.5).any():
            self.active_mean_pred = float(np.mean(preds[labels > 0.5]))
        if (labels < 0.5).any():
            self.decoy_mean_pred = float(np.mean(preds[labels < 0.5]))
        self.logger.log({
            'Mean active prediction (val)': self.active_mean_pred,
            'Mean inactive prediction (val)': self.decoy_mean_pred})

    def _score_and_track(self, predictions_file) -> bool:
        """Log the file's top-1 (classification) or Pearson r (regression)
        and track the best (ref ``_score_and_track``)."""
        if self.model_task == 'classification':
            metric = top_n(predictions_file)
            best = metric > self.test_metric
            if best:
                self.test_metric = metric
            LOG.info(f'Validation Top1: {metric:.3f}')
            self.logger.log({'Validation Top1': metric,
                             'Best validation Top1': self.test_metric,
                             'Epoch (pose)': self.p_epoch})
        else:
            metric, p_value = regression_pearson(predictions_file)
            best = p_value < 0.05 and metric > self.test_metric
            if best:
                self.test_metric = metric
            LOG.info(f"Pearson's correlation coefficient: {metric:.3f}")
            self.logger.log({"Pearson's correlation coefficient": metric,
                             'Best PCC': self.test_metric,
                             'Epoch (affinity)': self.a_epoch})
        return best or not self.only_save_best_models
