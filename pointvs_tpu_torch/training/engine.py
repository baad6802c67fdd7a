"""Trainer: training, checkpoints and scoring on one device.

Counterpart of ``pointvs_tpu/training/engine.py``: ``set_task``,
``training_setup``, ``train_model`` (epoch/batch loop, the learning rate
from the schedule each step, a NaN guard, mean active/decoy training
predictions), ``on_epoch_end``, ``save``, ``load_weights``, ``val`` and the
predictions-file format (``<label> | <prob> <rec> <lig>``, three decimals).
Checkpoints are ``.pt`` files in the reference layout
(``training/checkpoints.py``).

``train_model`` takes any loader that yields ``(batch, meta)`` and has a
``len()``; the port's own loader still scores only (its training
augmentation and sampling are not ported yet, ROADMAP.md Queue 1).
"""
from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from pointvs_tpu_torch.analysis.top_n import regression_pearson, top_n
from pointvs_tpu_torch.data.buckets import to_device
from pointvs_tpu_torch.models.layers import init_parameters
from pointvs_tpu_torch.models.params import load_reference_checkpoint
from pointvs_tpu_torch.models.registry import build_model
from pointvs_tpu_torch.parallel.steps import make_eval_step, \
    make_train_step
from pointvs_tpu_torch.training.checkpoints import checkpoint_path, \
    save_checkpoint
from pointvs_tpu_torch.training.optimisers import build_optimiser, \
    make_lr_schedule
from pointvs_tpu_torch.utils import expand_path, get_logger, mkdir

LOG = get_logger()

VALID_TASKS = ('classification', 'regression', 'multi_regression')


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
                 **model_kwargs):
        if use_1cycle and warm_restarts:
            raise ValueError('1cycle and warm restarts are mutually '
                             'exclusive')
        self.save_path = expand_path(save_path)
        self.device = device
        self.predictions_file = self.save_path / 'predictions.txt'
        self.lr = learning_rate
        self.weight_decay = weight_decay
        self.use_1cycle = use_1cycle
        self.warm_restarts = warm_restarts
        self.only_save_best_models = only_save_best_models
        self.regression_loss = regression_loss
        self.log_interval = log_interval
        self.fused_training = fused_training
        self.model = build_model(model_name, **model_kwargs)
        init_parameters(self.model, torch.Generator().manual_seed(seed))
        self.model.to(device).eval()
        self.optimiser = build_optimiser(self.model.parameters(), optimiser,
                                         weight_decay, learning_rate)
        self.set_task(model_kwargs.get('model_task', 'classification'))
        self.p_epoch = 0
        self.a_epoch = 0
        self.global_iter = 0
        self.test_metric = 0.0
        self.decoy_mean_pred, self.active_mean_pred = 0.5, 0.5
        self.scheduler = None
        # Every training step's loss, in order (fetched at log intervals).
        self.train_losses: list = []
        # Raw scores of the last val() call, in predictions-file row order
        # (probabilities for classification, outputs otherwise).
        self.val_scores = np.zeros((0,), np.float32)

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

    # ------------------------------------------------------------------ #
    def training_setup(self, data_loader, epochs: int,
                       model_task: Optional[str] = None):
        if model_task is not None:
            self.set_task(model_task)
        self.scheduler = make_lr_schedule(
            self.lr, steps_per_epoch=len(data_loader), epochs=epochs,
            use_1cycle=self.use_1cycle, warm_restarts=self.warm_restarts)
        return self.epoch, time.time()

    def train_model(self, data_loader, epochs: int = 1,
                    epoch_end_validation_set=None,
                    top1_on_end: bool = False):
        """Epoch/batch loop (ref ``train_model``)."""
        init_epoch, start = self.training_setup(data_loader, epochs)
        step_fn = make_train_step(self.model, self.optimiser,
                                  self.model_task, self.regression_loss,
                                  with_metrics=True,
                                  use_fused=self.fused_training)
        steps_per_epoch = len(data_loader)
        total_steps = max(1, (epochs - init_epoch) * steps_per_epoch)
        sched_step = init_epoch * steps_per_epoch
        done_steps = 0
        for epoch_idx in range(init_epoch, epochs):
            epoch_start = time.time()
            losses, pending = [], []
            for batch_idx, (batch, _) in enumerate(data_loader):
                lr_now = self.scheduler(sched_step)
                stats = step_fn(to_device(batch, self.device), lr_now)
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
                if not batch_idx % self.log_interval:
                    eta = ((time.time() - start) / done_steps
                           * (total_steps - done_steps))
                    LOG.info(f'Epoch {epoch_idx + 1}/{epochs} batch '
                             f'{batch_idx + 1}/{steps_per_epoch} loss '
                             f'{losses[-1]:.4f} lr {lr_now:.2e} mean '
                             f'active/decoy prediction '
                             f'{self.active_mean_pred:.3f}/'
                             f'{self.decoy_mean_pred:.3f} eta {eta:.1f} s')
            LOG.info(f'Epoch {epoch_idx + 1} done in '
                     f'{time.time() - epoch_start:.1f}s, mean loss '
                     f'{np.mean(losses) if losses else float("nan"):.4f}')
            self.on_epoch_end(epoch_end_validation_set, epochs, top1_on_end)

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
        """Write ``<save_path>/checkpoints/<task>_ckpt_epoch_<n>.pt``."""
        path = (checkpoint_path(self.save_path, self.model_task_for_fnames,
                                self.epoch)
                if save_path is None else expand_path(save_path))
        save_checkpoint(path, self.model, self.optimiser, self.p_epoch,
                        self.a_epoch, self.lr, self.weight_decay)
        LOG.info(f'Saved checkpoint to {path}')
        return path

    def load_weights(self, checkpoint_file):
        """Load a reference-schema ``.pt`` checkpoint (strict: missing or
        unexpected keys raise), with the optimiser state where the file
        holds the port's own."""
        state_dict, meta = load_reference_checkpoint(
            expand_path(checkpoint_file))
        self.model.load_state_dict(state_dict, strict=True)
        if 'optimiser_state_dict' in meta:
            self.optimiser.load_state_dict(meta['optimiser_state_dict'])
        self.p_epoch = meta['p_epoch']
        self.a_epoch = meta['a_epoch']
        LOG.info(f'Loaded weights from {checkpoint_file}')

    # ------------------------------------------------------------------ #
    def val(self, data_loader, predictions_file=None,
            top1_on_end: bool = False, use_fused: bool = False) -> bool:
        """Score every batch and write ``<task>_<name>`` beside
        ``predictions_file``; with ``top1_on_end``, log its top-1 (or
        Pearson r) score. Returns False only when that tracked metric
        failed to improve and only the best models are saved."""
        predictions_file = Path(predictions_file or self.predictions_file)
        predictions_file = predictions_file.parent / (
            f'{self.model_task_for_fnames}_{predictions_file.name}')
        mkdir(predictions_file.parent)
        eval_fn = make_eval_step(self.model, self.model_task, use_fused)
        rows, scores = [], []
        for batch, meta in data_loader:
            logits = eval_fn(to_device(batch, self.device))
            logits = logits.float().cpu().numpy()
            real = meta.graph_mask.reshape(-1) > 0
            y_true = meta.y.reshape(len(real), -1)[real]
            text, batch_scores = self._format_predictions(
                logits[real], y_true, meta)
            rows.append(text)
            scores.append(batch_scores)
        predictions_file.write_text(''.join(rows), encoding='utf-8')
        self.val_scores = (np.concatenate(scores) if scores
                           else np.zeros((0,), np.float32))
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

    def _score_and_track(self, predictions_file) -> bool:
        """Log the file's top-1 (classification) or Pearson r (regression)
        and track the best (ref ``_score_and_track``)."""
        if self.model_task == 'classification':
            metric = top_n(predictions_file)
            best = metric > self.test_metric
            LOG.info(f'Validation Top1: {metric:.3f}')
        else:
            metric, p_value = regression_pearson(predictions_file)
            best = p_value < 0.05 and metric > self.test_metric
            LOG.info(f"Pearson's correlation coefficient: {metric:.3f}")
        if best:
            self.test_metric = metric
        return best or not self.only_save_best_models
