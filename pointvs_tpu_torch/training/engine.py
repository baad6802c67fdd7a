"""Trainer: the scoring half of the reference engine.

Counterpart of ``pointvs_tpu/training/engine.py`` with what serving needs:
``set_task``, ``load_weights``, ``val`` and the predictions-file format
(``<label> | <prob> <rec> <lig>``, three decimals). Training (losses,
optimisers, checkpoints) comes with the training slice (ROADMAP.md).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from pointvs_tpu_torch.analysis.top_n import regression_pearson, top_n
from pointvs_tpu_torch.data.buckets import to_device
from pointvs_tpu_torch.models.params import load_reference_checkpoint
from pointvs_tpu_torch.models.registry import build_model
from pointvs_tpu_torch.utils import expand_path, get_logger, mkdir

LOG = get_logger()

VALID_TASKS = ('classification', 'regression', 'multi_regression')


class Trainer:
    """Owns a model on ``device`` and scores loaders with it."""

    def __init__(self, model_name: str, save_path, device: torch.device,
                 **model_kwargs):
        self.save_path = expand_path(save_path)
        self.device = device
        self.model = build_model(model_name, **model_kwargs).to(device)
        self.model.eval()
        self.set_task(model_kwargs.get('model_task', 'classification'))
        self.p_epoch = 0
        self.a_epoch = 0
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

    def load_weights(self, checkpoint_file):
        """Load a reference-schema ``.pt`` checkpoint (strict: missing or
        unexpected keys raise)."""
        state_dict, meta = load_reference_checkpoint(
            expand_path(checkpoint_file))
        self.model.load_state_dict(state_dict, strict=True)
        self.p_epoch = meta['p_epoch']
        self.a_epoch = meta['a_epoch']
        LOG.info(f'Loaded weights from {checkpoint_file}')

    @torch.no_grad()
    def val(self, data_loader, predictions_file=None,
            top1_on_end: bool = False) -> None:
        """Score every batch and write ``<task>_<name>`` beside
        ``predictions_file``; with ``top1_on_end``, log its top-1 (or
        Pearson r) score."""
        predictions_file = Path(predictions_file or
                                self.save_path / 'predictions.txt')
        predictions_file = predictions_file.parent / (
            f'{self.model_task_for_fnames}_{predictions_file.name}')
        mkdir(predictions_file.parent)
        rows, scores = [], []
        for batch, meta in data_loader:
            logits = self.model(to_device(batch, self.device))
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
            self._score_and_track(predictions_file)

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

    def _score_and_track(self, predictions_file) -> float:
        """Log and return the file's top-1 (classification) or Pearson r
        (regression)."""
        if self.model_task == 'classification':
            metric = top_n(predictions_file)
            LOG.info(f'Validation Top1: {metric:.3f}')
        else:
            metric, _ = regression_pearson(predictions_file)
            LOG.info(f"Pearson's correlation coefficient: {metric:.3f}")
        return metric
