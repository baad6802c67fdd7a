"""Train and eval steps, on one device or one rank of a mesh.

Counterpart of ``pointvs_tpu/parallel/steps.py`` (``make_train_step``,
``make_eval_step``) and of the steps of ``parallel/graph_shard.py``. On
one device the loss is ``loss_sum / max(weight, 1)``, so the gradient
equals the reference's psum'd gradient divided by the global weight; the
optimiser then clips by value, adds the coupled weight decay and steps at
the learning rate the caller passes in (computed on the host from a
schedule, as the reference passes it into its step).

On a rank of a distributed ``Mesh`` (``parallel/mesh.py``) the training
step is the reference's SPMD step from one rank's view: the gradient of
the rank's local ``loss_sum``, then one all-reduce (SUM over every rank)
of the flattened gradients with ``loss_sum``, ``weight`` and the four
metric sums, each scaled by ``1 / n_gp`` first. Over a gp row that is the
reference's ``pmean`` (an edge-path gradient is n_gp times its partial,
a node-path gradient is already the full one; both average to the full
graph's gradient), over the dp rows its ``psum``. The gradients are then
divided by ``max(weight, 1)`` and the optimiser steps, on every rank
alike. The caller folds the rank's index into the dropout key (the
reference's ``fold_in(key, axis_index)``); the model's own groups
(``edge_shard_axis``, ``batch_shard_axis``) reduce inside the forward.
On a GPU the all-reduce is timed by CUDA events (``step.allreduce_ms``).
Under a profiler the training step's parts are spans (``tracing.py``):
``pointvs.step.collate`` (also in the eval step), ``forward`` (with the
loss), ``backward`` (with ``allreduce`` on a mesh) and ``optimiser``.

Both steps take any of the model inputs (``GraphBatch``, ``SiamesePair``,
``DenseBatch``); the loss and metrics read ``batch.y`` and
``batch.graph_mask``. The fused path is the EGNN families' only. A
float64 model (``--double``) takes its batch in float64: both steps cast
the batch's floating tensors at the model's entry (f32 -> f64 is exact;
the reference promotes the f32 batch op by op). Its learning rate is
rounded to float32 first, as the reference's Trainer passes it to its
step (``jnp.float32(lr)``) in every mode.

Both steps also take the device-resident dataset's batch, ``('ids',
ids[1, B], store, spec)`` (``data/loader.py``): the step collates it on
the store's device (``device_dataset.collate_from_ids``) and, in a
training step whose ``spec.rotate`` is set, rotates each graph under
``rot_key`` (the reference's ``fold_in(step rng, 0x526f7461)``), then
runs the same module or fused core. Evaluation never rotates.

They also take the reference's packed batch, ``('packed', buf, template,
symmetric)`` (``data/wire.py``): one uint8 buffer on the device (a
``wire.Staged`` whose copy the step waits for), the host template of
its fields and the host's verdict that the edge list is symmetric (a
Python bool). The step decodes it into a ``GraphBatch`` as its first
operation (``wire.decode``); the rest is the raw batch's step, so a packed
batch and its raw ``GraphBatch`` give the same outputs bit for bit. The
edge-shard steps of ``--graph_shard`` take raw batches, as the
reference's do. ``make_scan_eval_step`` scores a group of packed batches
of one template, ``[G, nbytes]``, in one call, as the reference's
``lax.scan`` program does: here a loop over the group's rows.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from pointvs_tpu_torch.data.buckets import cast_floats
from pointvs_tpu_torch.data.wire import decode, is_packed, ready
from pointvs_tpu_torch.fused_train import fused_apply
from pointvs_tpu_torch.inference_engine import fused_forward, \
    supports_fusion
from pointvs_tpu_torch.tracing import span
from pointvs_tpu_torch.training.losses import loss_fn
from pointvs_tpu_torch.training.optimisers import clip_and_step


def pred_metrics(logits, batch, model_task: str) -> torch.Tensor:
    """[active_pred_sum, active_count, decoy_pred_sum, decoy_count] of the
    batch's real graphs (ref ``_pred_metrics``)."""
    mask = batch.graph_mask.reshape(-1)
    if model_task == 'classification':
        preds = torch.sigmoid(logits.reshape(-1))
        y = batch.y.reshape(-1)
        act = (y > 0.5).to(preds.dtype) * mask
        dec = (y < 0.5).to(preds.dtype) * mask
    else:
        # The reference logs the sigmoid'd mean prediction over labelled
        # rows for regression tasks too.
        preds = torch.sigmoid(logits.reshape(mask.shape[0], -1)).mean(-1)
        act = mask
        dec = torch.zeros_like(mask)
    return torch.stack([(preds * act).sum(), act.sum(), (preds * dec).sum(),
                        dec.sum()])


def is_ids_batch(batch) -> bool:
    """Whether ``batch`` is a device-resident dataset's ids batch."""
    return type(batch) is tuple and batch[0] == 'ids'


def graph_batch(batch, rot_key=None, rotate: bool = True):
    """The model input of ``batch``: a packed batch decoded on its
    buffer's device; an ids batch collated on its store's device (the
    store a ``DeviceGraphStore`` or an expanded chunk's arrays; with
    ``rotate``, rotated under ``rot_key`` when its spec says so); any
    other batch as it is. The decode and the collation run inside
    ``pointvs.step.collate``."""
    if is_packed(batch):
        _, buf, template, symmetric = batch
        with span('pointvs.step.collate'):
            return decode(buf, template, bool(symmetric))
    if not is_ids_batch(batch):
        return batch
    from pointvs_tpu_torch.data.device_dataset import (collate_from_ids,
                                                       rotate_per_graph)
    _, ids, store, spec = batch
    ids = ids[0]
    with span('pointvs.step.collate'):
        out = collate_from_ids(getattr(store, 'arrays', store), ids, spec)
        if rotate and spec.rotate:
            if rot_key is None:
                raise ValueError('a rotating ids batch needs the step\'s '
                                 'rot_key')
            out = rotate_per_graph(out, rot_key, ids, spec.num_graphs)
    return out


def _is_double(model) -> bool:
    return next(model.parameters()).dtype == torch.float64


def _model_input(model) -> Callable:
    """The cast of a batch to what the model takes: float64 for a float64
    model, unchanged otherwise."""
    if _is_double(model):
        return lambda batch: cast_floats(batch, torch.float64)
    return lambda batch: batch


def _reduce_over_mesh(mesh, params, stats: torch.Tensor) -> torch.Tensor:
    """One all-reduce (SUM over every rank) of the parameters' gradients
    and ``stats``, each scaled by 1 / n_gp (gp mean, dp sum); the
    gradients are written back in place. Returns the reduced ``stats``."""
    scale = 1.0 / mesh.n_gp
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [stats])
    if scale != 1.0:
        flat = flat * scale
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n
    return flat[offset:]


def make_train_step(model, optimiser: torch.optim.Optimizer,
                    model_task: str, regression_loss: str = 'mse',
                    with_metrics: bool = False,
                    use_fused: bool = False,
                    multitask: bool = False, mesh=None) -> Callable:
    """Returns ``step(batch, lr, dropout_rng=None, rot_key=None)``: one
    optimiser step on a batch of tensors on the model's device (or a
    packed batch, decoded there, or an ids batch, collated there and
    rotated under ``rot_key``), with the model's
    dropout drawn under ``dropout_rng`` (the step's raw JAX key,
    uint32[2]: what the reference's step passes as ``rngs={'dropout':
    ...}``, after its fold of the device index). It returns the loss (a
    0-d tensor, left on the device) or, with ``with_metrics``, the
    5-vector ``[loss, act_sum, act_cnt, dec_sum, dec_cnt]``.

    ``use_fused`` runs the forward through ``fused_train.fused_apply``
    (kernels K3 forward, K4 backward), which computes the same function as
    the module forward for the configurations it supports. A
    ``multitask`` model is given ``task=model_task``, which picks its head.
    With a distributed ``mesh`` the step reduces over its ranks (see the
    module's docstring) and returns the global loss on every rank.
    """
    apply_kwargs = {'task': model_task} if multitask else {}
    model_input = _model_input(model)
    to_f32 = _is_double(model)
    distributed = mesh is not None and mesh.distributed
    params = [p for group in optimiser.param_groups for p in group['params']]
    allreduce_events = []

    def forward(batch, dropout_rng):
        if use_fused:   # fused configurations have no dropout
            return fused_apply(model, batch, **apply_kwargs)
        return model(batch, train=True, dropout_rng=dropout_rng,
                     **apply_kwargs)

    def backward_over_mesh(loss_sum, weight, metrics):
        """The rank's gradients, then one all-reduce of them with the
        stats (``pointvs.step.allreduce``); the global (loss, metrics)."""
        loss_sum.backward()
        for p in params:   # the reference's zero gradients
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        stats = torch.stack([loss_sum.detach(), weight.detach()])
        if metrics is not None:
            stats = torch.cat([stats, metrics])
        timed = stats.device.type == 'cuda'
        with span('pointvs.step.allreduce'):
            if timed:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
            stats = _reduce_over_mesh(mesh, params, stats.to(
                params[0].grad.dtype))
            if timed:
                events[1].record()
                allreduce_events.append(events)
        weight = torch.clamp_min(stats[1], 1.0)
        for p in params:
            p.grad.div_(weight)
        return (stats[0] / weight,
                stats[2:] if metrics is not None else None)

    def step(batch, lr: float, dropout_rng=None,
             rot_key=None) -> torch.Tensor:
        model.train()
        batch = model_input(graph_batch(batch, rot_key))
        with span('pointvs.step.forward'):
            logits = forward(batch, dropout_rng)
            loss_sum, weight = loss_fn(logits, batch, model_task,
                                       regression_loss)
            optimiser.zero_grad(set_to_none=True)
            metrics = (pred_metrics(logits.detach(), batch, model_task)
                       if with_metrics else None)
        with span('pointvs.step.backward'):
            if distributed:
                loss, metrics = backward_over_mesh(loss_sum, weight, metrics)
            else:
                loss = loss_sum / torch.clamp_min(weight, 1.0)
                loss.backward()
        with span('pointvs.step.optimiser'):
            if to_f32:
                lr = float(torch.tensor(lr, dtype=torch.float32))
            clip_and_step(optimiser, lr)
        out = loss.detach()
        if metrics is not None:
            out = torch.cat([out[None], metrics.to(out.dtype)])
        return out

    def allreduce_ms() -> list:
        """Each GPU step's all-reduce time by its CUDA events, in order."""
        if allreduce_events:
            torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in allreduce_events]

    step.allreduce_ms = allreduce_ms
    return step


def make_eval_step(model, model_task: Optional[str] = None,
                   use_fused: bool = False,
                   multitask: bool = False) -> Callable:
    """Returns ``step(batch) -> logits``; it never drops edges, a packed
    batch is decoded first and an ids batch is collated without
    rotation.

    The fused engine (``inference_engine.fused_forward``, kernel K3) is
    taken under the reference's gate: ``use_fused``, at least 6 layers and
    a configuration ``supports_fusion`` accepts; and, in place of the
    reference's TPU-backend test, only for a batch on a CUDA device.
    ``step.fused`` records the model half of the gate. A ``multitask``
    model is given ``task=model_task`` (its head) on both paths.
    """
    apply_kwargs = ({'task': model_task} if multitask and model_task
                    else {})
    fuse = (use_fused and getattr(model, 'num_layers', 0) >= 6
            and supports_fusion(model))
    model_input = _model_input(model)

    @torch.no_grad()
    def step(batch) -> torch.Tensor:
        model.eval()
        batch = model_input(graph_batch(batch, rotate=False))
        if fuse and batch.node_feats.device.type == 'cuda':
            return fused_forward(model, batch, **apply_kwargs)
        return model(batch, **apply_kwargs)

    step.fused = fuse
    return step


def make_scan_eval_step(model, model_task: Optional[str] = None,
                        multitask: bool = False) -> Callable:
    """Returns ``step(group, template, symmetric) -> logits [G, B, out]``:
    the module forward (as the reference's scan program runs it) of each
    of a group of packed batches of one ``template``, ``group`` a
    ``[G, nbytes]`` uint8 tensor or a ``wire.Staged`` of one. The group's
    copy is waited for once; its rows are decoded and scored in order."""
    eval_step = make_eval_step(model, model_task, multitask=multitask)

    def step(group, template, symmetric: bool = False) -> torch.Tensor:
        rows = ready(group)
        return torch.stack([
            eval_step(('packed', rows[i], template, bool(symmetric)))
            for i in range(rows.shape[0])])

    return step
