"""Training from the device store: the traffic kind ``train``.

Set-up writes the pose set, builds the training CLI's arguments from the
configuration and the traffic (``config.parse_args``), builds the loaders
and the ``Trainer`` as ``main._train_rank`` does (``main.build_loaders``,
``model_kwargs_from_args``), loads the benchmark's weights into the
model, and trains the first epoch through ``Trainer.train_model``: the
store's build, the first steps and every shape the window uses. The window
calls ``train_model`` epoch by epoch, as ``main.run_phases`` does with one
epoch more each time, until ``--seconds`` have passed; its rate is the
graphs of the epochs it ran over its time, synchronised at its end.

The check follows the first ``check_steps`` steps of set-up, which went
through the window's own call: each step's loss, the first gradient as
the optimiser took it (its first moment after one step over 1 - beta1),
and each parameter's change after the last of them, taken by an optimiser
hook before the next step moves them. The reference replays them from the
same weights on the same graphs, which it featurises itself
(``reference/``), after the program's state is freed. It also takes the
first step of the window's last epoch from the program's own state at
that epoch's start (parameters, Adam's moments, the step's count), on the
batch that the index stream gives that step, and compares the step's loss
and each parameter's change: what the epochs between carry over (the
shuffle, the optimiser's state, the learning rate) is held there.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from pvsbench import inputs
from pvsbench.reference import egnn as ref_egnn
from pvsbench.reference import featurise as ref_feat
from pvsbench.reference import train as ref_train
from pvsbench.roofline import egnn_train_flops

SPAN = 'pvsbench.train.epoch'


def program_seed(seed: int) -> int:
    """The CLI's --seed: the program takes an int32 (a JAX PRNGKey)."""
    return int(seed) % (2 ** 31)


def cli_argv(ctx, poses: dict, save_path) -> list:
    """The training CLI's command line for this cell."""
    cfg, traffic = ctx.config, ctx.traffic
    task = cfg['task']
    argv = [cfg['model'], str(save_path), '--device', ctx.device.type,
            '-b', str(traffic['batch_size']),
            '--device_cache', traffic['device_cache'],
            '--seed', str(program_seed(ctx.seed))]
    if task == 'classification':
        argv += ['--train_data_root_pose', str(poses['root']),
                 '--train_types_pose', str(poses['manifests'][task]),
                 '-ep', '1000000']
    else:
        argv += ['--train_data_root_affinity', str(poses['root']),
                 '--train_types_affinity', str(poses['manifests'][task]),
                 '-ea', '1000000', '--model_task', task]
    return argv + inputs.cli_flags(cfg['flags'])


def setup(ctx) -> dict:
    from pointvs_tpu_torch.config import model_kwargs_from_args, parse_args
    from pointvs_tpu_torch.main import build_loaders
    from pointvs_tpu_torch.parallel.mesh import Mesh
    from pointvs_tpu_torch.training.engine import Trainer
    poses = inputs.write_pose_set(ctx.traffic, ctx.seed, ctx.work / 'data')
    ctx.parts.mark('inputs')
    args = parse_args(cli_argv(ctx, poses, ctx.work / 'run'))
    mesh = Mesh(args.graph_shard)
    loaders = build_loaders(args, mesh)
    loader = loaders[0] if ctx.config['task'] == 'classification' \
        else loaders[1]
    model_kwargs = model_kwargs_from_args(args, loader.dataset.feature_dim)
    trainer = Trainer(
        args.model, ctx.work / 'run', ctx.device,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        optimiser=args.optimiser, use_1cycle=args.use_1cycle,
        warm_restarts=args.warm_restarts,
        only_save_best_models=args.only_save_best_models,
        regression_loss=args.regression_loss, seed=args.seed,
        profile=args.profile, num_devices=mesh.world, double=args.double,
        device_cache=args.device_cache, mesh=mesh, **model_kwargs)
    ctx.parts.mark('trainer')
    weights = inputs.make_weights(ctx.schema, ctx.seed, ctx.device)
    trainer.model.load_state_dict(weights, strict=True)
    weights = {k: v.cpu() for k, v in weights.items()}
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    snaps = {'steps': 0}
    beta1 = trainer.optimiser.param_groups[0]['betas'][0]

    per_epoch = len(loader)

    def params():
        return {n: p.detach().clone()
                for n, p in trainer.model.named_parameters()}

    def hook(opt, *_):
        snaps['steps'] += 1
        step = snaps['steps']
        if step == 1:
            snaps['first'] = {names[id(p)]: s['exp_avg'].detach().cpu()
                              / (1 - beta1) for p, s in opt.state.items()}
        if step == ctx.traffic['check_steps']:
            snaps['params'] = {n: p.cpu() for n, p in params().items()}
        # Device copies only: the window's steps are not held up.
        if step > per_epoch and (step - 1) % per_epoch == 0:
            snaps['last_epoch'] = dict(step=step, before=snaps['epoch_end'],
                                       after=params())
        if step % per_epoch == 0:
            snaps['epoch_end'] = dict(params=params(), moments={
                names[id(p)]: (s['exp_avg'].detach().clone(),
                               s['exp_avg_sq'].detach().clone())
                for p, s in opt.state.items()})

    trainer.optimiser.register_step_post_hook(hook)
    trainer.set_task(ctx.config['task'])
    trainer.train_model(loader, epochs=trainer.epoch + 1)
    if ctx.device.type == 'cuda':
        torch.cuda.synchronize(ctx.device)
    ctx.parts.mark('store_and_first_epoch')
    return dict(trainer=trainer, loader=loader, args=args, poses=poses,
                weights=weights, snaps=snaps,
                losses=list(trainer.train_losses[:ctx.traffic['check_steps']]),
                warm_steps=len(trainer.train_losses))


def window(ctx, state, tracer) -> dict:
    from torch.profiler import record_function
    trainer, loader = state['trainer'], state['loader']
    sync = (lambda: torch.cuda.synchronize(ctx.device)) \
        if ctx.device.type == 'cuda' else (lambda: None)
    sync()
    start = time.perf_counter()
    epochs = 0
    while not epochs or time.perf_counter() - start < ctx.seconds \
            or tracer.needs_more(epochs):
        tracer.before(epochs, ctx.device)
        with record_function(SPAN):
            trainer.train_model(loader, epochs=trainer.epoch + 1)
        tracer.after(epochs, ctx.device)
        epochs += 1
    sync()
    window_s = time.perf_counter() - start
    snaps = state['snaps']
    last = snaps.pop('last_epoch')
    snaps.pop('epoch_end')
    state['last_epoch'] = dict(
        step=last['step'], loss=trainer.train_losses[last['step'] - 1],
        params=_to_cpu(last['before']['params']),
        moments=_to_cpu(last['before']['moments']),
        after=_to_cpu(last['after']))
    n = len(loader.dataset)
    obs = dict(kind='train', window_s=window_s, graphs=epochs * n,
               attempted=epochs * n, failed=0,
               step_ms=trainer.step_ms()[state['warm_steps']:],
               trace=tracer.summary)
    store = next(iter(trainer._device_stores.values()))[1].host
    cls = ctx.config['task'] == 'classification'
    labels = state['poses']['labels'] if cls else np.zeros(n)
    epochs_idx = ref_train.epoch_indices(labels, program_seed(ctx.seed),
                                         1 + epochs, cls)[1:]
    idx = np.concatenate(epochs_idx)
    obs['model_flops'] = egnn_train_flops(
        int(store.num_nodes[idx].sum()), int(store.num_edges[idx].sum()),
        len(idx), ctx.config['flags']['channels'],
        ctx.config['flags']['layers'])
    return obs


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_cpu(v) for v in tree)
    return tree.cpu()


def release(state) -> None:
    for key in ('trainer', 'loader'):
        state.pop(key, None)


def leaf_gaps(prog: dict, ref: dict, names) -> list:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of the reference leaf's norm and the median leaf's."""
    norms = {k: float(ref[k].norm()) for k in names}
    median = float(np.median(list(norms.values())))
    return [abs(float(prog[k].norm()) - norms[k]) / max(norms[k], median)
            for k in names]


class Batches:
    """The graphs and labels of each step, featurised by the reference
    from the pose files as the index stream takes them."""

    def __init__(self, ctx, state):
        self.ctx, self.poses = ctx, state['poses']
        self.cls = ctx.config['task'] == 'classification'
        self.rec = ref_feat.read_structure(self.poses['root']
                                           / inputs.RECEPTOR)
        self.labels = np.asarray(self.poses['labels'] if self.cls
                                 else self.poses['pk'], np.float32)
        self.per_epoch = -(-len(self.poses['files'])
                           // ctx.traffic['batch_size'])
        self.graphs, self.epochs = {}, []

    def __call__(self, step: int, half_batch: bool = False) -> tuple:
        """(graphs, labels) of the run's ``step``-th step (from 1); with
        ``half_batch``, the batch's first half alone."""
        epoch, at = divmod(step - 1, self.per_epoch)
        if epoch >= len(self.epochs):
            self.epochs = ref_train.epoch_indices(
                self.poses['labels'], program_seed(self.ctx.seed),
                epoch + 1, self.cls)
        batch = self.ctx.traffic['batch_size']
        ids = self.epochs[epoch][at * batch:(at + 1) * batch]
        if half_batch:
            ids = ids[:len(ids) // 2]
        flags = self.ctx.config['flags']
        for i in ids:
            if i not in self.graphs:
                self.graphs[i] = ref_feat.featurise(
                    self.rec, ref_feat.read_structure(self.poses['files'][i]),
                    flags['radius'], flags['edge_radius'],
                    flags.get('estimate_bonds', False))
        return [self.graphs[i] for i in ids], self.labels[ids]


def replay(ctx, batches, weights, steps, prec, moments=None):
    """The reference's steps ``steps`` (consecutive, from 1) from
    ``weights`` and Adam's ``moments``; see ``reference.train.replay``.
    ``steps`` are step numbers, or (step, half_batch) pairs."""
    steps = [s if isinstance(s, tuple) else (s, False) for s in steps]
    flags = ctx.config['flags']
    return ref_train.replay(
        weights, [batches(*s) for s in steps], ctx.config['task'],
        flags['layers'], flags['learning_rate'], flags['weight_decay'],
        batches.per_epoch, flags.get('warm_restarts', False), ctx.device,
        prec, ref_egnn.EDGE_BUDGET, moments=moments, first_step=steps[0][0])


def reference_readings(ctx, state, batches, prec, half_batch=False):
    """The reference's first ``check_steps`` steps under ``prec`` (with
    ``half_batch``, each batch's first half alone, as a step that leaves
    half out)."""
    return replay(ctx, batches, state['weights'],
                  [(s, half_batch) for s in
                   range(1, ctx.traffic['check_steps'] + 1)], prec)


def moved_leaves(raw: dict) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move under Adam by rounding alone)."""
    norms = {k: float(v.norm()) for k, v in raw.items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    return [k for k in raw if norms[k] >= floor]


def readings(ctx, state, losses, first, params, ref) -> dict:
    """The compared numbers of a run's first steps (``losses``,
    ``first``, ``params``) against the reference's replay ``ref``."""
    ref_losses, ref_first, ref_raw, ref_params, _ = ref
    w0 = state['weights']
    moved = moved_leaves(ref_raw)
    change = leaf_gaps({k: params[k] - w0[k] for k in moved},
                       {k: ref_params[k] - w0[k] for k in moved}, moved)
    return {
        'loss_gap': max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                           ref_losses)),
        'grad_gap': max(leaf_gaps(first, ref_first, list(w0))),
        'change_gap': max(change),
        'change_gap_median': float(np.median(change)),
    }


def step_readings(loss, before, after, ref) -> dict:
    """The compared numbers of one step from ``before`` to ``after``
    with loss ``loss``, against the reference's step ``ref``."""
    (ref_loss,), _, ref_raw, ref_after, _ = ref
    moved = moved_leaves(ref_raw)
    change = leaf_gaps({k: after[k] - before[k] for k in moved},
                       {k: ref_after[k] - before[k] for k in moved}, moved)
    return {'loss_gap_last_epoch': abs(loss - ref_loss) / abs(ref_loss),
            'change_gap_last_epoch': max(change)}


def check(ctx, state, obs) -> dict:
    snaps, last = state['snaps'], state['last_epoch']
    batches = Batches(ctx, state)
    f32 = ref_egnn.Precision(False)
    out = readings(ctx, state, state['losses'], snaps['first'],
                   snaps['params'],
                   reference_readings(ctx, state, batches, f32))
    out.update(step_readings(
        last['loss'], last['params'], last['after'],
        replay(ctx, batches, last['params'], [last['step']], f32,
               moments=last['moments'])))
    return out


def end_to_end(obs) -> dict:
    return {'train_graphs_per_s': obs['graphs'] / obs['window_s']}
