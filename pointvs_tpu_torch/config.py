"""Command-line flags of the training CLI (own copy of
``pointvs_tpu/config.py``).

Every flag of the reference, with the same names, aliases, types and
defaults, so a reference command line parses unchanged; plus ``--device``
(``cuda``, the default, or ``cpu``). ``--scatter_cap`` is parsed and has
no effect (``main.note_scatter_cap``).
"""
from __future__ import annotations

import argparse

# (name, aliases, keyword arguments) of the reference's flags, in its order.
_STORE_TRUE = dict(action='store_true')
_FLAGS = (
    ('--train_data_root_pose', (), dict(type=str)),
    ('--train_data_root_affinity', ('--tdra',), dict(type=str)),
    ('--test_data_root_pose', (), dict(type=str)),
    ('--test_data_root_affinity', (), dict(type=str)),
    ('--logging_level', (), dict(type=str, default='info')),
    ('--load_weights', ('-l',), dict(
        type=str, required=False,
        help='Load a .pt checkpoint: weights, epoch counters and, when the '
             'file holds the port\'s own, the optimiser state')),
    ('--import_torch_weights', (), dict(
        type=str, help='Import the weights and epoch counters of a '
                       'reference-schema .pt checkpoint; the optimiser '
                       'restarts')),
    ('--translated_actives', (), dict(type=str)),
    ('--batch_size', ('-b',), dict(type=int, default=32)),
    ('--epochs_pose', ('-ep',), dict(type=int, default=0)),
    ('--epochs_affinity', ('-ea',), dict(type=int, default=0)),
    ('--channels', ('-k',), dict(type=int, default=32)),
    ('--learning_rate', ('-lr',), dict(type=float, default=0.002)),
    ('--weight_decay', ('-w',), dict(type=float, default=1e-4)),
    ('--wandb_project', (), dict(type=str)),
    ('--wandb_run', (), dict(type=str)),
    ('--layers', (), dict(type=int, default=6)),
    ('--radius', (), dict(type=int, default=10,
                          help='Pocket box radius (Angstrom)')),
    ('--load_args', (), dict(
        type=str, help='YAML file of args overriding the command line')),
    ('--double', (), _STORE_TRUE),
    ('--activation', (), dict(type=str, default='relu')),
    ('--dropout', (), dict(type=float, default=0.0)),
    ('--use_1cycle', (), _STORE_TRUE),
    ('--warm_restarts', (), _STORE_TRUE),
    ('--fourier_features', (), dict(type=int, default=0)),
    ('--norm_coords', (), _STORE_TRUE),
    ('--norm_feats', (), _STORE_TRUE),
    ('--use_atomic_numbers', (), _STORE_TRUE),
    ('--compact', (), _STORE_TRUE),
    ('--thin_mlps', (), _STORE_TRUE),
    ('--hydrogens', (), _STORE_TRUE),
    ('--augmented_actives', (), dict(type=int, default=0)),
    ('--min_aug_angle', (), dict(type=float, default=30)),
    ('--max_active_rmsd', (), dict(type=float)),
    ('--min_inactive_rmsd', (), dict(type=float)),
    ('--max_inactive_rmsd', (), dict(type=float)),
    ('--val_on_epoch_end', ('-v',), _STORE_TRUE),
    ('--synth_pharm', ('-p',), _STORE_TRUE),
    ('--input_suffix', ('-s',), dict(type=str, default='parquet')),
    ('--train_types_pose', (), dict(type=str)),
    ('--train_types_affinity', (), dict(type=str)),
    ('--test_types_pose', (), dict(type=str)),
    ('--test_types_affinity', (), dict(type=str)),
    ('--egnn_attention', (), _STORE_TRUE),
    ('--egnn_tanh', (), _STORE_TRUE),
    ('--egnn_normalise', (), _STORE_TRUE),
    ('--egnn_residual', (), _STORE_TRUE),
    ('--edge_radius', (), dict(type=float, default=4.0)),
    ('--end_flag', (), _STORE_TRUE),
    ('--wandb_dir', (), dict(type=str)),
    ('--estimate_bonds', (), _STORE_TRUE),
    ('--prune', (), _STORE_TRUE),
    ('--top1', (), _STORE_TRUE),
    ('--graphnorm', (), _STORE_TRUE),
    ('--strict_graphnorm', (), dict(
        action='store_true',
        help='GraphNorm statistics over the whole batch, as the original '
             'PointVS computes them; default is per-graph statistics')),
    ('--multi_fc', (), _STORE_TRUE),
    ('--lucid_node_final_act', (), _STORE_TRUE),
    ('--p_remove_entity', (), dict(type=float, default=0)),
    ('--static_coords', (), _STORE_TRUE),
    ('--permutation_invariance', (), _STORE_TRUE),
    ('--node_attention', (), _STORE_TRUE),
    ('--attention_activation_function', (), dict(type=str,
                                                 default='sigmoid')),
    ('--only_save_best_models', (), _STORE_TRUE),
    ('--egnn_edge_residual', (), _STORE_TRUE),
    ('--gated_residual', (), _STORE_TRUE),
    ('--rezero', (), _STORE_TRUE),
    ('--extended_atom_types', (), _STORE_TRUE),
    ('--model_task', (), dict(
        type=str, default='classification',
        help='classification, regression, multi_regression or both')),
    ('--synthpharm', (), _STORE_TRUE),
    ('--p_noise', (), dict(type=float, default=-1)),
    ('--include_strain_info', (), _STORE_TRUE),
    ('--final_softplus', (), _STORE_TRUE),
    ('--optimiser', ('-o',), dict(type=str, default='adam')),
    ('--multi_target_affinity', (), _STORE_TRUE),
    ('--regression_loss', (), dict(type=str, default='mse')),
    ('--softmax_attention', (), _STORE_TRUE),
    ('--node_attention_final_only', (), _STORE_TRUE),
    ('--edge_attention_final_only', (), _STORE_TRUE),
    ('--node_attention_first_only', (), _STORE_TRUE),
    ('--edge_attention_first_only', (), _STORE_TRUE),
    # The reference's additions to the original PointVS flag set.
    ('--num_devices', (), dict(type=int, default=None,
                               help='Data-parallel ranks, one process '
                                    'each (default: the visible cards; 1 '
                                    'on the CPU)')),
    ('--cache_dir', (), dict(type=str, default=None,
                             help='On-disk cache for preprocessed graphs')),
    ('--prefetch', (), dict(type=int, default=2,
                            help='Batches prefetched by the loader thread')),
    ('--seed', (), dict(type=int, default=2)),
    ('--profile', (), dict(
        action='store_true',
        help='Write a torch.profiler trace of steps 3-8 of the first epoch '
             'to <save_path>/profile: the device\'s kernels and the '
             'port\'s spans (pointvs.train.*, pointvs.step.*)')),
    ('--debug_nans', (), dict(
        action='store_true',
        help='torch.autograd anomaly detection: fail at the first op whose '
             'backward gives NaN')),
    ('--no_scan_layers', (), dict(
        action='store_true',
        help='Recorded in model_kwargs.yaml for the JAX package; the '
             'port\'s parameters are per layer either way')),
    ('--bf16', (), dict(
        action='store_true',
        help='bfloat16 feature MLPs from f32 parameters; coordinates, the '
             'aggregations (K1/K2, in f32), the head and the loss stay f32. '
             'EGNN family only (ignored by other models)')),
    ('--remat', (), dict(
        action='store_true',
        help='Recompute each EGNN layer in backward '
             '(torch.utils.checkpoint): activation memory O(depth)')),
    ('--graph_shard', (), dict(
        type=int, default=1,
        help='Split each batch\'s edges over this many ranks (edge '
             'parallelism); --num_devices must be a multiple')),
    ('--multihost', (), dict(
        action='store_true',
        help='Run as one rank of a launcher\'s job (RANK, WORLD_SIZE, '
             'LOCAL_RANK, MASTER_ADDR, MASTER_PORT, as torchrun sets '
             'them); needs --node_bucket and --edge_bucket')),
    ('--node_bucket', (), dict(
        type=int, default=None,
        help='Pin the padded node count per batch to one size')),
    ('--edge_bucket', (), dict(
        type=int, default=None,
        help='Pin the padded edge count per batch to one size')),
    ('--scatter_cap', (), dict(
        type=int, default=None,
        help='The TPU kernels\' window capacity; no effect here: the '
             'segment kernels have no windows')),
    ('--device_cache', (), dict(
        default='auto', choices=('auto', 'on', 'off'),
        help='Device-resident dataset: put the whole featurised dataset on '
             'the device once and collate each batch there from the sampled '
             'item ids. auto = when the dataset is eligible (no p_noise or '
             'p_remove_entity; augmented actives through a per-epoch '
             'refreshed tail), its estimate is within POINTVS_DD_AUTO_MB '
             '(default 512) and it fits POINTVS_DD_BUDGET_MB (default '
             '2048); on = always, or stop naming why not. The per-epoch '
             'random rotation moves onto the device')),
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('model', type=str,
                        help='Point cloud network: egnn, multitask, lucid, '
                             'en_transformer, lie_transformer, siamese, '
                             'dense_egnn or lie_conv')
    parser.add_argument('save_path', type=str,
                        help='Directory for experiment outputs')
    for name, aliases, kwargs in _FLAGS:
        parser.add_argument(name, *aliases, **kwargs)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='Train on the GPU (default) or the CPU')
    return parser.parse_args(argv)


def regression_task_of(args) -> str:
    return ('multi_regression' if (args.multi_target_affinity
                                   or args.model_task == 'multi_regression')
            else 'regression')


def model_kwargs_from_args(args, dim_input: int) -> dict:
    """Flags -> model kwargs, the reference's dict key for key. As in the
    reference, ``--activation`` is not forwarded (the layers use SiLU)."""
    regression_task = regression_task_of(args)
    attention_placement = any(getattr(args, name, False) for name in (
        'node_attention_final_only', 'edge_attention_final_only',
        'node_attention_first_only', 'edge_attention_first_only'))
    return {
        'k': args.channels,
        'num_layers': args.layers,
        'dropout': args.dropout,
        'dim_input': dim_input,
        'dim_output': 3 if regression_task == 'multi_regression' else 1,
        'norm_coords': args.norm_coords,
        'norm_feats': args.norm_feats,
        'thin_mlps': args.thin_mlps,
        'edge_attention': args.egnn_attention,
        'attention': args.egnn_attention,
        'tanh': args.egnn_tanh,
        'normalize': args.egnn_normalise,
        'residual': args.egnn_residual,
        'edge_residual': args.egnn_edge_residual,
        'graphnorm': args.graphnorm,
        'graphnorm_whole_batch': getattr(args, 'strict_graphnorm', False),
        'multi_fc': args.multi_fc,
        'update_coords': not args.static_coords,
        'node_final_act': args.lucid_node_final_act,
        'permutation_invariance': args.permutation_invariance,
        'attention_activation_fn': args.attention_activation_function,
        'node_attention': args.node_attention,
        'node_attention_final_only': args.node_attention_final_only,
        'edge_attention_final_only': args.edge_attention_final_only,
        'node_attention_first_only': args.node_attention_first_only,
        'edge_attention_first_only': args.edge_attention_first_only,
        'gated_residual': args.gated_residual,
        'rezero': args.rezero,
        'model_task': args.model_task,
        'include_strain_info': args.include_strain_info,
        'final_softplus': args.final_softplus,
        'softmax_attention': args.softmax_attention,
        'fourier_features': args.fourier_features,
        'remat': args.remat,
        'bf16': args.bf16,
        'scan_layers': not args.no_scan_layers and not attention_placement,
    }
