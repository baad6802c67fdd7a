"""Parameter interchange: reference ``.pt`` checkpoints and JAX trees.

Counterpart of ``pointvs_tpu/models/torch_import.py``. The port's modules
already use the reference PointVS state_dict schema, so a reference
checkpoint loads directly (after the reference's own legacy-key
migrations, ``normalise_reference_keys``). ``state_dict_from_flax`` is the
inverse of the JAX package's ``_satorras_flat`` and ``_lucid_flat``: it
carries a JAX parameter tree (numpy arrays; the unrolled ``*_layer_{i}``
or the scan-stacked ``*_scan`` layout) of ``SartorrasEGNN``,
``MultitaskSatorrasEGNN`` (heads ``feats_linear_layers_pose`` /
``_affinity``) or ``LucidEGNN`` into the reference schema, and one of the
families without a reference schema into the port's own keys:
``EnTransformer`` (the JAX module names: ``tf_layer_{i}.q_proj``, ...),
``SiameseEGNN`` (``rec_tower.`` / ``lig_tower.`` before each tower's
egnn keys, ``head.{0,2,4}``) and ``DenseEGNN`` (``input_embed``,
``dense_layers.{i}.{edge,node,coord}_mlp.{0,2}``, ``head``). The family is
read from the tree's top-level names; a name no family has raises.
"""
from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np
import torch


def normalise_reference_keys(sd: Dict) -> Dict:
    """The reference's legacy-schema migrations: ``edge_attention_mlp`` ->
    ``att_mlp``, ``node_attention_mlp`` -> ``node_att_mlp``, and the compat
    attention MLP whose Linear sits at Sequential index 2 moves to 0."""
    out = {}
    for key, value in sd.items():
        key = key.replace('edge_attention_mlp', 'att_mlp')
        key = key.replace('node_attention_mlp', 'node_att_mlp')
        out[key] = value
    for mlp in ('att_mlp', 'node_att_mlp'):
        shifted = {}
        for key in list(out):
            if f'{mlp}.2.' in key:
                base = key.replace(f'{mlp}.2.', f'{mlp}.0.')
                if base not in out:
                    shifted[base] = out.pop(key)
        out.update(shifted)
    return out


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


# JAX layer-relative path prefix -> reference module key, per family.
_LAYER_DENSE = {
    ('edge_mlp', 'TorchLinear_0', 'Dense_0'): 'edge_mlp.0',
    ('edge_mlp', 'TorchLinear_1', 'Dense_0'): 'edge_mlp.2',
    ('node_lin1', 'Dense_0'): 'node_mlp.0',
    ('node_lin2', 'Dense_0'): 'node_mlp.3',
    ('coord_mlp', 'TorchLinear_0', 'Dense_0'): 'coord_mlp.0',
    ('coord_mlp', 'TorchLinear_1', 'Dense_0'): 'coord_mlp.2',
    ('att_mlp', 'Dense_0'): 'att_mlp.0',
    ('node_att_mlp', 'Dense_0'): 'node_att_mlp.0',
}
_LAYER_RAW = {
    ('node_graphnorm', 'weight'): 'node_mlp.1.weight',
    ('node_graphnorm', 'bias'): 'node_mlp.1.bias',
    ('node_graphnorm', 'mean_scale'): 'node_mlp.1.mean_scale',
    ('edge_gate',): 'edge_gate_parameter',
    ('node_gate',): 'node_gate_parameter',
}
# The reference PygLucidEGNN's Sequential indices (its Dropout modules
# hold the places between).
_LUCID_DENSE = {
    ('edge_mlp', 'TorchLinear_0', 'Dense_0'): 'edge_mlp.0',
    ('edge_mlp', 'TorchLinear_1', 'Dense_0'): 'edge_mlp.3',
    ('edge_weight', 'TorchLinear_0', 'Dense_0'): 'edge_weight.0',
    ('edge_weight', 'TorchLinear_1', 'Dense_0'): 'edge_weight.2',
    ('node_lin1',): 'node_mlp.0',
    ('node_lin2',): 'node_mlp.4',
    ('coors_mlp', 'TorchLinear_0', 'Dense_0'): 'coors_mlp.0',
    ('coors_mlp', 'TorchLinear_1', 'Dense_0'): 'coors_mlp.3',
}
_LUCID_RAW = {
    ('node_norm', 'weight'): 'node_norm.weight',
    ('node_norm', 'bias'): 'node_norm.bias',
    ('coors_norm', 'scale'): 'coors_norm.scale',
    ('node_graphnorm', 'weight'): 'node_mlp.2.weight',
    ('node_graphnorm', 'bias'): 'node_mlp.2.bias',
    ('node_graphnorm', 'mean_scale'): 'node_mlp.2.mean_scale',
}
_TF_DENSE = {
    **{(name, 'Dense_0'): name
       for name in ('q_proj', 'k_proj', 'v_proj', 'o_proj')},
    **{(mlp, f'TorchLinear_{m}', 'Dense_0'): f'{mlp}.{2 * m}'
       for mlp in ('edge_bias', 'ff', 'coord_mlp') for m in (0, 1)},
}
_TF_RAW = {(norm, name): f'{norm}.{name}' for norm in ('norm', 'ff_norm')
           for name in ('weight', 'bias')}

# Per family: (unrolled layer scope prefix, scan scope, port layer key
# format, port index of the first layer, dense map, raw map).
_FAMILIES = {
    'egnn': ('egnn_layer_', 'egnn_scan', 'layers.{}', 1, _LAYER_DENSE,
             _LAYER_RAW),
    'lucid': ('lucid_layer_', 'lucid_scan', 'layers.{}', 1, _LUCID_DENSE,
              _LUCID_RAW),
    'en_transformer': ('tf_layer_', 'tf_scan', 'tf_layer_{}', 0, _TF_DENSE,
                       _TF_RAW),
}
# The multitask heads -> port key.
_TOP = {
    ('head_pose', 'TorchLinear_0', 'Dense_0'): 'feats_linear_layers_pose.0',
    ('head_affinity', 'TorchLinear_0', 'Dense_0'):
        'feats_linear_layers_affinity.0',
}


def _leaf_name(path) -> str:
    return 'weight' if path[-1] == 'kernel' else path[-1]


def _layer_key(rel: Tuple[str, ...], dense, raw) -> str:
    if rel in raw:
        return raw[rel]
    if rel[:-1] in dense:
        return f'{dense[rel[:-1]]}.{_leaf_name(rel)}'
    raise KeyError(f'no reference key for layer parameter {"/".join(rel)}')


def _family(inner) -> str:
    if {'rec_tower', 'lig_tower'} & set(inner):
        return 'siamese'
    if any(key.startswith('dense_layer_') for key in inner):
        return 'dense'
    for name, (prefix, scan, *_rest) in _FAMILIES.items():
        if any(key == scan or key.startswith(prefix) for key in inner):
            return name
    return 'egnn'   # a tree of no layers: the input embedding and head


def _top_key(family: str, path) -> str:
    """Port key of a parameter outside the layers."""
    head = path[0]
    if head == 'input_embed':
        module = ('layers.0.m' if family != 'en_transformer'
                  else 'input_embed')
        return f'{module}.{_leaf_name(path)}'
    if head == 'head':
        if family == 'lucid':     # one flax Dense
            return f'feats_linear_layers.0.{_leaf_name(path)}'
        module = 'head' if family == 'en_transformer' \
            else 'feats_linear_layers'
        return f'{module}.{_linear_index(path[1])}.{_leaf_name(path)}'
    if path[:-1] in _TOP:
        return f'{_TOP[path[:-1]]}.{_leaf_name(path)}'
    raise KeyError(f'unexpected parameter {"/".join(path)}')


def _put(sd, key, path, value):
    # flax Dense kernels are [in, out]; torch Linear weights [out, in].
    sd[key] = value.T if path[-1] == 'kernel' else value


def _linear_index(scope: str) -> int:
    """Sequential index of ``TorchLinear_{m}`` in the port's MLPs, whose
    activations sit between the Linears."""
    return 2 * int(scope.rsplit('_', 1)[1])


def _siamese_tree(inner) -> Dict[str, np.ndarray]:
    extra = set(inner) - {'rec_tower', 'lig_tower', 'head'}
    if extra:
        raise KeyError(f'unexpected siamese parameters {sorted(extra)}')
    sd = {}
    for tower in ('rec_tower', 'lig_tower'):
        sd.update({f'{tower}.{key}': value
                   for key, value in _graph_tree(inner[tower]).items()})
    for path, value in _flat(inner['head']):
        _put(sd, f'head.{_linear_index(path[0])}.{_leaf_name(path)}', path,
             value)
    return sd


def _dense_tree(inner) -> Dict[str, np.ndarray]:
    sd = {}
    for path, value in _flat(inner):
        head = path[0]
        if head in ('input_embed', 'head') and path[1:-1] == ('Dense_0',):
            key = head
        elif (head.startswith('dense_layer_') and len(path) == 5
              and path[1] in ('edge_mlp', 'node_mlp', 'coord_mlp')
              and path[3] == 'Dense_0'):
            key = (f'dense_layers.{int(head[len("dense_layer_"):])}.'
                   f'{path[1]}.{_linear_index(path[2])}')
        else:
            raise KeyError(f'unexpected parameter {"/".join(path)}')
        _put(sd, f'{key}.{_leaf_name(path)}', path, value)
    return sd


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """JAX params of any family (``{'params': ...}`` or the inner tree, as
    numpy or jax arrays) -> the port's state_dict (the reference schema
    where there is one)."""
    inner = params['params'] if 'params' in params else params
    family = _family(inner)
    tree = {'siamese': _siamese_tree, 'dense': _dense_tree}.get(
        family, _graph_tree)
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in tree(inner).items()}


def _graph_tree(inner) -> Dict[str, np.ndarray]:
    """A graph-input family's tree -> port keys and numpy arrays."""
    family = _family(inner)
    prefix, scan, layer_fmt, first, dense, raw = _FAMILIES[family]
    sd: Dict[str, np.ndarray] = {}

    def put(key, path, value):
        _put(sd, key, path, value)

    for path, value in _flat(inner):
        head = path[0]
        if head.startswith(prefix):
            i = int(head[len(prefix):]) + first
            put(f'{layer_fmt.format(i)}.{_layer_key(path[1:], dense, raw)}',
                path, value)
        elif head == scan:
            key = _layer_key(path[1:], dense, raw)
            for i in range(value.shape[0]):
                put(f'{layer_fmt.format(i + first)}.{key}', path, value[i])
        else:
            put(_top_key(family, path), path, value)
    return sd


def load_reference_checkpoint(path) -> Tuple[Dict, Dict]:
    """Read a reference ``.pt`` checkpoint -> (state_dict, meta).

    Accepts the reference save format (``model_state_dict`` plus epochs,
    and the optimiser state when present: ``meta['optimiser_state_dict']``)
    and a bare state_dict. The safe loader (``weights_only=True``) is tried
    first; only when it rejects a non-allowlisted global is the file read
    again with ``weights_only=False`` (which can run code from the file:
    load only checkpoints you trust). Any other failure, such as a corrupt
    file, raises as it is.
    """
    try:
        ckpt = torch.load(str(path), map_location='cpu', weights_only=True)
    except pickle.UnpicklingError as exc:
        if 'Unsupported global' not in str(exc):
            raise
        ckpt = torch.load(str(path), map_location='cpu', weights_only=False)
    if isinstance(ckpt, dict) and 'model_state_dict' in ckpt:
        meta = {'p_epoch': int(ckpt.get('p_epoch', ckpt.get('epoch', 0))),
                'a_epoch': int(ckpt.get('a_epoch', 0))}
        if 'optimiser_state_dict' in ckpt:
            meta['optimiser_state_dict'] = ckpt['optimiser_state_dict']
        sd = ckpt['model_state_dict']
    else:
        sd, meta = ckpt, {'p_epoch': 0, 'a_epoch': 0}
    return normalise_reference_keys(dict(sd)), meta
