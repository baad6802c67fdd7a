"""Parameter interchange: reference ``.pt`` checkpoints and JAX trees.

Counterpart of ``pointvs_tpu/models/torch_import.py``. The port's modules
already use the reference PointVS state_dict schema, so a reference
checkpoint loads directly (after the reference's own legacy-key
migrations, ``normalise_reference_keys``). ``state_dict_from_flax`` is the
inverse of the JAX package's ``_satorras_flat``: it carries a JAX
``SartorrasEGNN`` parameter tree (numpy arrays; unrolled ``egnn_layer_{i}``
or scan-stacked ``egnn_scan`` layout) into that schema.
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


# JAX layer-relative path prefix -> reference module key.
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


def _layer_key(rel: Tuple[str, ...]) -> str:
    if rel in _LAYER_RAW:
        return _LAYER_RAW[rel]
    if rel[:-1] in _LAYER_DENSE:
        name = 'weight' if rel[-1] == 'kernel' else rel[-1]
        return f'{_LAYER_DENSE[rel[:-1]]}.{name}'
    raise KeyError(f'no reference key for layer parameter {"/".join(rel)}')


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """JAX SartorrasEGNN params (``{'params': ...}`` or the inner tree, as
    numpy or jax arrays) -> a state_dict in the reference schema."""
    inner = params['params'] if 'params' in params else params
    sd: Dict[str, np.ndarray] = {}

    def put(key, path, value):
        # flax Dense kernels are [in, out]; torch Linear weights [out, in].
        sd[key] = value.T if path[-1] == 'kernel' else value

    for path, value in _flat(inner):
        head = path[0]
        if head == 'input_embed':
            put(f'layers.0.m.{"weight" if path[-1] == "kernel" else "bias"}',
                path, value)
        elif head == 'head':
            m = int(path[1].rsplit('_', 1)[1])
            name = 'weight' if path[-1] == 'kernel' else 'bias'
            put(f'feats_linear_layers.{2 * m}.{name}', path, value)
        elif head.startswith('egnn_layer_'):
            i = int(head[len('egnn_layer_'):]) + 1
            put(f'layers.{i}.{_layer_key(path[1:])}', path, value)
        elif head == 'egnn_scan':
            key = _layer_key(path[1:])
            for i in range(value.shape[0]):
                put(f'layers.{i + 1}.{key}', path, value[i])
        else:
            raise KeyError(f'unexpected parameter {"/".join(path)}')
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def load_reference_checkpoint(path) -> Tuple[Dict, Dict]:
    """Read a reference ``.pt`` checkpoint -> (state_dict, meta).

    Accepts the reference save format (``model_state_dict`` plus epochs)
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
        sd = ckpt['model_state_dict']
    else:
        sd, meta = ckpt, {'p_epoch': 0, 'a_epoch': 0}
    return normalise_reference_keys(dict(sd)), meta
