"""Model registry and kwarg filtering (counterpart of
``pointvs_tpu/models/registry.py``).

The port has the families whose input is a ``GraphBatch``. ``siamese``
(a receptor/ligand pair) and ``lie_conv`` / ``dense_egnn`` (a dense
batch) need collations the port does not have yet, and ``build_model``
refuses them by name.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict

from pointvs_tpu_torch.models.egnn import SartorrasEGNN
from pointvs_tpu_torch.models.en_transformer import EnTransformer
from pointvs_tpu_torch.models.lucid import LucidEGNN
from pointvs_tpu_torch.models.multitask import MultitaskSatorrasEGNN

MODEL_REGISTRY = {
    'egnn': SartorrasEGNN,
    'lucid': LucidEGNN,
    'multitask': MultitaskSatorrasEGNN,
    'en_transformer': EnTransformer,
    # The reference's lie_transformer niche, served by the same design.
    'lie_transformer': EnTransformer,
}

# What the model's forward consumes: 'graph' = GraphBatch, 'pair' = two
# entity-filtered GraphBatches, 'dense' = zero-padded point clouds.
MODEL_INPUT_KIND = {
    'siamese': 'pair',
    'lie_conv': 'dense',
    'dense_egnn': 'dense',
}


def model_input_kind(model_name: str) -> str:
    return MODEL_INPUT_KIND.get(model_name, 'graph')


def _init_fields(model_cls) -> set:
    """The constructor's keyword names, following ``**kwargs`` into the
    base class it forwards them to."""
    fields = set()
    for cls in model_cls.__mro__:
        if '__init__' not in vars(cls):
            continue
        params = inspect.signature(vars(cls)['__init__']).parameters
        fields |= {name for name, p in params.items()
                   if name != 'self' and p.kind not in (
                       p.VAR_KEYWORD, p.VAR_POSITIONAL)}
        if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
            break
    return fields


def filter_model_kwargs(model_cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the kwargs the model's constructor takes (run dirs carry
    the whole CLI flag set)."""
    fields = _init_fields(model_cls)
    return {k: v for k, v in kwargs.items() if k in fields}


def build_model(model_name: str, **model_kwargs):
    if model_name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f'model {model_name!r} is not in the port yet (it has '
            f'{sorted(MODEL_REGISTRY)}; the {model_input_kind(model_name)!r} '
            f'input layout and other families: see ROADMAP.md, Queue 1)')
    model_cls = MODEL_REGISTRY[model_name]
    return model_cls(**filter_model_kwargs(model_cls, model_kwargs))
