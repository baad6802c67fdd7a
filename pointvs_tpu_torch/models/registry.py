"""Model registry and kwarg filtering (counterpart of
``pointvs_tpu/models/registry.py``).

Every family of the reference: those whose input is a ``GraphBatch``
(``egnn``, ``lucid``, ``multitask``, ``en_transformer`` /
``lie_transformer``), ``siamese`` (a ``SiamesePair`` of receptor and
ligand batches) and ``lie_conv`` / ``dense_egnn`` (a ``DenseBatch``).
``model_input_kind`` names the input, which picks the loader's layout.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict

from pointvs_tpu_torch.models.egnn import SartorrasEGNN
from pointvs_tpu_torch.models.en_transformer import EnTransformer
from pointvs_tpu_torch.models.lucid import LucidEGNN
from pointvs_tpu_torch.models.multitask import MultitaskSatorrasEGNN
from pointvs_tpu_torch.models.siamese import SiameseEGNN
from pointvs_tpu_torch.models.vanilla import DenseEGNN

MODEL_REGISTRY = {
    'egnn': SartorrasEGNN,
    'lucid': LucidEGNN,
    'multitask': MultitaskSatorrasEGNN,
    'en_transformer': EnTransformer,
    # The reference's lie_transformer niche, served by the same design.
    'lie_transformer': EnTransformer,
    'siamese': SiameseEGNN,
    # The reference's LieConv niche, served by the dense all-pairs EGNN.
    'lie_conv': DenseEGNN,
    'dense_egnn': DenseEGNN,
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
            f'model must be one of {sorted(MODEL_REGISTRY)}, got '
            f'{model_name!r}')
    model_cls = MODEL_REGISTRY[model_name]
    return model_cls(**filter_model_kwargs(model_cls, model_kwargs))
