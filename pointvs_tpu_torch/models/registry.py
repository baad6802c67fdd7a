"""Model registry and kwarg filtering (counterpart of
``pointvs_tpu/models/registry.py``)."""
from __future__ import annotations

import inspect
from typing import Any, Dict

from pointvs_tpu_torch.models.egnn import SartorrasEGNN

MODEL_REGISTRY = {'egnn': SartorrasEGNN}


def filter_model_kwargs(model_cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the kwargs the model's constructor takes (run dirs carry
    the whole CLI flag set)."""
    fields = set(inspect.signature(model_cls).parameters)
    return {k: v for k, v in kwargs.items() if k in fields}


def build_model(model_name: str, **model_kwargs):
    if model_name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f'model {model_name!r} is not in the port yet (it has '
            f'{sorted(MODEL_REGISTRY)}; other families: see ROADMAP.md, '
            f'Queue 1)')
    model_cls = MODEL_REGISTRY[model_name]
    return model_cls(**filter_model_kwargs(model_cls, model_kwargs))
