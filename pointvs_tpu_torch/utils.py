"""Host helpers: paths, yaml sidecars, checkpoint lookup, logging.

Own copies of the helpers the serving path needs from the reference's
``pointvs_tpu/utils.py`` and ``pointvs_tpu/logging.py``.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any

import numpy as np
import yaml


def get_logger(name: str = 'PointVS-TPU-torch') -> logging.Logger:
    """Named logger with one stream handler; LOGLEVEL sets the level."""
    logger = logging.getLogger(name)
    logger.propagate = False
    logger.setLevel(os.environ.get('LOGLEVEL', 'INFO').upper())
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            '{asctime} [{levelname}] [{module}:{lineno}] {name}: {message}',
            '%Y:%m:%d %H:%M:%S', style='{'))
        logger.addHandler(handler)
    return logger


def expand_path(*paths) -> Path:
    """Expand ~ and environment variables; return an absolute Path."""
    return Path(os.path.expandvars(
        Path(*[str(p) for p in paths]).expanduser())).absolute()


def mkdir(*paths) -> Path:
    path = expand_path(*paths)
    path.mkdir(exist_ok=True, parents=True)
    return path


def save_yaml(obj: Any, fname) -> None:
    """Dump to yaml, coercing Paths and numpy scalars to plain values."""

    def _coerce(o):
        if isinstance(o, Path):
            return str(o)
        if isinstance(o, dict):
            return {k: _coerce(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [_coerce(v) for v in o]
        if isinstance(o, np.generic):
            return o.item()
        return o

    with open(expand_path(fname), 'w', encoding='utf-8') as f:
        yaml.dump(_coerce(obj), f)


def load_yaml(fname) -> Any:
    """Load yaml, tolerating python object tags written by other tools."""

    class _TolerantLoader(yaml.SafeLoader):
        pass

    def _unknown(loader, suffix, node):
        del suffix
        if isinstance(node, yaml.ScalarNode):
            return loader.construct_scalar(node)
        if isinstance(node, yaml.SequenceNode):
            return loader.construct_sequence(node)
        if isinstance(node, yaml.MappingNode):
            return loader.construct_mapping(node)
        return None

    _TolerantLoader.add_multi_constructor('tag:yaml.org,2002:python/',
                                          _unknown)
    _TolerantLoader.add_multi_constructor('!', _unknown)
    with open(expand_path(fname), 'r', encoding='utf-8') as f:
        return yaml.load(f, Loader=_TolerantLoader)


def find_latest_checkpoint(root) -> Path:
    """Newest ``*ckpt_epoch_*`` entry under <root>/checkpoints or <root>."""
    root = expand_path(root)
    for candidate_dir in (root / 'checkpoints', root):
        if not candidate_dir.is_dir():
            continue
        ckpts = list(candidate_dir.glob('*ckpt_epoch_*'))
        if ckpts:
            return max(ckpts, key=lambda p: (p.stat().st_mtime, str(p)))
    raise FileNotFoundError(f'No checkpoints found under {root}')


def get_n_cols(fname) -> int:
    """Whitespace-separated columns in the first non-empty line."""
    with open(expand_path(fname), 'r', encoding='utf-8') as f:
        for line in f:
            if line.strip():
                return len(line.split())
    return 0
