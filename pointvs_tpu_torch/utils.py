"""Host helpers: paths, yaml sidecars, checkpoint lookup, time formatting,
coordinate keys (``PositionDict``), a process fan-out and a shell call.

Own copies of the helpers the port needs from the reference's
``pointvs_tpu/utils.py``; ``get_logger`` is ``logging.get_logger``.
"""
from __future__ import annotations

import math
import os
import subprocess
from pathlib import Path
from typing import Any

import numpy as np
import yaml

from pointvs_tpu_torch.logging import get_logger  # noqa: F401 (re-export)


def expand_path(*paths) -> Path:
    """Expand ~ and environment variables; return an absolute Path."""
    return Path(os.path.expandvars(
        Path(*[str(p) for p in paths]).expanduser())).absolute()


def shorten_home(path) -> Path:
    """The home directory prefix replaced by ``~``, for display."""
    home = str(Path.home())
    path = str(Path(path))
    if path.startswith(home):
        return Path('~' + path[len(home):])
    return Path(path)


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


def find_latest_checkpoint(root, model_task: str = '') -> Path:
    """Newest ``<model_task>*ckpt_epoch_*`` entry under <root>/checkpoints
    or <root>, by modification time then name."""
    root = expand_path(root)
    for candidate_dir in (root / 'checkpoints', root):
        if not candidate_dir.is_dir():
            continue
        ckpts = list(candidate_dir.glob(f'{model_task}*ckpt_epoch_*'))
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


def format_time(t) -> str:
    """Seconds -> ``HH:MM:SS`` (``--:--:--`` when unknown)."""
    if t is None or (isinstance(t, float) and (math.isnan(t) or t < 0)):
        return '--:--:--'
    t = int(t)
    return f'{t // 3600:02d}:{(t % 3600) // 60:02d}:{t % 60:02d}'


def truncate_float(x: float, decimals: int = 3) -> float:
    """Truncate (not round) a float to a number of decimal places."""
    factor = 10 ** decimals
    return math.trunc(x * factor) / factor


def coords_to_string(coords, eps: float = 1e-3) -> str:
    """Coordinates truncated onto an ``eps`` grid, as a string key."""
    if isinstance(coords, str):
        coords = [float(c) for c in coords.split()]
    decimals = max(0, int(round(-math.log10(eps))))
    return ' '.join(f'{truncate_float(float(c), decimals):.{decimals}f}'
                    for c in np.asarray(coords).reshape(-1))


class PositionDict(dict):
    """A dict keyed by 3D coordinates, truncated to an ``eps`` grid so
    that nearby coordinates find one entry (attribution maps scores back
    onto structure-file atoms by position)."""

    def __init__(self, *args, eps: float = 1e-3, **kwargs):
        self.eps = eps
        super().__init__(*args, **kwargs)

    def _key(self, coords) -> str:
        return coords_to_string(coords, eps=self.eps)

    def __setitem__(self, key, value):
        super().__setitem__(self._key(key), value)

    def __getitem__(self, key):
        return super().__getitem__(self._key(key))

    def __contains__(self, key):
        return super().__contains__(self._key(key))

    def get(self, key, default=None):
        return super().get(self._key(key), default)


def no_return_parallelise(func, *args, cpus: int | None = None) -> None:
    """Call ``func`` once per position of the list or tuple arguments
    (other arguments are passed to every call), over a process pool, or
    in this process with one CPU or one call."""
    import multiprocessing as mp
    lengths = [len(a) for a in args if isinstance(a, (list, tuple))]
    n = max(lengths) if lengths else 1
    calls = [tuple(a[i] if isinstance(a, (list, tuple)) else a
                   for a in args) for i in range(n)]
    cpus = cpus if cpus is not None else max(1, (os.cpu_count() or 1) - 1)
    if cpus <= 1 or n <= 1:
        for call in calls:
            func(*call)
        return
    with mp.Pool(processes=min(cpus, n)) as pool:
        pool.starmap(func, calls)


def execute_cmd(cmd: str, raise_exceptions: bool = True,
                silent: bool = False) -> subprocess.CompletedProcess:
    """Run a shell command with its output captured; raise
    ``CalledProcessError`` when it writes to stderr (unless
    ``raise_exceptions`` is off) and log its stdout (unless ``silent``)."""
    proc = subprocess.run(cmd, shell=True, capture_output=True)
    if proc.stderr and raise_exceptions:
        raise subprocess.CalledProcessError(
            returncode=proc.returncode, cmd=cmd, stderr=proc.stderr)
    if proc.stdout and not silent:
        get_logger().warning(proc.stdout.decode('utf-8'))
    return proc
