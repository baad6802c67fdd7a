"""Named loggers with a stream handler and an optional ``output.log``.

Own copy of ``pointvs_tpu/logging.py``: the ``LOGLEVEL`` environment
variable sets the level, ``log_path`` adds a file handler writing
``<log_path>/output.log``, and pandas DataFrames and Series are rendered
as indented tables.
"""
from __future__ import annotations

import logging as _logging
import os
from pathlib import Path

_FORMAT = _logging.Formatter(
    '{asctime} [{levelname}] [{module}:{lineno}] {name}: {message}',
    '%Y:%m:%d %H:%M:%S', style='{')


class _DataFrameFilter(_logging.Filter):
    """Renders a pandas DataFrame or Series message as an indented table."""

    def filter(self, record):
        try:
            import pandas as pd
        except ImportError:
            return True
        if isinstance(record.msg, (pd.DataFrame, pd.Series)):
            body = record.msg.to_string().replace('\n', '\n\t')
            record.msg = f'--- DataFrame with contents ---\n\t{body}'
        return True


def get_logger(log_name: str = 'PointVS-TPU-torch', log_path=None,
               level=None) -> _logging.Logger:
    """Create or fetch a named logger; ``log_path`` points its file
    handler at ``<log_path>/output.log`` (a run's log holds only that run,
    also when one process runs several)."""
    logger = _logging.getLogger(log_name)
    logger.propagate = False
    level = level or os.environ.get('LOGLEVEL', 'INFO').upper()
    logger.setLevel(level)
    if not any(isinstance(f, _DataFrameFilter) for f in logger.filters):
        logger.addFilter(_DataFrameFilter())
    if not any(type(h) is _logging.StreamHandler for h in logger.handlers):
        handler = _logging.StreamHandler()
        handler.setFormatter(_FORMAT)
        handler.setLevel(level)
        logger.addHandler(handler)
    if log_path is not None:
        fname = str(Path(log_path, 'output.log').absolute())
        for h in list(logger.handlers):
            if isinstance(h, _logging.FileHandler) \
                    and h.baseFilename != fname:
                logger.removeHandler(h)
                h.close()
        if not any(isinstance(h, _logging.FileHandler)
                   for h in logger.handlers):
            fhandler = _logging.FileHandler(fname, mode='w',
                                            encoding='utf-8')
            fhandler.setFormatter(_FORMAT)
            fhandler.setLevel(level)
            logger.addHandler(fhandler)
    return logger
