"""Flat array-dict files for the ``--cache_dir`` graph cache (own copy of
``pointvs_tpu/data/blob.py``): the magic ``PVSB``, an 8-byte little-endian
header length, a JSON header of (name, dtype, shape), then the raw buffers
in header order. One ``read()`` loads a whole item."""
from __future__ import annotations

import json
from typing import Dict

import numpy as np

MAGIC = b'PVSB'


def save_blob(path, arrays: Dict[str, np.ndarray]) -> None:
    meta = [(k, a.dtype.str, list(a.shape)) for k, a in arrays.items()]
    hdr = json.dumps(meta).encode()
    with open(path, 'wb') as f:
        f.write(MAGIC)
        f.write(len(hdr).to_bytes(8, 'little'))
        f.write(hdr)
        for a in arrays.values():
            f.write(np.ascontiguousarray(a).tobytes())


def load_blob(path) -> Dict[str, np.ndarray]:
    with open(path, 'rb') as f:
        buf = f.read()
    if buf[:4] != MAGIC:
        raise ValueError(f'{path} is not a PVSB blob')
    hlen = int.from_bytes(buf[4:12], 'little')
    off = 12 + hlen
    out = {}
    for name, dtype_str, shape in json.loads(buf[12:off]):
        dt = np.dtype(dtype_str)
        count = int(np.prod(shape)) if shape else 1
        out[name] = np.frombuffer(buf, dtype=dt, count=count,
                                  offset=off).reshape(shape)
        off += out[name].nbytes
    return out
