"""JAX's threefry random keys and flax's dropout rngs, on the host.

The port's own copy of the integer semantics behind the reference
package's random draws, so that a training run of the port drops the
edges and entries that the reference drops at every step. The bits depend
on the versions the reference runs with: jax 0.9.0 with
``jax_threefry_partitionable`` True (its default) and flax 0.12.3.

- ``threefry2x32``: the Threefry-2x32 block (20 rounds), on uint32 arrays.
- ``prng_key(seed)``, ``split``, ``fold_in``: ``jax.random.PRNGKey``,
  ``split`` and ``fold_in`` on raw uint32[2] keys. Partitionable threefry
  hashes the two 32-bit halves of each output's flat index, so
  ``split(key, n)[i]`` is ``fold_in(key, i)``.
- ``random_bits``: ``jax.random.bits`` at 32 bits (the two output words
  xor'd); ``randint_scalar``: ``jax.random.randint(key, (), lo, hi)`` for
  int32, which draws two such words from the key's split and reduces them
  in uint32 arithmetic, wrap-around included.
- ``uniform`` and ``bernoulli``: ``jax.random.uniform`` / ``bernoulli``
  in float32 (23 mantissa bits of each word) or float64 (52 bits of the
  64-bit draw); ``normal``: ``jax.random.normal`` in float32, a uniform
  draw on (nextafter(-1, 0), 1) mapped by ``sqrt(2) * erfinv``, with
  XLA's float32 inverse error function (Giles' two polynomials of
  degree 8), so the draws agree with JAX's within an ulp or two.
- ``fold_in`` and ``normal`` take a stack of keys ([..., 2]) as well as
  one key: each row is drawn under its own key.
- ``make_rng(key, path)``: flax's ``Module.make_rng``: its ``LazyRng``
  folds the scope path's names and the scope's call counter into the key
  through the first 4 bytes of their SHA-1 (``flax/core/scope.py``
  ``_fold_in_static``; no separators, flax's default).

``step_rng`` is the reference Trainer's key for one training step and
``step_key`` its fold with one device's index; ``egnn_edge_dropout_seed``
and ``lucid_site_key`` derive from it the keys that the reference's EGNN
and lucid models draw their masks
from. All of it is numpy uint32 work, once a step; the lucid masks
themselves are drawn on the device (``ops/dropout.py``).
"""
from __future__ import annotations

import hashlib
from typing import Sequence, Tuple, Union

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
Key = np.ndarray   # uint32 [2]


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint32)


def threefry2x32(key: Key, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter words (x0, x1) under ``key``."""
    k0, k1 = _u32(key[0]), _u32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over='ignore'):
        x0 = _u32(x0) + ks[0]
        x1 = _u32(x1) + ks[1]
        for block in range(5):
            for r in _ROTATIONS[block % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x0 ^ x1
            x0 = x0 + ks[(block + 1) % 3]
            x1 = x1 + ks[(block + 2) % 3] + np.uint32(block + 1)
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: [0, seed mod 2**32]."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f'seed {seed} is not an int32')
    return _u32([0, seed & 0xFFFFFFFF])


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The high and low words of the flat indices 0..n-1."""
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: Key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: uint32 [num, 2]."""
    hi, lo = _counters(num)
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=1)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)`` (data taken mod 2**32). A key
    stack [..., 2] folds ``data`` into each key; an int array ``data``
    [n] under one key gives the [n, 2] keys."""
    key = _u32(key)
    data = np.asarray(data, dtype=np.int64)
    if key.ndim == 1 and data.ndim == 0:
        b0, b1 = threefry2x32(key, _u32([0]),
                              _u32([int(data) & 0xFFFFFFFF]))
        return np.concatenate([b0, b1])
    words = (data & 0xFFFFFFFF).astype(np.uint32)
    b0, b1 = threefry2x32((key[..., 0], key[..., 1]),
                          np.zeros_like(words), words)
    return np.stack([b0, b1], axis=-1)


def random_bits(key: Key, shape: Sequence[int] = ()) -> np.ndarray:
    """``jax.random.bits(key, shape)``: 32-bit words, one per entry."""
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def _random_bits64(key: Key, shape: Sequence[int]) -> np.ndarray:
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    b0, b1 = threefry2x32(key, hi, lo)
    return ((b0.astype(np.uint64) << np.uint64(32))
            | b1.astype(np.uint64)).reshape(shape)


def randint_scalar(key: Key, minval: int, maxval: int) -> int:
    """``int(jax.random.randint(key, (), minval, maxval))`` (int32)."""
    if not -2 ** 31 <= minval < maxval <= 2 ** 31 - 1:
        raise ValueError('randint_scalar takes int32 bounds with '
                         'minval < maxval')
    k_hi, k_lo = split(key, 2)
    higher, lower = random_bits(k_hi), random_bits(k_lo)
    span = _u32(maxval - minval)
    with np.errstate(over='ignore'):
        multiplier = _u32(2 ** 16) % span
        multiplier = (multiplier * multiplier) % span
        offset = ((higher % span) * multiplier + lower % span) % span
    return minval + int(offset)


def uniform(key: Key, shape: Sequence[int] = (),
            dtype=np.float32) -> np.ndarray:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1)."""
    if np.dtype(dtype) == np.float32:
        bits = (random_bits(key, shape) >> np.uint32(9)) | _u32(0x3F800000)
        return bits.view(np.float32) - np.float32(1.0)
    if np.dtype(dtype) == np.float64:
        bits = ((_random_bits64(key, shape) >> np.uint64(12))
                | np.uint64(0x3FF0000000000000))
        return bits.view(np.float64) - 1.0
    raise ValueError(f'uniform takes float32 or float64, got {dtype}')


# XLA's float32 erfinv: Giles, "Approximating the erfinv function" (2010),
# for w = -log1p(-x^2) below 5 and at or above it.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """The inverse error function in float32, as XLA computes it on
    (-1, 1)."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, np.float32(_ERFINV_W_LT_5[0]),
                 np.float32(_ERFINV_W_GE_5[0])).astype(np.float32)
    for lt5, ge5 in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = (np.where(small, np.float32(lt5), np.float32(ge5))
             + p * w).astype(np.float32)
    return p * x


def normal(key: Key, shape: Sequence[int] = ()) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32. ``key`` may be a stack
    [n, 2]: row i of the [n, *shape] result is drawn under key i."""
    key = _u32(key)
    stacked = key.ndim == 2
    count = int(np.prod(shape, dtype=np.int64))
    hi, lo = _counters(count)
    if stacked:
        b0, b1 = threefry2x32((key[:, :1], key[:, 1:]), hi, lo)
        out_shape = (key.shape[0],) + tuple(shape)
    else:
        b0, b1 = threefry2x32(key, hi, lo)
        out_shape = tuple(shape)
    bits = ((b0 ^ b1) >> np.uint32(9)) | _u32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    low = np.nextafter(np.float32(-1.0), np.float32(0.0))
    uniform_draw = np.maximum(
        low, floats * (np.float32(1.0) - low) + low).astype(np.float32)
    return (np.float32(np.sqrt(2.0)) * erfinv_f32(uniform_draw)).reshape(
        out_shape)


def bernoulli(key: Key, p: float, shape: Sequence[int],
              dtype=np.float32) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` with p of ``dtype``."""
    return uniform(key, shape, dtype) < np.asarray(p, dtype)


def _static_hash(parts: Sequence[Union[str, int]]) -> int:
    """The uint32 that flax's ``_fold_in_static`` folds in for ``parts``."""
    digest = hashlib.sha1()
    for part in parts:
        if isinstance(part, str):
            digest.update(part.encode('utf-8'))
        elif isinstance(part, int):
            digest.update(part.to_bytes((part.bit_length() + 7) // 8,
                                        byteorder='big'))
        else:
            raise ValueError(f'expected int or str, got {part!r}')
    return int.from_bytes(digest.digest()[:4], byteorder='big')


def make_rng(key: Key, path: Sequence[str] = (), counter: int = 1) -> Key:
    """flax's ``make_rng`` in the scope at ``path`` (module names from the
    root) whose rng collection holds ``key``, on its ``counter``-th call."""
    return fold_in(key, _static_hash(tuple(path) + (int(counter),)))


def step_rng(seed: int, global_iter: int) -> Key:
    """The reference Trainer's key for one step, before the step folds in
    the device index: ``fold_in(split(PRNGKey(seed))[1], global_iter)``."""
    return fold_in(split(prng_key(seed), 2)[1], global_iter)


def step_key(seed: int, global_iter: int, device_index: int = 0) -> Key:
    """The reference Trainer's dropout key for one step on one device:
    ``fold_in(step_rng(seed, global_iter), axis)``."""
    return fold_in(step_rng(seed, global_iter), device_index)


def egnn_edge_dropout_seed(key: Key) -> int:
    """The uint32 edge-dropout seed that the reference's EGNN draws in a
    training forward given ``rngs={'dropout': key}``: ``randint(make_rng(
    'dropout'), (), 0, int32 max)`` in the model's root scope."""
    return randint_scalar(make_rng(key, ()), 0, 2 ** 31 - 1)


# The lucid layer's dropout sites: after the first Linear of the edge MLP
# and of the coordinate MLP (flax's ``MLP`` names its Dropout
# ``Dropout_0``), and after the node MLP's first Linear (an unnamed
# ``nn.Dropout`` in the layer's own scope, which flax names ``Dropout_0``).
LUCID_SITES = {'edge': ('edge_mlp', 'Dropout_0'),
               'coors': ('coors_mlp', 'Dropout_0'),
               'node': ('Dropout_0',)}


def lucid_site_key(key: Key, layer: int, site: str, num_layers: int,
                   scan_layers: bool) -> Key:
    """The key of one lucid dropout site in layer ``layer``. Unscanned
    layers are the scopes ``lucid_layer_<i>``. Under ``nn.scan``
    (``scan_layers``) every layer is the scope ``lucid_scan``, its rng is
    the layer's row of ``split(key, num_layers)``, and each Dropout scope
    makes its rng on its second call: flax traces the scan body twice
    (once for the carry's shape) and the scope's counter persists."""
    if scan_layers:
        return make_rng(split(key, num_layers)[layer],
                        ('lucid_scan',) + LUCID_SITES[site], counter=2)
    return make_rng(key, (f'lucid_layer_{layer}',) + LUCID_SITES[site])
