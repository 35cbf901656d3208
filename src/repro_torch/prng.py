"""Counter-based random numbers, bit for bit as ``jax.random`` draws them.

The serving engines key every sampled token on threefry2x32 keys
(``repro.serving.sampling``), so a port that samples the same streams
must produce the same bits. This module is the part of ``jax.random``
that serving uses, as jax 0.9.0 computes it with 64-bit mode off and
``jax_threefry_partitionable`` on (its default):

* :func:`threefry2x32`, the 20-round hash (``jax/_src/prng.py``
  ``_threefry2x32_lowering``);
* :func:`PRNGKey`, :func:`fold_in` and :func:`split` (``_threefry_seed``,
  ``_threefry_fold_in``, ``_threefry_split_foldlike``);
* :func:`random_bits`, 32-bit words (``_threefry_random_bits_partitionable``:
  the hash of the 64-bit counter ``(0, i)``, its two words xor-ed);
* :func:`uniform`, :func:`gumbel` (mode "low") and :func:`categorical`
  (``jax/_src/random.py``: ``_uniform``, ``_gumbel``, ``categorical``).

A key is a numpy ``uint32`` array ``(..., 2)`` on the host, or a torch
``int64`` tensor ``(..., 2)`` holding the two words on any device. The
arithmetic is one routine for both: ``int64`` lanes masked to 32 bits.
Leading key dimensions batch (as ``jax.vmap`` over keys would), so
``gumbel(keys, (V,))`` with ``keys`` of shape ``(S, 2)`` is ``(S, V)``.
Results are torch tensors when the key or the data is one, or when a
``device`` is given, and numpy arrays otherwise. One numpy key is taken
as two Python ints, so it enters torch arithmetic on the card with no
host-to-device copy.

Floats: :func:`uniform` builds each value from random mantissa bits as jax
does, so the words match exactly; :func:`gumbel`'s two logarithms are the
backend's own, which may differ from XLA's in the last bit or so.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key words (k0, k1): int64 lanes holding uint32 values (numpy arrays,
    torch tensors or Python ints, broadcast together) -> (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _is_torch(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


def _lanes(x):
    """A key or counter as int64 lanes; one numpy key as two Python ints."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    x = np.asarray(x)
    if x.ndim == 0:
        return int(x) & MASK
    return x.astype(np.int64) & MASK


def _key_words(key):
    key = _lanes(key)
    if isinstance(key, np.ndarray) and key.shape == (2,):
        return int(key[0]), int(key[1])
    return key[..., 0], key[..., 1]


def _as_key(y0, y1, to_torch: bool):
    if to_torch:
        return torch.stack((y0, y1), -1)
    return np.stack((y0, y1), -1).astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (jax's name)
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the words
    ``(0, seed mod 2**32)`` (the seed is cast to a 32-bit integer)."""
    return np.array([0, int(seed) & MASK], np.uint32)


def fold_in(key, data):
    """``jax.random.fold_in``: the hash of the counter ``(0, data)`` under
    ``key``. ``data`` (int, array or tensor, wrapped to 32 bits) batches
    against the key's leading dimensions."""
    k0, k1 = _key_words(key)
    d = _lanes(data)
    y0, y1 = threefry2x32(k0, k1, 0, d)
    return _as_key(y0, y1, _is_torch(key, data))


def split(key, num: int = 2):
    """``jax.random.split(key, num)``: ``(..., num, 2)`` keys, key i the
    hash of the counter ``(0, i)``."""
    k0, k1 = _key_words(key)
    i = _iota((num,), key, None)
    y0, y1 = threefry2x32(_expand(k0, 1), _expand(k1, 1), 0, i)
    return _as_key(y0, y1, _is_torch(key))


def _expand(lane, n: int):
    """Add ``n`` trailing axes to a key lane (not to a Python int)."""
    if isinstance(lane, int):
        return lane
    return lane.reshape(*lane.shape, *([1] * n))


def _iota(shape, key, device):
    """``0 .. prod(shape) - 1`` laid out as ``shape``, int64, on the key's
    backend (or ``device``)."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("more than 2**32 random words per key")
    if isinstance(key, torch.Tensor):
        device = key.device
    if device is not None:
        return torch.arange(n, dtype=torch.int64,
                            device=device).reshape(shape)
    return np.arange(n, dtype=np.int64).reshape(shape)


def _to_device(key, device):
    if device is not None and not isinstance(key, torch.Tensor):
        key = np.asarray(key)
        if key.shape != (2,):
            key = torch.as_tensor(key.astype(np.int64), device=device)
    return key


def random_bits(key, shape, *, device=None):
    """32-bit words ``(..., *shape)``: ``jax.random.bits(key, shape)``.
    numpy ``uint32``, or torch ``int64`` holding the words."""
    shape = tuple(shape)
    key = _to_device(key, device)
    k0, k1 = _key_words(key)
    i = _iota(shape, key, device)
    n = len(shape)
    y0, y1 = threefry2x32(_expand(k0, n), _expand(k1, n), 0, i)
    bits = y0 ^ y1
    if isinstance(bits, torch.Tensor):
        return bits
    return bits.astype(np.uint32)


# (total bits, mantissa bits, bit pattern of 1.0, same-width int type).
_FLOATS = {torch.float32: (32, 23, 0x3F800000, torch.int32),
           torch.bfloat16: (16, 7, 0x3F80, torch.int16)}


def uniform(key, shape, dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0, *, device=None):
    """``jax.random.uniform``: random mantissa bits under the exponent of
    1.0, minus 1, scaled to [minval, maxval), in ``dtype`` (float32 or
    bfloat16) throughout. numpy results are float32 only."""
    nbits, nmant, one, ity = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, device=device)
    if rng_bits < 32:                       # jax truncates the words
        bits = bits & ((1 << rng_bits) - 1)
    fbits = (bits >> (rng_bits - nmant)) | one
    if isinstance(fbits, torch.Tensor):
        f = fbits.to(ity).view(dtype)
        lo = torch.full((), minval, dtype=dtype, device=f.device)
        hi = torch.full((), maxval, dtype=dtype, device=f.device)
        return torch.maximum(lo, (f - 1.0) * (hi - lo) + lo)
    if dtype != torch.float32:
        raise TypeError(f"numpy uniform takes float32 only, not {dtype}")
    f = fbits.astype(np.uint32).view(np.float32)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, (f - np.float32(1.0)) * (hi - lo) + lo)


def gumbel(key, shape, dtype: torch.dtype = torch.float32, *, device=None):
    """``jax.random.gumbel`` (mode "low"): -log(-log(u)), u uniform on
    [tiny, 1) in ``dtype``."""
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0,
                device=device)
    if isinstance(u, torch.Tensor):
        return -torch.log(-torch.log(u))
    return -_log32(-_log32(u))


def _log32(x: np.ndarray) -> np.ndarray:
    """float32 log rounded from float64: numpy's own float32 log is up to
    3 ulp off, this one agrees with torch's almost everywhere."""
    return np.log(x.astype(np.float64)).astype(np.float32)


def categorical(key, logits, axis: int = -1):
    """``jax.random.categorical(key, logits, axis)`` with one key for the
    whole array: argmax of ``gumbel(key, logits.shape) + logits`` with
    the noise in the logits' dtype, first index on ties."""
    if isinstance(logits, torch.Tensor):
        g = gumbel(key, logits.shape, logits.dtype, device=logits.device)
        return torch.argmax(g + logits, dim=axis)
    logits = np.asarray(logits, np.float32)
    return np.argmax(gumbel(key, logits.shape) + logits, axis=axis)
