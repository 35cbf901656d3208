"""Atomic engine checkpoints for crash-safe serving
(``repro.serving.checkpoint``; DESIGN.md §12).

A checkpoint holds what the journal does not: the slot pool's decode
state, the host slot mirrors, which rid is resident in which slot, and
the prefix-cache index. ``restore`` loads the latest valid checkpoint,
then replays the journal to rebuild queued requests and to deduplicate
tokens already emitted.

File format, the JAX package's::

    magic (8B) | version u32 | payload_len u64 | sha256(payload) 32B | payload

The payload is a pickled dict of numpy arrays and builtins, never a
torch tensor, with the JAX package's keys: the pool as a list of leaves
in ``jax.tree.leaves`` order (SLAY ``attn.pos, attn.s, attn.z, pos``;
an exact kind ``attn.k, attn.v, attn.pos, pos``, and paged the page
tables ``table, owner_slot, owner_lp`` after them; gemma2's union pool
under SLAY ``attn.k, attn.v, attn.pos, attn.s, attn.z, pos``, every
layer's leaves whichever its kind; mamba2 ``ssm.h, ssm.conv, pos``;
hymba under SLAY ``attn.pos, attn.s, attn.z, ssm.h, ssm.conv, pos``;
whisper's ``WhisperCache`` under SLAY ``self_attn.pos, self_attn.s,
self_attn.z, cross_s, cross_z, pos``, under an exact kind
``self_attn.k, self_attn.v, self_attn.pos, cross_s, cross_z, pos``),
``page_size`` and
the ``page_pool`` allocator snapshot (None unpaged), and in speculative
mode the draft pool's leaves (``draft_pool``, the SLAY order; None
otherwise) with ``speculative`` and ``spec_gamma``. So a directory
written by either package is one format.
numpy has no bfloat16 without ``ml_dtypes``, which the port does not
import: a bfloat16 tensor (a ring leaf, the last-token logits of a
prefix entry) is written as the JAX writer writes it, a numpy array
whose dtype names the global ``ml_dtypes.bfloat16`` over the tensor's
16-bit words (:func:`dumps`), and read back through those words, widened
to float32 (exact) and marked as bfloat16 (:class:`Bf16Array`); the
engine casts it back on restore.

Writes are atomic: tmp file, fsync, ``os.replace``, directory fsync.
``latest_valid`` scans ``ckpt-*.ckpt`` newest first and skips a file
whose header, checksum or contents fail, so a crash mid-checkpoint falls
back to the previous checkpoint, or to recovery from the journal alone.
"""
from __future__ import annotations

import hashlib
import io
import os
import pickle
import re
import struct

import numpy as np
import torch

from repro_torch.tree import tree_leaves

MAGIC = b"SLAYCKPT"
CKPT_VERSION = 1
_HEADER = struct.Struct("<8sIQ")
_CKPT_RE = re.compile(r"^ckpt-(\d+)\.ckpt$")

# The only globals a payload may name: numpy's array and dtype
# reconstruction (its module moved in numpy 2), and the bfloat16 type of
# ml_dtypes, which a JAX-written payload names and which is read as its
# uint16 bits.
_NUMPY_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype"),
                  ("numpy.core.multiarray", "_reconstruct"),
                  ("numpy._core.multiarray", "_reconstruct")}
_BF16 = ("ml_dtypes", "bfloat16")


class CheckpointError(RuntimeError):
    """Raised when a checkpoint file fails header/checksum validation."""


class _Unpickler(pickle.Unpickler):
    """Loads numpy arrays and builtins only; nothing else is constructed."""

    def find_class(self, module, name):
        if (module, name) == _BF16:
            return np.uint16
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint payload names {module}.{name}, which is neither a "
            f"numpy array nor a builtin")


class Bf16Array(np.ndarray):
    """A bfloat16 leaf read back: the float32 it encodes (exact), marked
    so that :func:`leaf_matches` takes it for a bfloat16 tensor."""


def _widen_bf16(node):
    """Replace every uint16 array (a bfloat16 leaf's bits; the format has
    no uint16 leaf of its own) by the float32 it encodes."""
    if isinstance(node, dict):
        return {k: _widen_bf16(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_widen_bf16(v) for v in node]
    if isinstance(node, np.ndarray) and node.dtype == np.uint16:
        return ((node.astype(np.uint32) << 16).view(np.float32)
                .view(Bf16Array))
    return node


class Bf16Words:
    """A bfloat16 leaf on the host: its 16-bit words, ``(...,)`` uint16.
    :func:`dumps` writes it as an ``ml_dtypes.bfloat16`` array."""

    def __init__(self, words: np.ndarray):
        self.words = words


class _BF16Type:
    """Stands in for ``ml_dtypes.bfloat16`` while pickling: written as
    that global, never imported."""


_BF16_DTYPE = object()    # stands in for numpy.dtype(ml_dtypes.bfloat16)
# numpy.dtype(ml_dtypes.bfloat16).__reduce__()'s state: byte order, no
# subarray, names or fields, item size 2, alignment 2, flags 64.
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


class _Pickler(pickle._Pickler):
    """The payload pickler: protocol 4, and a :class:`Bf16Words` leaf as
    ``pickle.dumps`` writes an ``ml_dtypes.bfloat16`` array, opcode for
    opcode. The standard library's pure-Python pickler, because the C
    pickler imports a global's module to check it (``save_global``) and
    ``ml_dtypes`` is not there; the large leaves' bytes are written by the
    same buffer copies either way."""

    def reducer_override(self, obj):
        if isinstance(obj, Bf16Words):
            fn, args, (ver, shape, _, fortran, raw) = obj.words.__reduce__()
            return fn, args, (ver, shape, _BF16_DTYPE, fortran, raw)
        if obj is _BF16_DTYPE:
            return np.dtype, (_BF16Type, False, True), _BF16_DTYPE_STATE
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is not _BF16Type:
            return super().save_global(obj, name)
        # pickle._Pickler.save_global at protocol 4, less the import.
        self.save(_BF16[0])
        self.save(_BF16[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)
        return None


def dumps(state) -> bytes:
    """The checkpoint payload: ``state`` pickled at protocol 4, each
    :class:`Bf16Words` leaf as the JAX writer's bfloat16 array."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=4).dump(state)
    return buf.getvalue()


def to_numpy(t: torch.Tensor):
    """A host copy of ``t`` as numpy; bfloat16 as :class:`Bf16Words`."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return Bf16Words(t.view(torch.int16).numpy().view(np.uint16))
    return t.numpy()


def leaf_matches(t: torch.Tensor, a) -> bool:
    """Whether the numpy leaf ``a`` has the shape and dtype of ``t`` (a
    :class:`Bf16Array` counting as bfloat16)."""
    if not (isinstance(a, np.ndarray) and tuple(t.shape) == a.shape
            and a.dtype.kind in "biuf"):
        return False
    if isinstance(a, Bf16Array):
        return t.dtype == torch.bfloat16
    return torch.from_numpy(np.empty(0, a.dtype)).dtype == t.dtype


def checkpoint_path(directory: str, tick: int) -> str:
    return os.path.join(directory, f"ckpt-{tick:012d}.ckpt")


def save(path: str, state: dict) -> None:
    """Atomically write ``state`` to ``path`` (tmp + rename + fsync)."""
    payload = dumps(state)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(MAGIC, CKPT_VERSION, len(payload)))
        f.write(hashlib.sha256(payload).digest())
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def load(path: str) -> dict:
    """Load and validate one checkpoint file; raises CheckpointError."""
    with open(path, "rb") as f:
        blob = memoryview(f.read())
    if len(blob) < _HEADER.size + 32:
        raise CheckpointError(f"{path}: truncated header")
    magic, version, plen = _HEADER.unpack_from(blob)
    if magic != MAGIC:
        raise CheckpointError(f"{path}: bad magic {magic!r}")
    if version != CKPT_VERSION:
        raise CheckpointError(f"{path}: unsupported version {version}")
    digest = bytes(blob[_HEADER.size:_HEADER.size + 32])
    payload = blob[_HEADER.size + 32:]
    if len(payload) != plen:
        raise CheckpointError(f"{path}: payload length {len(payload)} != {plen}")
    if hashlib.sha256(payload).digest() != digest:
        raise CheckpointError(f"{path}: checksum mismatch")
    state = _Unpickler(io.BytesIO(payload)).load()
    if not isinstance(state, dict):
        raise CheckpointError(f"{path}: payload is not a state dict")
    return _widen_bf16(state)


def list_checkpoints(directory: str) -> list[tuple[int, str]]:
    """All checkpoint files in ``directory`` as (tick, path), newest first."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def latest_valid(directory: str) -> dict | None:
    """Newest checkpoint that passes validation, or None."""
    for _tick, path in list_checkpoints(directory):
        try:
            return load(path)
        except (CheckpointError, OSError, pickle.UnpicklingError, EOFError):
            continue  # corrupt or torn checkpoint: fall back to an older one
    return None


def snapshot_engine(eng) -> dict:
    """The checkpoint state dict of a live engine.

    Mid-prefill state is not captured: a request whose chunked prefill is
    in flight re-admits from its journaled admission at restore (the same
    chunk schedule, the same stream), so a paged pool's snapshot has that
    slot's pages freed, in a clone of the allocator.
    """
    inflight_slot = eng._prefill.slot if eng._prefill is not None else None
    page_snap = None
    pp = eng.page_pool
    if pp is not None:
        if inflight_slot is not None and pp.slot_pages(inflight_slot):
            clone = type(pp)(pp.num_slots, pp.num_pages, pp.page_size,
                             pp.pages_per_slot, shards=pp.shards)
            clone.load_snapshot(pp.snapshot())
            clone.free_slot(inflight_slot)
            page_snap = clone.snapshot()
        else:
            page_snap = pp.snapshot()
    slots = {int(slot): int(rec.rid) for slot, rec in eng.sched.active.items()
             if slot != inflight_slot}
    prefix_entries = None
    if eng.prefix_cache is not None:
        prefix_entries = [
            {"tokens": np.asarray(ent.tokens, np.int32),
             "length": int(ent.length),
             "cache": [to_numpy(x) for x in tree_leaves(ent.cache)],
             "logits": (to_numpy(ent.logits) if ent.logits is not None
                        else None)}
            for ent in eng.prefix_cache.entries()]
    return {
        "version": CKPT_VERSION,
        "tick": int(eng.tick),
        "next_rid": int(eng._next_rid),
        "num_slots": int(eng.serving.num_slots),
        "max_len": int(eng.serving.max_len),
        "page_size": int(eng.serving.page_size) if pp is not None else 0,
        "seed": int(eng.serving.seed),
        "speculative": bool(eng._spec),
        "spec_gamma": int(eng.serving.spec_gamma) if eng._spec else 0,
        # The whole pool: a sharded engine gathers every rank's block.
        "pool": eng._whole_leaves(eng.pool, eng.cfg),
        # The draft pool is live decode state too: a resident slot resumed
        # without it would draft from zeros (other proposals, so other
        # sampled streams and a lower acceptance rate).
        "draft_pool": (eng._whole_leaves(eng.draft_pool, eng.draft_cfg)
                       if eng._spec else None),
        "mirrors": {
            "last_tok": eng._last_tok.copy(),
            "active": eng._active.copy(),
            "rids": eng._rids.copy(),
            "gen": eng._gen.copy(),
            "eos": eng._eos.copy(),
            "maxn": eng._maxn.copy(),
        },
        "slots": slots,
        "page_pool": page_snap,
        "prefix": prefix_entries,
    }
