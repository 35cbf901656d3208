"""Content-addressed prefix cache (``repro.serving.prefix_cache``).

Serving traffic shares system prompts. In SLAY's linear-time regime a
prompt prefix is one constant-size (S, z) state snapshot, and chunked
prefill continues exactly from any chunk-boundary state, so the cache
stores batch=1 ``DecodeCache`` snapshots keyed by the sha256 of the
prompt-token prefix (an exact kind's rings; gemma2's union of windowed
rings and (S, z); an SSM config's SSD carry and conv tail, hymba's beside
its (S, z): every leaf of every layer, and each counts in an entry's
bytes):

* **Keying.** ``(length, sha256(int32 prefix bytes))``. The raw tokens
  are stored beside the snapshot and compared on lookup, so a digest
  collision can never false-hit (the digest function is injectable for
  that test). Proper-prefix entries are stored and served only at
  chunk-size multiples, which keeps the suffix's chunk schedule that of a
  cold prefill of the same prompt: cached and cold streams are
  byte-identical (the same fp operations in the same order).
* **Full-prompt entries** also carry the last-token logits, so a full hit
  skips prefill: the engine seeds the slot from the snapshot and samples
  token 0 from the stored logits (sampling is keyed on (seed, rid,
  index), never on how the state was produced).
* **Eviction.** LRU under ``capacity_bytes``; an entry referenced by a
  live request (``refs > 0``) is never evicted.

Entries are tensors on the engine's device. The decode kernel updates
the slot pool in place, so a snapshot never shares storage with the pool
or with a prefill cache that a later operation writes: ``insert`` clones.
The cache is a host-side object and can be shared across engines (a
warm-up engine populates, a measured one hits). Under a slot-sharded
pool every rank prefills each admission itself, so every rank holds the
same snapshots and seeds its own slots from them: no slot state crosses
ranks to save or restore an entry.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


def token_digest(tokens: np.ndarray) -> bytes:
    """sha256 over the canonical int32 little-endian token bytes."""
    a = np.ascontiguousarray(np.asarray(tokens, dtype="<i4"))
    return hashlib.sha256(a.tobytes()).digest()


def tree_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (``numel * element_size``)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tree_copy(tree):
    """A clone of every tensor, sharing no storage with ``tree``."""
    return tree_map(torch.clone, tree)


@dataclasses.dataclass
class PrefixEntry:
    length: int                       # tokens covered by this snapshot
    tokens: np.ndarray                # (length,) int32, the collision check
    cache: object                     # batch=1 DecodeCache snapshot
    logits: torch.Tensor | None       # (1, 1, V) last-token logits
    nbytes: int
    refs: int = 0                     # live requests seeded from this
    stamp: int = 0                    # LRU clock


class PrefixCache:
    """LRU-bounded, refcounted map: prompt-prefix hash -> state snapshot."""

    def __init__(self, capacity_bytes: int,
                 digest_fn: Callable[[np.ndarray], bytes] = token_digest):
        self.capacity_bytes = int(capacity_bytes)
        self._digest = digest_fn
        self._entries: dict[tuple[int, bytes], PrefixEntry] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.evictions = 0

    # -- bookkeeping -----------------------------------------------------

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- lookup ----------------------------------------------------------

    def lookup(self, tokens, *, chunk: int) -> PrefixEntry | None:
        """Longest cached prefix of ``tokens``, or None (counts a miss).

        Candidates: the full prompt, then chunk-size multiples descending
        (proper prefixes of other lengths are never served: the suffix's
        chunk schedule must be a cold prefill's). Tokens are compared
        outright on a digest match, so a collision cannot false-hit.
        """
        toks = np.asarray(tokens, np.int32).reshape(-1)
        n = len(toks)
        cands = [n]
        if chunk > 0:
            top = ((n - 1) // chunk) * chunk
            cands += list(range(top, 0, -chunk))
        for ln in cands:
            e = self._entries.get((ln, self._digest(toks[:ln])))
            if e is None or not np.array_equal(e.tokens, toks[:ln]):
                continue
            if ln == n and e.logits is None:
                # A full-length entry without logits cannot serve a full
                # hit (nothing to sample token 0 from): try the proper
                # prefixes instead.
                continue
            e.stamp = self._tick()
            self.hits += 1
            self.tokens_reused += ln
            return e
        self.misses += 1
        return None

    def acquire(self, entry: PrefixEntry) -> None:
        entry.refs += 1

    def release(self, entry: PrefixEntry) -> None:
        entry.refs = max(entry.refs - 1, 0)

    # -- insert / evict --------------------------------------------------

    def insert(self, tokens, cache, *, logits=None, copy: bool = True
               ) -> PrefixEntry | None:
        """Store a snapshot of the state after absorbing ``tokens``.

        ``copy=True`` clones the cache and logits (the engine's buffers
        are written again by later operations). Returns the entry, or
        None if it cannot fit the budget even after evicting every
        unreferenced entry. An existing key only refreshes its LRU stamp
        (the first snapshot wins: entries of one (length, digest) are
        byte-identical by construction), and gains the logits if it had
        none.
        """
        toks = np.asarray(tokens, np.int32).reshape(-1)
        key = (len(toks), self._digest(toks))
        if key in self._entries:
            e = self._entries[key]
            e.stamp = self._tick()
            if e.logits is None and logits is not None:
                # Upgrade a proper-prefix entry (stored without logits by
                # a longer prompt) into one that can serve a full hit.
                lg = logits.clone() if copy else logits
                e.logits = lg
                e.nbytes += tree_bytes(lg)
            return e
        if copy:
            cache = tree_copy(cache)
            logits = None if logits is None else logits.clone()
        nbytes = tree_bytes(cache) + (0 if logits is None
                                      else tree_bytes(logits))
        if not self._make_room(nbytes):
            return None
        e = PrefixEntry(len(toks), toks.copy(), cache, logits, nbytes,
                        stamp=self._tick())
        self._entries[key] = e
        return e

    def _make_room(self, nbytes: int) -> bool:
        if self.capacity_bytes <= 0:
            return False
        while self.nbytes + nbytes > self.capacity_bytes:
            victims = [e for e in self._entries.values() if e.refs == 0]
            if not victims:
                return False
            victim = min(victims, key=lambda e: e.stamp)
            for k, v in list(self._entries.items()):
                if v is victim:
                    del self._entries[k]
                    self.evictions += 1
                    break
        return True

    # -- durability / audit ----------------------------------------------

    def entries(self) -> list[PrefixEntry]:
        """Live entries in LRU-stamp order; the engine checkpoint persists
        the cache index from this."""
        return sorted(self._entries.values(), key=lambda e: e.stamp)

    def live_refs(self) -> int:
        """Refcount over all entries. The engine's debug audit asserts it
        equals the engine's live per-request pins at the end of every
        ``run()``: a leaked pin would block eviction for good."""
        return sum(e.refs for e in self._entries.values())

    # -- metrics ---------------------------------------------------------

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"entries": len(self), "bytes": self.nbytes,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate(),
                "tokens_reused": self.tokens_reused,
                "evictions": self.evictions}
