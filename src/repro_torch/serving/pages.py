"""Paged slot memory: a page-table layer under the serving slot pool
(``repro.serving.pages``; DESIGN.md §11).

Unpaged, every slot of the pool reserves ``kv_len`` ring rows up front,
so a short chat request pays the memory of a long one. Paged, the KV
ring leaves of the pooled decode cache are split into fixed-size pages
drawn from one shared physical pool::

    unpaged kv leaf   (nl, S, kv_len, Hkv, dh)
    paged kv leaf     (nl, P, page,   Hkv, dh)     P * page <= S * kv_len

:class:`PagePool` (host) owns the free list and the per-slot page
tables; :class:`PageState` (device) is their mirror, three int32
tensors inside ``DecodeCache``. Admission allocates ``ceil(need /
page)`` pages, ``need`` being the request's context horizon (prompt +
max_new), so short requests leave pages free for long ones.

Byte identity: the decode step gathers a layer's pages into the dense
``(S, kv_len, ...)`` ring the unpaged path uses, runs the unchanged ring
update on it, and scatters the owned pages back. Unmapped table entries
gather as zeros, which is what an unpaged reset ring holds, so paged and
unpaged streams are the same by construction.

Every device op here but :func:`gather_ring` writes into the leaf it is
given, never a new tensor, and the engine updates a ``PageState``'s
tensors with ``copy_``: the pool stays one set of tensors for the
engine's life, which the serving CUDA graphs bind. Sharded (DESIGN.md
§8), the pool of rank k holds its slot block and its block of P/N
pages, and its page tables are that block's, in its own ids
(:meth:`PagePool.device_vectors` with ``shard``): the host allocator
gives a slot only pages of its own shard's block, so a slot reads and
writes only its own shard's pages, and every device op here runs
unchanged on the rank's block. With one shard a page id is global.

SLAY's (S, z) is O(1) in context and is never paged (the paper's point).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PageState(NamedTuple):
    """The device page tables.

    table      (S, Lp) int32   page id of slot s's logical page j, -1 unmapped
    owner_slot (P,)    int32   slot owning physical page p, -1 if free
    owner_lp   (P,)    int32   logical index of page p within its owner
    """

    table: torch.Tensor
    owner_slot: torch.Tensor
    owner_lp: torch.Tensor


def init_state(num_slots: int, num_pages: int, pages_per_slot: int, *,
               device: torch.device | str = "cpu") -> PageState:
    """An all-free PageState: every table entry unmapped."""
    def full(*shape):
        return torch.full(shape, -1, dtype=torch.int32, device=device)

    return PageState(full(num_slots, pages_per_slot), full(num_pages),
                     full(num_pages))


def install(dst: PageState, src: PageState) -> PageState:
    """Copy ``src`` (any device; tensors or numpy) into ``dst``'s tensors,
    in place; returns ``dst``."""
    for d, s in zip(dst, src):
        d.copy_(torch.as_tensor(s))
    return dst


def _bcast(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


def gather_ring(leaf: torch.Tensor, state: PageState) -> torch.Tensor:
    """One paged ring leaf as its dense unpaged layout (a new tensor).

    leaf (P, page, *tail) -> (S, Lp*page, *tail); unmapped logical pages
    read as zeros (the unpaged pool's reset rows).
    """
    P, page = leaf.shape[0], leaf.shape[1]
    tail = leaf.shape[2:]
    S, Lp = state.table.shape
    tbl = state.table.long()
    rows = (tbl.clamp(0, P - 1)[..., None] * page
            + torch.arange(page, device=leaf.device))     # (S, Lp, page)
    out = leaf.reshape((P * page,) + tail)[rows.reshape(-1)]
    ok = (tbl >= 0)[..., None].expand(S, Lp, page).reshape(-1)
    out = torch.where(_bcast(ok, out.dim()), out, 0).to(leaf.dtype)
    return out.reshape((S, Lp * page) + tail)


def scatter_ring_(leaf: torch.Tensor, dense: torch.Tensor,
                  state: PageState) -> torch.Tensor:
    """Write a dense ring leaf back into its pages, in place (the inverse
    of :func:`gather_ring`; the JAX package's ``scatter_ring`` returns a
    new leaf).

    dense (S, Lp*page, *tail) -> ``leaf`` (P, page, *tail). Rows not
    covered by an owned page are dropped (they are zeros by the gather
    contract); free pages keep their bytes.
    """
    P, page = leaf.shape[0], leaf.shape[1]
    tail = leaf.shape[2:]
    S, size = dense.shape[0], dense.shape[1]
    Lp = size // page
    own = state.owner_slot.long()
    rows = ((own.clamp(0, S - 1) * size
             + state.owner_lp.long().clamp(0, Lp - 1) * page)[:, None]
            + torch.arange(page, device=leaf.device))     # (P, page)
    vals = dense.reshape((S * size,) + tail)[rows.reshape(-1)]
    vals = vals.reshape((P, page) + tail)
    return torch.where(_bcast(own >= 0, leaf.dim()), vals, leaf, out=leaf)


def _mine(leaf: torch.Tensor, slot: int, state: PageState) -> torch.Tensor:
    """(1, P, 1...) bool: the pages of ``leaf`` (nl, P, ...) that
    ``slot`` owns."""
    return (state.owner_slot == slot).reshape(
        (1, leaf.shape[1]) + (1,) * (leaf.dim() - 2))


def write_slot_pages(leaf: torch.Tensor, src: torch.Tensor, slot: int,
                     state: PageState) -> torch.Tensor:
    """Install a batch-1 dense ring into the pages ``slot`` owns, in place.

    leaf (nl, P, page, *tail); src (nl, 1, Lp*page, *tail), a freshly
    prefilled request cache. Every owned page is overwritten whole, so a
    prior owner's bytes never leak.
    """
    nl, P, page = leaf.shape[0], leaf.shape[1], leaf.shape[2]
    tail = leaf.shape[3:]
    Lp = src.shape[2] // page
    vals = src[:, 0].reshape((nl, Lp, page) + tail)
    sel = vals[:, state.owner_lp.long().clamp(0, Lp - 1)]  # (nl, P, page, *)
    return torch.where(_mine(leaf, slot, state), sel.to(leaf.dtype), leaf,
                       out=leaf)


def corrupt_slot_pages(leaf: torch.Tensor, slot: int,
                       state: PageState) -> torch.Tensor:
    """NaN every page ``slot`` owns, in place (fault injection)."""
    return leaf.masked_fill_(_mine(leaf, slot, state), float("nan"))


def write_zero_pages(leaf: torch.Tensor, slot: int,
                     state: PageState) -> torch.Tensor:
    """Zero every page ``slot`` owns, in place (eviction, quarantine): a
    freed page hands its next owner zeros, never a prior slot's bytes (in
    particular never an injected NaN)."""
    return leaf.masked_fill_(_mine(leaf, slot, state), 0.0)


def rows_finite(leaf: torch.Tensor) -> torch.Tensor:
    """(nl, R) bool: whether every element of ``leaf``'s row [i, r] is
    finite, for a leaf (nl, R, ...). By the row's minimum and maximum,
    which a NaN makes NaN and an Inf infinite: one reduction, no
    elementwise copy of a large pool."""
    lo, hi = torch.aminmax(leaf.flatten(2), dim=-1)
    return torch.isfinite(lo) & torch.isfinite(hi)


def pages_finite(leaves, state: PageState, num_slots: int) -> torch.Tensor:
    """(S,) bool: True where every page the slot owns is finite in every
    leaf (nl, P, ...). A free page, which may hold a quarantined owner's
    NaN, counts against no slot."""
    okp = None
    for leaf in leaves:
        f = rows_finite(leaf).all(0)                               # (P,)
        okp = f if okp is None else okp & f
    slots = torch.arange(num_slots, device=okp.device, dtype=torch.int32)
    bad = (state.owner_slot[None, :] == slots[:, None]) & ~okp[None, :]
    return ~bad.any(-1)


# ---------------------------------------------------------------------------
# Host-side allocator
# ---------------------------------------------------------------------------


class PagePool:
    """Free-list page allocator with numpy mirrors of the device tables.

    Static geometry for the engine's life: ``num_pages`` physical pages
    of ``page_size`` rows, split into ``shards`` contiguous blocks aligned
    with the slot pool's shard blocks; a slot is only given pages of its
    own shard's block. All mutation is host-side and O(pages touched);
    the engine copies :meth:`device_vectors` into its device tables.
    """

    def __init__(self, num_slots: int, num_pages: int, page_size: int,
                 pages_per_slot: int, *, shards: int = 1):
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        if num_pages % max(shards, 1):
            raise ValueError(
                f"num_pages={num_pages} not divisible by shards={shards}")
        if num_slots % max(shards, 1):
            raise ValueError(
                f"num_slots={num_slots} not divisible by shards={shards}")
        self.num_slots = num_slots
        self.num_pages = num_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.shards = max(int(shards), 1)
        self._pn = num_pages // self.shards
        self._sd = num_slots // self.shards
        self.table = np.full((num_slots, pages_per_slot), -1, np.int32)
        self.owner_slot = np.full((num_pages,), -1, np.int32)
        self.owner_lp = np.full((num_pages,), -1, np.int32)
        # Per-shard sorted free lists (lowest page id first: deterministic).
        self.free: list[list[int]] = [
            list(range(d * self._pn, (d + 1) * self._pn))
            for d in range(self.shards)]
        self.pages_peak = 0

    # -- queries ---------------------------------------------------------

    def shard_of(self, slot: int) -> int:
        return slot // self._sd

    def pages_for(self, need_rows: int) -> int:
        """Pages that hold ``need_rows`` ring rows (at most a slot's
        table width)."""
        n = -(-max(int(need_rows), 1) // self.page_size)
        return min(n, self.pages_per_slot)

    def pages_in_use(self) -> int:
        return self.num_pages - sum(len(f) for f in self.free)

    def free_in_shard(self, shard: int) -> int:
        return len(self.free[shard])

    def can_alloc(self, slot: int, need_rows: int) -> bool:
        return self.pages_for(need_rows) <= len(self.free[
            self.shard_of(slot)])

    def slot_pages(self, slot: int) -> list[int]:
        return [int(p) for p in self.table[slot] if p >= 0]

    # -- mutation --------------------------------------------------------

    def alloc(self, slot: int, need_rows: int) -> list[int]:
        """Assign ``pages_for(need_rows)`` pages of its shard to ``slot``,
        which must hold none (admission is whole-slot)."""
        if self.table[slot].max(initial=-1) >= 0:
            raise RuntimeError(f"slot {slot} already holds pages")
        n = self.pages_for(need_rows)
        shard = self.shard_of(slot)
        if n > len(self.free[shard]):
            raise RuntimeError(
                f"shard {shard} has {len(self.free[shard])} free pages, "
                f"need {n}")
        got = self.free[shard][:n]
        del self.free[shard][:n]
        for j, p in enumerate(got):
            if self.owner_slot[p] >= 0:      # pragma: no cover — invariant
                raise RuntimeError(f"page {p} double-assigned")
            self.table[slot, j] = p
            self.owner_slot[p] = slot
            self.owner_lp[p] = j
        self.pages_peak = max(self.pages_peak, self.pages_in_use())
        return got

    def free_slot(self, slot: int) -> int:
        """Return all of ``slot``'s pages to its shard's free list."""
        shard = self.shard_of(slot)
        n = 0
        for j in range(self.pages_per_slot):
            p = int(self.table[slot, j])
            if p < 0:
                continue
            self.table[slot, j] = -1
            self.owner_slot[p] = -1
            self.owner_lp[p] = -1
            self.free[shard].append(p)
            n += 1
        self.free[shard].sort()
        return n

    def device_vectors(self, shard: int | None = None) -> PageState:
        """The mirrors as a PageState of CPU tensors (copies), for
        :func:`install`; with ``shard``, that shard's block only, in its
        own ids (its slots' table rows holding page ids counted from its
        first page, its pages' owners counted from its first slot): the
        tables of a rank's block of a sharded pool."""
        if shard is None:
            return PageState(torch.from_numpy(self.table.copy()),
                             torch.from_numpy(self.owner_slot.copy()),
                             torch.from_numpy(self.owner_lp.copy()))
        s0, p0 = shard * self._sd, shard * self._pn
        table = self.table[s0:s0 + self._sd]
        owner = self.owner_slot[p0:p0 + self._pn]
        return PageState(
            torch.from_numpy(np.where(table >= 0, table - p0, -1)),
            torch.from_numpy(np.where(owner >= 0, owner - s0, -1)),
            torch.from_numpy(self.owner_lp[p0:p0 + self._pn].copy()))

    # -- durability (DESIGN.md §12) --------------------------------------

    def snapshot(self) -> dict:
        """Plain-host copy of the allocator state for engine checkpoints
        (the JAX package's keys)."""
        return {
            "num_slots": self.num_slots,
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "pages_per_slot": self.pages_per_slot,
            "shards": self.shards,
            "table": self.table.copy(),
            "owner_slot": self.owner_slot.copy(),
            "owner_lp": self.owner_lp.copy(),
            "free": [list(f) for f in self.free],
            "pages_peak": int(self.pages_peak),
        }

    def load_snapshot(self, snap: dict) -> None:
        """Restore from :meth:`snapshot`; the geometry must match."""
        for k in ("num_slots", "num_pages", "page_size", "pages_per_slot",
                  "shards"):
            if int(snap[k]) != getattr(self, k):
                raise ValueError(
                    f"PagePool snapshot {k}={snap[k]} != {getattr(self, k)}")
        self.table = np.asarray(snap["table"], np.int32).copy()
        self.owner_slot = np.asarray(snap["owner_slot"], np.int32).copy()
        self.owner_lp = np.asarray(snap["owner_lp"], np.int32).copy()
        self.free = [sorted(int(p) for p in f) for f in snap["free"]]
        self.pages_peak = int(snap["pages_peak"])
        self.check()

    def check(self) -> None:
        """Invariant audit: free and owned pages partition the pool, the
        table and owner vectors agree, shard blocks are respected."""
        seen: set[int] = set()
        for d, fl in enumerate(self.free):
            for p in fl:
                assert d * self._pn <= p < (d + 1) * self._pn, (d, p)
                assert self.owner_slot[p] == -1, p
                assert p not in seen, p
                seen.add(p)
        for s in range(self.num_slots):
            for j in range(self.pages_per_slot):
                p = int(self.table[s, j])
                if p < 0:
                    continue
                d = self.shard_of(s)
                assert d * self._pn <= p < (d + 1) * self._pn, (s, p)
                assert self.owner_slot[p] == s, (s, j, p)
                assert self.owner_lp[p] == j, (s, j, p)
                assert p not in seen, p
                seen.add(p)
        assert len(seen) == self.num_pages, (len(seen), self.num_pages)
