"""Append-only write-ahead journal for crash-safe serving (DESIGN.md §12).

A copy of ``repro.serving.journal`` (no JAX inside): the same framing and
record types, so a journal written by either package reads in the other.

The journal is the source of truth for *request-level* state: which
requests were admitted (rid, prompt tokens + digest, deadlines), every
token emitted to a stream, fault retries, and terminations with their
typed finish_reason.  Together with a periodic engine checkpoint
(``serving/checkpoint.py``) it makes ``ContinuousServingEngine.restore``
deterministic: sampling is keyed on (seed, rid, token-index)
(``serving/sampling.py``), so any request replayed from its journaled
admission regenerates the *byte-identical* stream, and already-journaled
tokens are deduplicated against the regenerated ones instead of being
delivered twice.

Record framing — one record per line::

    <crc32 hex8> <json>\n

The CRC covers the JSON payload bytes.  A torn write at crash time can
only corrupt the tail of the file, so the reader (``replay``) validates
records in order and drops everything from the first bad/partial record
onwards; ``Journal(path, truncate_to=...)`` truncates the file back to
the last valid byte offset before resuming appends, so a corrupt tail
can never shadow post-restore records.

Durability contract: ``append`` only buffers in memory; ``flush`` writes
and fsyncs the batch.  The engine flushes once per macro-step (K device
ticks) and at admission/termination boundaries, so the decode hot loop's
host_syncs_per_token ≤ 1/K cadence is untouched.

Record types (the ``t`` field):

- ``meta``   — journal version, engine seed/temperature, sampling stream
  key version, geometry hints.  Written once when a fresh journal is
  created.
- ``admit``  — rid, prompt token list + sha256 digest, arrival time,
  max_new_tokens, eos_id, deadline fields, wall timestamp.
- ``tok``    — rid, one emitted token (in emission order).
- ``retry``  — rid was quarantined and restarted from scratch; all
  previously journaled tokens for that rid are void.
- ``fin``    — rid, typed finish_reason, tick.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib

JOURNAL_VERSION = 1
JOURNAL_NAME = "journal.wal"


def _frame(payload: dict) -> bytes:
    data = json.dumps(payload, separators=(",", ":"), sort_keys=True).encode()
    return b"%08x " % (zlib.crc32(data) & 0xFFFFFFFF) + data + b"\n"


def _parse_line(line: bytes) -> dict | None:
    """Return the decoded record, or None if the line is torn/corrupt."""
    if not line.endswith(b"\n") or len(line) < 10 or line[8:9] != b" ":
        return None
    body = line[9:-1]
    try:
        if int(line[:8], 16) != (zlib.crc32(body) & 0xFFFFFFFF):
            return None
        rec = json.loads(body)
    except (ValueError, json.JSONDecodeError):
        return None
    return rec if isinstance(rec, dict) and "t" in rec else None


@dataclasses.dataclass
class JournalState:
    """Result of a tolerant journal replay."""

    meta: dict | None = None
    admits: dict[int, dict] = dataclasses.field(default_factory=dict)
    tokens: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    retries: dict[int, int] = dataclasses.field(default_factory=dict)
    fins: dict[int, str] = dataclasses.field(default_factory=dict)
    records: int = 0
    valid_bytes: int = 0
    dropped_tail: bool = False


def replay(path: str) -> JournalState:
    """Fold a journal file into per-rid state, tolerating a torn tail.

    Records are validated in order; the first bad record (truncated
    write, flipped bits, partial final line) ends the replay and marks
    ``dropped_tail`` — everything before it is intact because appends
    are strictly sequential.
    """
    st = JournalState()
    if not os.path.exists(path):
        return st
    with open(path, "rb") as f:
        for line in f:
            rec = _parse_line(line)
            if rec is None:
                st.dropped_tail = True
                break
            kind = rec["t"]
            if kind == "meta":
                st.meta = rec
            elif kind == "admit":
                st.admits[int(rec["rid"])] = rec
            elif kind == "tok":
                st.tokens.setdefault(int(rec["rid"]), []).append(int(rec["tok"]))
            elif kind == "retry":
                rid = int(rec["rid"])
                st.tokens[rid] = []
                st.retries[rid] = st.retries.get(rid, 0) + 1
            elif kind == "fin":
                st.fins[int(rec["rid"])] = str(rec["reason"])
            # Unknown record types are forward-compatible no-ops.
            st.records += 1
            st.valid_bytes += len(line)
    return st


class Journal:
    """Buffered, fsync-batched appender over the WAL file.

    ``append`` is O(1) host work (dict → frame bytes into a list);
    ``flush`` concatenates the buffer, writes once, and fsyncs once.
    """

    def __init__(self, path: str, *, truncate_to: int | None = None):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # Truncate a torn tail *before* opening for append so resumed
        # records land immediately after the last valid one.
        if truncate_to is not None and os.path.exists(path):
            with open(path, "r+b") as f:
                f.truncate(truncate_to)
        self._f = open(path, "ab")
        self._buf: list[bytes] = []
        self.nbytes = self._f.tell()
        self.flushes = 0

    @property
    def dirty(self) -> bool:
        return bool(self._buf)

    def append(self, record: dict) -> None:
        self._buf.append(_frame(record))

    def flush(self) -> None:
        if not self._buf:
            return
        blob = b"".join(self._buf)
        self._buf.clear()
        self._f.write(blob)
        self._f.flush()
        os.fsync(self._f.fileno())
        self.nbytes += len(blob)
        self.flushes += 1

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._f.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
