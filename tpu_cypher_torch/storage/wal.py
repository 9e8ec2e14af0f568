"""Write-ahead log: the durability half of transactional mutation.

One append-only file per mutable graph, one JSON line per committed write
batch. The commit point is the flushed (and, by default, fsynced) append:
a batch whose line is fully on disk is committed and MUST survive a
SIGKILL; a batch whose line is partial (the process died mid-append) or
absent is uncommitted and MUST be lost. Replay enforces exactly that: it
applies records in file order and stops at the first truncated or
CRC-damaged line — a partial tail is the expected signature of a crash
mid-append, not corruption worth failing boot over.

Record format (one line)::

    <crc32 hex8> <canonical JSON of {"lsn": n, "batch": {...}}>\\n

The CRC covers the JSON text, so a torn write anywhere in the line is
detected. ``append`` returns the file offset BEFORE the record so a failed
in-memory apply can roll the log back to it (``truncate``): an exception
between fsync and apply must not resurrect a write the client saw fail.

Multi-writer discipline: appends take an exclusive ``flock`` on the file,
reads a shared one. A failing-over cluster writer additionally holds
``exclusive()`` across catch-up + append (``MutableGraph.write_lock``) so
two workers can never interleave id allocation against the same log.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..utils.config import WAL_DIR, WAL_SYNC


def wal_directory(
    explicit: Optional[str] = None, cache_dir: Optional[str] = None
) -> Optional[str]:
    """Where WAL files live: an explicit directory wins, then
    ``TPU_CYPHER_WAL_DIR``, then ``<compile cache>/wal`` (durability rides
    beside the compile artifacts it restarts with), else None — mutations
    stay in-memory only."""
    if explicit:
        return explicit
    configured = WAL_DIR.get().strip()
    if configured:
        return configured
    if cache_dir:
        return os.path.join(cache_dir, "wal")
    return None


def _crc(text: str) -> str:
    return format(zlib.crc32(text.encode("utf-8")) & 0xFFFFFFFF, "08x")


class WriteAheadLog:
    """Append-only JSON-lines log with CRC-framed records."""

    def __init__(self, path: str, sync: Optional[str] = None):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # a+b: create if missing, never truncate an existing log
        self._fh = open(path, "a+b")
        self.sync = (sync if sync is not None else WAL_SYNC.get()).strip().lower()

    # -- write side ------------------------------------------------------

    @contextlib.contextmanager
    def exclusive(self):
        """Exclusive cross-process section (flock). Held by the mutation
        path across catch-up + evaluate + append so a failed-over writer
        can't race a dying one."""
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        try:
            yield self
        finally:
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)

    def append(self, record: Dict[str, Any]) -> int:
        """Durably append one record; returns the offset BEFORE it (the
        rollback point for ``truncate``). The record is committed once
        this returns."""
        text = json.dumps(record, sort_keys=True, separators=(",", ":"))
        line = f"{_crc(text)} {text}\n".encode("utf-8")
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        try:
            self._fh.seek(0, os.SEEK_END)
            off = self._fh.tell()
            self._fh.write(line)
            if self.sync != "off":
                self._fh.flush()
            if self.sync == "fsync":
                os.fsync(self._fh.fileno())
            return off
        finally:
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)

    def truncate(self, offset: int) -> None:
        """Roll the log back to ``offset`` — called when the in-memory
        apply of a just-appended record failed, so the record must not be
        replayed as committed."""
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        try:
            self._fh.truncate(offset)
            self._fh.flush()
            if self.sync == "fsync":
                os.fsync(self._fh.fileno())
        finally:
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)

    # -- read side -------------------------------------------------------

    def size(self) -> int:
        self._fh.seek(0, os.SEEK_END)
        return self._fh.tell()

    def read_from(self, offset: int) -> Tuple[List[Dict[str, Any]], int]:
        """Records appended at/after ``offset`` plus the offset of the end
        of the last WHOLE record — the catch-up primitive. A torn or
        CRC-bad tail is excluded (and not advanced past)."""
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_SH)
        try:
            self._fh.seek(offset)
            data = self._fh.read()
        finally:
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
        records: List[Dict[str, Any]] = []
        consumed = offset
        for raw in data.split(b"\n"):
            if not raw:
                continue
            rec = self._decode(raw)
            if rec is None:
                break  # torn/damaged tail: everything after is uncommitted
            records.append(rec)
            consumed += len(raw) + 1
        return records, consumed

    def replay(self) -> Iterator[Dict[str, Any]]:
        """Every committed record, in commit order."""
        records, _ = self.read_from(0)
        return iter(records)

    @staticmethod
    def _decode(raw: bytes) -> Optional[Dict[str, Any]]:
        try:
            line = raw.decode("utf-8")
            crc, text = line.split(" ", 1)
            if crc != _crc(text):
                return None
            return json.loads(text)
        except (ValueError, UnicodeDecodeError):
            return None

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:  # pragma: no cover - fault-ok: close on torn fd
            pass
