"""RecordPack: a single-file packed record store for host-side data loading.

The replacement of the reference's internal storage stack: the nori pack +
redis filename->id hash (`slender_det/utils/nori_redis.py:7-57`) and the
multiprocess nori `AsyncWriter` (`slender_det/utils/async_writer.py:9-50`).
Millions of small image files thrash a network filesystem, so the blobs are
concatenated into one large file and read by offset. Unlike nori+redis, the
index travels INSIDE the pack (a self-contained footer, no external
services), and reads use `os.pread` on one shared fd: positionless, so the
loader's worker threads (`data/build.py`) read concurrently without locks or
per-thread handles.

Layout:  [blob 0][blob 1]...[JSON index][8B LE index length][8B magic]
The index maps record name (the reference keyed its redis hash by file
name, `nori_redis.py:25-33`) to ``[offset, length]``.

A copy of ``slenderobjdet_tpu/data/recordpack.py``: the files are the same
bytes for the same records, so a pack either package writes, the other reads
(``tests/test_torch_recordpack.py``).
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading
from typing import Dict, Iterator, List, Optional, Tuple

_MAGIC = b"SLDRPACK"
_FOOTER = struct.Struct("<Q8s")  # index length, magic


class PackWriter:
    """Append records, then `close()` writes the self-indexing footer."""

    def __init__(self, path: str):
        self.path = str(path)
        self._f = open(self.path, "wb")
        self._index: Dict[str, Tuple[int, int]] = {}
        self._offset = 0

    def write(self, data: bytes, name: str) -> None:
        if name in self._index:
            raise KeyError(f"duplicate record name: {name!r}")
        self._f.write(data)
        self._index[name] = (self._offset, len(data))
        self._offset += len(data)

    def __len__(self) -> int:
        return len(self._index)

    def close(self) -> None:
        if self._f is None:
            return
        blob = json.dumps(self._index, separators=(",", ":")).encode()
        self._f.write(blob)
        self._f.write(_FOOTER.pack(len(blob), _MAGIC))
        self._f.close()
        self._f = None

    def __enter__(self) -> "PackWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AsyncPackWriter:
    """Background-thread writer mirroring the reference AsyncWriter protocol
    (`async_writer.py:9-50`): `start()`, `write(data, name)` enqueues, a
    `None` sentinel (sent by `close()`) stops the drain. A thread, not a
    process, because pack writing is pure IO (the reference forked a process
    to amortize nori's serialization; here there is none)."""

    def __init__(self, path: str, maxsize: int = 32, after=None):
        self.path = str(path)
        self._queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._after = after
        self._error: Optional[BaseException] = None

    def start(self) -> "AsyncPackWriter":
        self._thread.start()
        return self

    def _drain(self) -> None:
        try:
            with PackWriter(self.path) as w:
                while True:
                    item = self._queue.get()
                    if item is None:
                        break
                    w.write(item[0], item[1])
                    if self._after is not None:
                        self._after()
        except BaseException as e:  # surfaced on close()
            self._error = e

    def write(self, data: bytes, name: str) -> None:
        # bounded put so a dead writer thread + full queue can't deadlock
        # the producer: re-check the error flag between attempts
        while True:
            if self._error is not None:
                raise RuntimeError(
                    "pack writer thread failed") from self._error
            try:
                self._queue.put((data, name), timeout=1.0)
                return
            except queue.Full:
                continue

    def close(self) -> None:
        while self._thread.is_alive():
            try:
                self._queue.put(None, timeout=1.0)
                break
            except queue.Full:
                continue  # a dead thread exits the loop via is_alive()
        self._thread.join()
        if self._error is not None:
            raise RuntimeError("pack writer thread failed") from self._error

    def __enter__(self) -> "AsyncPackWriter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


class PackReader:
    """Random access by record name; `get` is thread-safe (os.pread)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        size = os.fstat(self._fd).st_size
        if size < _FOOTER.size:
            raise ValueError(f"{self.path}: not a RecordPack (too small)")
        idx_len, magic = _FOOTER.unpack(
            os.pread(self._fd, _FOOTER.size, size - _FOOTER.size))
        if magic != _MAGIC:
            raise ValueError(f"{self.path}: not a RecordPack (bad magic)")
        blob = os.pread(self._fd, idx_len, size - _FOOTER.size - idx_len)
        self._index: Dict[str, List[int]] = json.loads(blob)

    def get(self, name: str) -> bytes:
        offset, length = self._index[name]  # KeyError on miss, like redis hget
        return os.pread(self._fd, length, offset)

    def keys(self) -> Iterator[str]:
        return iter(self._index)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __len__(self) -> int:
        return len(self._index)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
