"""Streaming fallback for opaque payloads (paper §4.2.3).

When ingress hints cannot name the input object or its size (~4% of
surveyed functions), the backend cannot pre-map an exactly-sized arena
slot. It instead streams the object through a fixed-capacity circular
buffer between backend (producer) and frontend (consumer): correct for
arbitrary sizes, memory strictly bounded, but no prefetch overlap —
the latency cost the paper quantifies in §7.2.1.

A copy of ``repro.core.streaming``, whole: the worker node takes
this fallback for size-opaque inputs.
"""
from __future__ import annotations

import threading


class CircularBuffer:
    """Bounded single-producer single-consumer byte ring."""

    def __init__(self, capacity: int = 1 << 20):
        self.capacity = capacity
        self._buf = bytearray(capacity)
        self._view = memoryview(self._buf)
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._head = 0          # next write
        self._tail = 0          # next read
        self._count = 0
        self._closed = False
        self._error: BaseException | None = None
        self.total_in = 0
        #: optional hook fired exactly once when the producer closes the
        #: ring — by then `total_in` is the full streamed byte count
        #: (how the frontend stub bills size-opaque fetches, §4.2.3).
        self.on_close = None

    def _space(self) -> int:
        return self.capacity - self._count

    def write(self, data) -> None:
        """Producer: block until all of `data` is enqueued."""
        data = memoryview(data)
        off = 0
        while off < len(data):
            with self._not_full:
                while self._space() == 0 and not self._closed:
                    self._not_full.wait()
                if self._closed:
                    raise BrokenPipeError("buffer closed")
                n = min(self._space(), len(data) - off,
                        self.capacity - self._head)
                self._view[self._head:self._head + n] = data[off:off + n]
                self._head = (self._head + n) % self.capacity
                self._count += n
                self.total_in += n
                off += n
                self._not_empty.notify()

    def read(self, n: int) -> bytes:
        """Consumer: up to `n` bytes; b'' at end-of-stream. A producer
        failure (`fail`) re-raises here once the buffered bytes drain —
        a truncated stream must never read as a clean EOF."""
        with self._not_empty:
            while self._count == 0 and not self._closed:
                self._not_empty.wait()
            if self._count == 0:
                if self._error is not None:
                    raise self._error
                return b""
            n = min(n, self._count, self.capacity - self._tail)
            out = bytes(self._view[self._tail:self._tail + n])
            self._tail = (self._tail + n) % self.capacity
            self._count -= n
            self._not_full.notify()
            return out

    def read_all(self, chunk: int = 256 * 1024) -> bytes:
        parts = []
        while True:
            b = self.read(chunk)
            if not b:
                return b"".join(parts)
            parts.append(b)

    def close(self) -> None:
        with self._lock:
            already = self._closed
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
        if not already and self.on_close is not None:
            self.on_close(self)

    def fail(self, exc: BaseException) -> None:
        """Producer-side abort: close the ring carrying `exc`, which the
        consumer's next `read` past the buffered bytes re-raises."""
        with self._lock:
            if self._error is None:
                self._error = exc
        self.close()
