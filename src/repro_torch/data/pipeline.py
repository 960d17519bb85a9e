"""Training data pipeline fed through the Nexus backend.

The training input path is the framework-side instance of the paper's
insight: shard keys for future steps are *deterministic* (the ingress
hint analogue), so the shared backend prefetches them into arena slots
overlapped with the current step's compute — the restore/fetch overlap
of §4.2.2 transposed to the training loop. Decompression + batch
assembly happen in the backend (host), never in the "guest" step
function; the device sees ready int32 batches.

`SyntheticCorpus` materializes a seeded token corpus into the object
store as fixed-size shards — the stand-in for a tokenized dataset in
cloud storage.

A copy of ``repro.data.pipeline`` on the port's own ``core`` (its
backend, hints and object store), every constant at the reference's
value: the same spec gives the same shards and the same batches. The
batches are numpy arrays; the train driver moves them to the device.
"""
from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.backend import NexusBackend
from repro_torch.core.hints import InputHint
from repro_torch.core.storage import ObjectStore


@dataclass(frozen=True)
class CorpusSpec:
    name: str
    vocab_size: int
    shard_tokens: int            # tokens per shard object
    num_shards: int
    seed: int = 0
    compressed: bool = True


class SyntheticCorpus:
    """Seeded token shards in remote storage (bucket = corpus name)."""

    def __init__(self, store: ObjectStore, spec: CorpusSpec):
        self.store = store
        self.spec = spec

    def shard_key(self, i: int) -> str:
        return f"shard-{i % self.spec.num_shards:05d}"

    def materialize(self) -> None:
        rng = np.random.default_rng(self.spec.seed)
        for i in range(self.spec.num_shards):
            toks = rng.integers(0, self.spec.vocab_size,
                                size=self.spec.shard_tokens,
                                dtype=np.int32)
            raw = toks.tobytes()
            if self.spec.compressed:
                raw = zlib.compress(raw, level=1)
            self.store.put(self.spec.name, self.shard_key(i), raw)

    def decode(self, payload) -> np.ndarray:
        raw = bytes(payload)
        if self.spec.compressed:
            raw = zlib.decompress(raw)
        return np.frombuffer(raw, dtype=np.int32)


class DataPipeline:
    """Double-buffered, backend-prefetched batch iterator.

    prefetch_depth shards are always in flight; `next_batch()` blocks
    only if the overlap failed to hide the fetch (counted, so tests and
    benchmarks can assert the overlap actually works).
    """

    def __init__(self, corpus: SyntheticCorpus, backend: NexusBackend,
                 *, batch: int, seq_len: int, prefetch_depth: int = 2,
                 tenant: str = "train-pipeline"):
        self.corpus = corpus
        self.backend = backend
        self.batch = batch
        self.seq_len = seq_len
        self.depth = prefetch_depth
        self.tenant = tenant
        self._cred = backend.register_function(
            tenant, {corpus.spec.name})
        self._next_shard = 0
        self._inflight: list = []
        self._buffer = np.zeros((0,), np.int32)
        self._lock = threading.Lock()
        self.blocking_waits = 0
        self.batches_served = 0
        self.shard_takes = 0
        self._prime()

    # ------------------------------------------------------------ internals

    def _prime(self) -> None:
        while len(self._inflight) < self.depth:
            self._issue_one()

    def _issue_one(self) -> None:
        key = self.corpus.shard_key(self._next_shard)
        self._next_shard += 1
        meta = self.corpus.store.head(self.corpus.spec.name, key)
        hint = InputHint(self.corpus.spec.name, key, meta.size)
        self._inflight.append(
            self.backend.prefetch(self.tenant, self._cred, hint))

    def _take_shard(self) -> np.ndarray:
        handle = self._inflight.pop(0)
        self.shard_takes += 1
        if not handle.ready.is_set():
            self.blocking_waits += 1
        slot = handle.wait()
        toks = self.corpus.decode(slot.view())
        slot.release()
        self._issue_one()
        return toks

    # ------------------------------------------------------------ public

    def next_batch(self, mesh=None, axes=None) -> dict[str, np.ndarray]:
        """Returns {'tokens': (B, S) int32, 'targets': (B, S) int32}.

        With ``mesh`` (a `RankMesh`) and ``axes`` (the mesh axes the
        batch dim is split over, from the caller's batch spec; None: not
        split) every rank builds the same global batch from the same
        corpus and keeps its rows, as the reference ``device_put``s the
        global batch on its mesh."""
        need = self.batch * (self.seq_len + 1)
        with self._lock:
            while self._buffer.size < need:
                self._buffer = np.concatenate(
                    [self._buffer, self._take_shard()])
            chunk, self._buffer = (self._buffer[:need],
                                   self._buffer[need:])
        grid = chunk.reshape(self.batch, self.seq_len + 1)
        self.batches_served += 1
        if mesh is not None and axes is not None:
            rows = grid.shape[0] // mesh.axes_size(axes)
            grid = grid[mesh.index(axes) * rows:][:rows]
        return {"tokens": np.ascontiguousarray(grid[:, :-1]),
                "targets": np.ascontiguousarray(grid[:, 1:])}

    def overlap_efficiency(self) -> float:
        """Fraction of shard takes that never blocked (prefetch hid I/O)."""
        return 1.0 - self.blocking_waits / max(self.shard_takes, 1)
