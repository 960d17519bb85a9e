"""Sharded checkpointing with Nexus async writeback.

The counterpart of ``repro.checkpoint.ckpt`` on the port's own ``core``.
Checkpoint saves are the training loop's "output write": under Nexus the
shards are handed to the backend and the loop proceeds — the §4.2.5
early-release optimization, with the same at-least-once discipline:

* one object per leaf, keyed by step + leaf path,
* a manifest object written LAST; restore reads the manifest first, so
  a crash mid-save can never yield a half-visible checkpoint (atomic
  commit),
* `AsyncCheckpointer.wait()` gates on all pending PUT acks.

It writes exactly what the reference writes: the same ``"/"``-joined
keys in the same order as ``jax.tree_util.tree_flatten_with_path`` gives
for a `TrainState` (``step``, ``params/...``, ``mu/...``, ``nu/...``,
``err/...`` unless it is None; dict keys sorted), each leaf's raw
little-endian bytes (bf16 as its 16-bit words), the same manifest JSON
and the ``LATEST`` pointer. Restore returns CPU tensors (numpy has no
bf16); with a backend the shards are prefetched through
`NexusBackend.prefetch`.

On a mesh (a ``tp``, `repro_torch.parallel.placement.Sharded`, of more
than one rank) the state is each rank's shards: `AsyncCheckpointer.save`
gathers each leaf whole and rank 0 writes exactly what the one-device
path writes for that state; `restore_to_mesh` reads on rank 0 and
broadcasts each leaf, every rank keeping its shard, so a sharded run
resumes from a one-device checkpoint and the other way round.
"""
from __future__ import annotations

import json
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.backend import NexusBackend
from repro_torch.core.hints import InputHint, OutputHint
from repro_torch.core.storage import ObjectStore
from repro_torch.models import serialize
from repro_torch.optim.adamw import TrainState, state_fields
from repro_torch.parallel import placement as P

#: a leaf's dtype as the manifest names it (numpy's names) -> torch dtype,
#: and the numpy dtype its raw words are read as
DTYPES = {"float32": (torch.float32, np.float32),
          "bfloat16": (torch.bfloat16, np.int16),
          "int32": (torch.int32, np.int32),
          "int8": (torch.int8, np.int8)}
_NAMES = {torch_dtype: name for name, (torch_dtype, _) in DTYPES.items()}


def _items(tree, prefix=""):
    """(key, leaf) in jax's flatten order: dataclass fields in order,
    dict keys sorted, sequence items as ``[i]``; None holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, TrainState):
        children = state_fields(tree)
    elif isinstance(tree, dict):
        children = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        children = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for name, child in children:
        yield from _items(child, f"{prefix}/{name}" if prefix else name)


def _flatten(state) -> dict[str, torch.Tensor]:
    return {key: leaf.detach() for key, leaf in _items(state)}


def _meta(obj: str, t: torch.Tensor) -> dict:
    return {"object": obj, "shape": list(t.shape), "dtype": _NAMES[t.dtype]}


def _serialize(t: torch.Tensor) -> bytes:
    """Raw little-endian bytes; shape and dtype live in the manifest."""
    return serialize.dumps(t)


def _deserialize(raw: bytes, dtype: str, shape) -> torch.Tensor:
    torch_dtype, words = DTYPES[dtype]
    t = torch.from_numpy(np.frombuffer(raw, dtype=words).copy()).reshape(
        tuple(shape))
    return t.view(torch_dtype)


def save_checkpoint(store: ObjectStore, bucket: str, step: int,
                    state) -> dict:
    """Synchronous sharded save (the coupled baseline path)."""
    flat = _flatten(state)
    manifest = {"step": step, "leaves": {}}
    for key, t in flat.items():
        obj = f"step-{step:08d}/{key}"
        store.put(bucket, obj, _serialize(t))
        manifest["leaves"][key] = _meta(obj, t)
    store.put(bucket, f"step-{step:08d}/MANIFEST",
              json.dumps(manifest).encode())
    store.put(bucket, "LATEST", str(step).encode())
    return manifest


class AsyncCheckpointer:
    """Nexus-async saves: hand shards to the backend, keep training."""

    def __init__(self, backend: NexusBackend, bucket: str,
                 tenant: str = "checkpointer"):
        self.backend = backend
        self.bucket = bucket
        self.tenant = tenant
        self._cred = backend.register_function(tenant, {bucket})
        self._pending: list = []
        self._lock = threading.Lock()
        self.saves = 0

    def save(self, step: int, state, tp=None) -> None:
        """Hand ``state``'s leaves to the backend; with ``tp`` (a mesh
        of more than one rank) every rank must call it: each leaf is
        gathered whole, one at a time, and rank 0 writes."""
        if tp is not None and tp.mesh.size > 1:
            state = _gathered(state, tp)
            if tp.mesh.rank != 0:
                return
        flat = _flatten(state)
        manifest = {"step": step, "leaves": {}}
        tickets = []
        for key, t in flat.items():
            obj = f"step-{step:08d}/{key}"
            raw = _serialize(t)
            slot = self.backend.arenas.get(self.tenant).alloc(len(raw))
            slot.write(raw)
            ticket = self.backend.submit_put(
                self.tenant, self._cred, OutputHint(self.bucket, obj),
                slot, invocation_id=f"ckpt-{step}-{key}")
            tickets.append(ticket)
            manifest["leaves"][key] = _meta(obj, t)

        # the manifest is the commit point: submit it only after every
        # shard ticket resolves, from a watcher thread (training loop
        # does NOT block).
        def _commit():
            for ticket in tickets:
                ticket.future.result(timeout=60)
            raw = json.dumps(manifest).encode()
            slot = self.backend.arenas.get(self.tenant).alloc(len(raw))
            slot.write(raw)
            tm = self.backend.submit_put(
                self.tenant, self._cred,
                OutputHint(self.bucket, f"step-{step:08d}/MANIFEST"),
                slot, invocation_id=f"ckpt-{step}-manifest")
            tm.future.result(timeout=60)
            self.backend.remote.store.put(self.bucket, "LATEST",
                                          str(step).encode())

        th = threading.Thread(target=_commit, daemon=True)
        th.start()
        with self._lock:
            self._pending.append(th)
            self.saves += 1

    def wait(self, timeout: float = 120.0) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for th in pending:
            th.join(timeout)
            if th.is_alive():
                raise TimeoutError("checkpoint commit did not finish")


def _gathered(state, tp):
    """The whole state on rank 0 (on the host), None elsewhere, gathered
    leaf by leaf."""
    specs = tp.state_specs(state)
    rank0 = tp.mesh.rank == 0

    def one(path, leaf):
        whole = P.gather_full(leaf, specs[path], tp.mesh)
        return whole.cpu() if rank0 else None
    whole = P.map_leaves(state, one)
    return whole if rank0 else None


def restore_to_mesh(store: ObjectStore, bucket: str, state, tp,
                    step: int | None = None,
                    backend: NexusBackend | None = None):
    """`restore_checkpoint` on rank 0 of ``tp``'s mesh, each leaf
    broadcast and cut to this rank's shard (`placement.broadcast_shard`),
    in the dtype and on the device of ``state``'s (this rank's shards,
    whose structure the checkpoint must have). Every rank calls it;
    returns (step, state) on every rank, or raises KeyError on every
    rank when rank 0 finds no checkpoint."""
    mesh = tp.mesh
    found, flat = [None], None
    if mesh.rank == 0:
        try:
            found[0], flat = restore_checkpoint(store, bucket, step, backend)
        except KeyError:
            pass
    if mesh.size > 1:
        dist.broadcast_object_list(found, src=0)
    if found[0] is None:
        raise KeyError("no checkpoint")
    specs = tp.state_specs(state)

    def one(path, leaf):
        shape = tp.shape(path.split("/", 1)[1]) if "/" in path else ()
        whole = flat[path].to(leaf.dtype) if flat is not None else None
        return P.broadcast_shard(whole, shape, leaf.dtype, specs[path],
                                  mesh).to(leaf.device)
    return found[0], P.map_leaves(state, one)


def restore_checkpoint(store: ObjectStore, bucket: str,
                       step: int | None = None,
                       backend: NexusBackend | None = None):
    """Restore a flat {path: CPU tensor} dict. With a backend, shards are
    prefetched concurrently (hint-driven), else read directly."""
    if step is None:
        step = int(store.get(bucket, "LATEST").decode())
    manifest = json.loads(store.get(bucket, f"step-{step:08d}/MANIFEST"))

    out: dict[str, torch.Tensor] = {}
    if backend is None:
        for key, meta in manifest["leaves"].items():
            out[key] = _deserialize(store.get(bucket, meta["object"]),
                                    meta["dtype"], meta["shape"])
        return step, out

    tenant = "ckpt-restore"
    cred = backend.register_function(tenant, {bucket})
    handles = {}
    for key, meta in manifest["leaves"].items():
        size = store.head(bucket, meta["object"]).size
        handles[key] = backend.prefetch(
            tenant, cred, InputHint(bucket, meta["object"], size))
    for key, h in handles.items():
        meta = manifest["leaves"][key]
        slot = h.wait()
        out[key] = _deserialize(bytes(slot.view()), meta["dtype"],
                                meta["shape"])
        slot.release()
    return step, out
