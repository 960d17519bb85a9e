"""Collectives over the axes of a `RankMesh`, and the autograd Functions
that tensor and FSDP parallelism are built from.

* `all_reduce`, `all_gather` (along any dim), `reduce_scatter` (along
  any dim) and `all_to_all` (parts along one dim out, along another in)
  over a tuple of mesh axes, outside autograd;
* `gather`: all-gather forward, reduce-scatter (sum) backward: a
  sharded weight made whole where it is used, its gradient summed back
  to the shard;
* `copy_to` (Megatron's f): identity forward, all-reduce backward, where
  a tensor every rank holds whole enters work split over an axis;
* `reduce_from` (Megatron's g): all-reduce forward, identity backward,
  where the partial results of that work are summed.

``torch.distributed.nn.functional.all_reduce`` sums the gradient in its
backward too, which counts a loss that every rank of the axis holds
``size`` times; `reduce_from` does not. Over axes of one rank every
function returns its input: no collective and no copy.

Under gloo a CUDA tensor goes through host memory (gloo's own CUDA
support varies by build); every backend runs the same calls
(``reduce_scatter_tensor`` for a reduce-scatter, ``all_to_all_single``
for an all-to-all), and `backend_note`
names what ran. Each
mesh's ``stats`` (a `Stats`) counts its collectives: calls, bytes, host
seconds and, for NCCL on the card, device time between CUDA events
around each.
"""
from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist


class Stats:
    """Calls, input bytes and host seconds per collective (in all and by
    kind) and, on the card under NCCL, their device time."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls: dict[str, int] = {}
        self.bytes = 0
        self.bytes_by: dict[str, int] = {}
        self.host_s = 0.0
        self.host_s_by: dict[str, float] = {}
        self._events: list = []

    def add(self, op: str, nbytes: int, host_s: float, events=None) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        self.bytes += nbytes
        self.bytes_by[op] = self.bytes_by.get(op, 0) + nbytes
        self.host_s += host_s
        self.host_s_by[op] = self.host_s_by.get(op, 0.0) + host_s
        if events is not None:
            self._events.append(events)

    def device_s(self) -> float | None:
        """Device seconds between the NCCL collectives' events (after a
        synchronize); None where none was recorded."""
        if not self._events:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self._events) / 1e3

    def summary(self) -> dict:
        return {"calls": dict(self.calls), "bytes": self.bytes,
                "bytes_by": dict(self.bytes_by), "host_s": self.host_s,
                "host_s_by": dict(self.host_s_by),
                "device_s": self.device_s()}


def _staged(mesh, x) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def backend_note(mesh) -> str:
    """What the collectives of ``mesh`` run as."""
    if mesh.backend == "gloo" and mesh.device.type == "cuda":
        return "gloo on the card's tensors through host memory"
    return f"{mesh.backend}"


class _Timed:
    """Times one collective into its mesh's `Stats`."""

    def __init__(self, op, mesh, x):
        self.op, self.x, self.stats = op, x, mesh.stats
        self.events = None
        if x.is_cuda and not _staged(mesh, x):
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        if self.events:
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.events:
            self.events[1].record()
        self.stats.add(self.op, self.x.numel() * self.x.element_size(),
                       time.perf_counter() - self.t0, self.events)
        return False


def _buffer(mesh, x):
    """A contiguous copy of ``x`` that the collective may write: on the
    host under gloo."""
    if _staged(mesh, x):
        return x.detach().to("cpu", memory_format=torch.contiguous_format,
                             copy=True)
    return x.detach().clone(memory_format=torch.contiguous_format)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x, mesh, axes, op: str = "sum", kind: str = "all_reduce"):
    """The sum (or max) of ``x`` over the ranks of ``axes``, a new
    tensor, counted in the mesh's `Stats` under ``kind``."""
    group = mesh.group(axes)
    if group is None:
        return x
    with _Timed(kind, mesh, x):
        buf = _buffer(mesh, x)
        dist.all_reduce(buf, op=_OPS[op], group=group)
        return buf.to(x.device)


def all_gather(x, mesh, axes, dim: int, kind: str = "all_gather"):
    """The ranks' ``x`` of ``axes`` concatenated along ``dim``, in the
    order of their combined coordinate, counted under ``kind``."""
    group = mesh.group(axes)
    if group is None:
        return x
    n = mesh.axes_size(axes)
    with _Timed(kind, mesh, x):
        src = _buffer(mesh, x.movedim(dim, 0))
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous().to(x.device)


def reduce_scatter(x, mesh, axes, dim: int):
    """The sum of ``x`` over the ranks of ``axes``, split along ``dim``:
    this rank's part (its combined coordinate)."""
    group = mesh.group(axes)
    if group is None:
        return x
    part = x.shape[dim] // mesh.axes_size(axes)
    with _Timed("reduce_scatter", mesh, x):
        src = _buffer(mesh, x.movedim(dim, 0))
        out = src.new_empty((part,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous().to(x.device)


def all_to_all(x, mesh, axes, split_dim, cat_dim, *, send=None,
               recv=None, kind: str = "all_to_all"):
    """Every rank of ``axes`` cuts ``x`` into parts along ``split_dim``,
    sends part j to the rank of combined coordinate j, and concatenates
    the parts it receives along ``cat_dim`` in the order of their senders'
    coordinates. ``send`` gives the parts' sizes along ``split_dim``
    (every rank the same list; default n equal parts); ``split_dim`` None
    sends the whole of ``x`` to every rank. ``recv`` gives the size along
    ``cat_dim`` of the part each sender sends (default ``x``'s own).
    Sizes may be 0. Counted in the mesh's `Stats` under ``kind``."""
    group = mesh.group(axes)
    if group is None:
        return x
    n = mesh.axes_size(axes)
    me = mesh.index(axes)
    if split_dim is None:
        parts = [x] * n
    else:
        send = send or [x.shape[split_dim] // n] * n
        parts = torch.split(x, list(send), dim=split_dim)
    recv = recv or [x.shape[cat_dim]] * n
    shapes = []
    for size in recv:
        shape = list(parts[me].shape)
        shape[cat_dim] = size
        shapes.append(shape)
    with _Timed(kind, mesh, x):
        src = torch.cat([p.reshape(-1) for p in parts])
        if _staged(mesh, x):
            src = src.cpu()
        out = src.new_empty(sum(math.prod(s) for s in shapes))
        dist.all_to_all_single(out, src, [math.prod(s) for s in shapes],
                               [p.numel() for p in parts], group=group)
        pieces = [t.reshape(s) for t, s in zip(
            out.split([math.prod(s) for s in shapes]), shapes)]
        return torch.cat(pieces, dim=cat_dim).to(x.device)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, *ctx.args), None, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, *ctx.args), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather(x, mesh, axes, dim: int):
    """`all_gather` forward, `reduce_scatter` of the gradient backward."""
    return x if mesh.group(axes) is None else _Gather.apply(x, mesh, axes,
                                                            dim)


def copy_to(x, mesh, axes):
    """Identity forward, the gradient summed over ``axes`` backward."""
    return x if mesh.group(axes) is None else _Copy.apply(x, mesh, axes)


def reduce_from(x, mesh, axes):
    """The sum over ``axes`` forward, the gradient as is backward."""
    return x if mesh.group(axes) is None else _Reduce.apply(x, mesh, axes)
