"""AdamW + cosine schedule + clipping + optional gradient compression.

The counterpart of ``repro.optim.adamw``: fp32 first and second moments
over bf16 (or f32) params, b1 0.9, b2 0.95, eps 1e-8, weight decay
inside the update's ``delta`` on every leaf, clipping by the global norm
of the gradients, and the learning rate of the step being taken (1-based)
from a cosine schedule with linear warmup. Trees are the params' nested
dicts; the state mirrors them.

Where the reference builds new arrays, `adamw_update` updates the
params, ``mu`` and ``nu`` IN PLACE (``mul_``, ``add_``, ``addcmul_``) and
returns a state that shares them, so a leaf's update holds one f32
temporary of the leaf's size at most (an 8-layer llama3-8b ``w1`` is
470M elements): the gradient, scaled, then reused for the step. The
arithmetic is the reference's, in f32; only the order of two roundings
in ``delta`` differs (``m / (sqrt(v_hat) + eps) / bc1`` where the
reference divides ``m`` by ``bc1`` first). `global_norm` sums squares in
f32 a bounded chunk of a leaf at a time.

`compress_grads` / `decompress_grads` are the int8 error-feedback
quantization of the reference (round half to even, as ``jnp.round``).

On a mesh of more than one rank (`make_train_step`'s ``tp``, a
`repro_torch.parallel.placement.Sharded` its caller builds) the state
holds this rank's shards: the gradient of a leaf the data axes do
not split is summed over them, `global_norm` counts each shard once over
the mesh, and the update stays elementwise on the local shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Any

import torch

from repro_torch.models import serialize
from repro_torch.parallel import collectives as C
from repro_torch.parallel.placement import Sharded

B1, B2, EPS = 0.9, 0.95, 1e-8
#: elements of one leaf squared and summed at a time in `global_norm`
NORM_CHUNK = 1 << 24


@dataclass
class TrainState:
    step: torch.Tensor           # int32, 0-d
    params: Any
    mu: Any                      # fp32 first moment
    nu: Any                      # fp32 second moment
    err: Any | None = None       # compression error feedback (optional)


def state_fields(state: TrainState):
    """(name, subtree) in field order, the reference's flatten order."""
    return [(f.name, getattr(state, f.name)) for f in fields(state)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step) as a 0-d f32 tensor (on the step's device): linear warmup
    to ``base_lr`` over ``warmup`` steps, then a cosine to 0 at
    ``total``."""
    def lr(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return lr


def adamw_init(params, *, compression: bool = False) -> TrainState:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = serialize.leaves(params)[0].device
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        params=params,
        mu=tree_map(zeros32, params),
        nu=tree_map(zeros32, params),
        err=tree_map(zeros32, params) if compression else None,
    )


def _square_sum(x) -> torch.Tensor:
    flat = x.reshape(-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, flat.numel(), NORM_CHUNK):
        total = total + flat[i:i + NORM_CHUNK].float().square().sum()
    return total


def leaf_paths(tree, prefix: str = "") -> list[str]:
    """The '/'-joined paths of ``tree``'s leaves, in `serialize.leaves`
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def global_norm(tree, tp: Sharded | None = None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.
    With ``tp`` the leaves are this rank's shards: each shard is counted
    on the first rank that holds it and the sum taken over the mesh."""
    leaves = serialize.leaves(tree)
    if tp is None:
        return torch.sqrt(sum(_square_sum(x) for x in leaves))
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for path, x in zip(leaf_paths(tree), leaves):
        if tp.holds_first_copy(path):
            total = total + _square_sum(x)
    return torch.sqrt(C.all_reduce(total, tp.mesh, tp.mesh.axis_names))


def compress_grads(grads, err):
    """int8 block-quantize with error feedback. Returns (q, scales, err')."""
    def one(g, e):
        g32 = g.float() + e
        scale = torch.clamp_min(g32.abs().max(), 1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        return q, scale, g32 - q.float() * scale
    out = tree_map(one, grads, err)
    return tuple(_pick(out, i) for i in range(3))


def _pick(tree, i):
    """The i-th item of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def decompress_grads(q, scales):
    return tree_map(lambda qq, s: qq.float() * s, q, scales)


def adamw_update(state: TrainState, grads, lr, *, b1=B1, b2=B2, eps=EPS,
                 weight_decay=0.1, clip_norm=1.0,
                 grad_norm=None) -> TrainState:
    """One AdamW step, in place (see the module docstring). ``lr`` a
    float or a 0-d tensor; ``grad_norm`` the gradients' global norm
    where the caller has it (on a mesh it is a collective); returns the
    state at ``step + 1``."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp_max(clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    step = state.step + 1
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        t = g.float() if g.dtype != torch.float32 else g.clone()
        t.mul_(scale)                                   # the clipped g
        m.mul_(b1).add_(t, alpha=1 - b1)
        v.mul_(b2).addcmul_(t, t, value=1 - b2)
        torch.div(v, bc2, out=t).sqrt_().add_(eps)      # sqrt(v_hat) + eps
        torch.div(m, t, out=t).div_(bc1)                # m_hat / (...)
        t.add_(p, alpha=weight_decay).mul_(lr)          # lr * delta
        p.copy_(torch.sub(p, t, out=t))

    with torch.no_grad():
        tree_map(upd, state.params, grads, state.mu, state.nu)
    return TrainState(step=step, params=state.params, mu=state.mu,
                      nu=state.nu, err=state.err)


def make_train_step(model, *, base_lr=3e-4, warmup=100, total=10_000,
                    weight_decay=0.1, clip_norm=1.0, plain=False, tp=None):
    """Returns train_step(state, batch) -> (state, metrics): the loss and
    its gradient in every params leaf (``model.loss``, through the kernels
    unless ``plain``), then `adamw_update` at the learning rate of step
    ``state.step + 1``. The state is updated in place.

    ``tp`` (a `Sharded` placement on a mesh of more than one rank, which
    the caller builds: ``repro_torch.launch.sharding.placement``): the
    state is this rank's shards (`placement.state_to_mesh`) and the batch
    its slice; the step is the reference's jitted step under its state
    and batch shardings, with the loss and grad norm of the global batch.
    The returned function's ``tp`` is that placement (its ``gathers``
    count the model-axis gathers of weights whose rank's range is not its
    own shard), None on one device."""
    lr_fn = cosine_schedule(base_lr, warmup, total)

    def train_step(state: TrainState, batch):
        leaves = serialize.leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = model.loss(state.params, batch, plain=plain,
                                       tp=tp)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        # a leaf the loss does not read (a vlm's embedding) has grad 0
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if tp is not None:         # each data rank's is its batch's share
            grads = [tp.reduce_grad(path, g) for path, g in
                     zip(leaf_paths(state.params), grads)]
        grads = serialize.unflatten(state.params, grads)
        gnorm = global_norm(grads, tp)
        new_state = adamw_update(state, grads, lr_fn(state.step + 1),
                                 weight_decay=weight_decay,
                                 clip_norm=clip_norm, grad_norm=gnorm)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach() if tp is None else tp.sum_data(loss)
        metrics["grad_norm"] = gnorm
        return new_state, metrics

    train_step.tp = tp
    return train_step
