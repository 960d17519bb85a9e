"""Mixture-of-Experts FFN with top-k routing.

The counterpart of ``repro.models.moe``, each function a plain function
on tensors:

* `moe_sorted` (prefill): assignments sorted by expert id and written
  into an (E, C, D) capacity buffer, the experts run as three batched
  products, the results gathered back in assignment order and combined
  with the gates. Assignments past an expert's capacity C are dropped,
  as in the reference.
* `moe_dense` (decode, and the oracle): every token through every
  expert, combined with a (T, E) weight that is zero off the top k.
  Dropless; E/k times the operations.

The expert products are plain large products that the reference leaves
to XLA; here they are `torch.matmul`, which reads the (E, D, F) weights
in place (a 2-D input broadcasts against the expert axis). On one device
`moe_local` is `moe_sorted`, as the reference's is without a data axis.

On a mesh (``tp``, a `repro_torch.parallel.placement.Sharded` of more
than one rank) both compute the reference's global semantics from this
rank's rows of the batch (`_route_on_mesh`): the router runs on the
whole x before it enters the split work; where the data axes split the
batch (training, and a serving batch they divide) every data rank's
per-expert counts are gathered (no gradient), so the capacity, each
assignment's slot and the Switch loss are those of the whole batch;
where they do not (a serving batch replicated over them, B 1 of
``long_500k``) this rank's rows are the whole batch and are routed as
on one device. Each ``model`` rank runs the experts of its
``tp.split(E)``: its own shard where ``model`` divides E (expert
parallelism), else cut from the leaf fetched whole (the reference's
fallback rule); where ``model`` exceeds E some ranks hold no expert and
add zeros to the sum. The partial outputs are summed over ``model``.
`moe_local` on a serving mesh is the reference's ``shard_map`` over the
data axes: each data rank sorts its own rows into a capacity of its
own, and the losses are averaged over the data axes. A decode step's
`moe_dense` gathers no counts: its loss is thrown away.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init


def init_moe(generator, cfg, dtype, device=None):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": dense_init(generator, (D, E), 0, torch.float32, device),
        "w_gate": dense_init(generator, (E, D, Fd), 1, dtype, device),
        "w_up": dense_init(generator, (E, D, Fd), 1, dtype, device),
        "w_down": dense_init(generator, (E, Fd, D), 1, dtype, device),
    }


def _top_k(router, cfg, xf):
    """The router in f32. xf: (T, D) -> probs (T, E), gates (T, k)
    renormalised, idx (T, k) int64."""
    logits = xf.float() @ router                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, idx


def _counts(idx, E):
    """(E,) f32: the assignments of ``idx`` to each expert."""
    ce = torch.zeros((E,), dtype=torch.float32, device=idx.device)
    return ce.index_add_(0, idx.reshape(-1), torch.ones_like(
        idx.reshape(-1), dtype=torch.float32))


def _switch_loss(cfg, me, ce):
    """The Switch load-balancing loss of the mean router probabilities
    ``me`` (E,) and the per-expert assignment counts ``ce`` (E,)."""
    ce = ce / ce.sum().clamp_min(1.0)
    return cfg.num_experts * torch.sum(me * ce) * cfg.router_aux_loss


def _route(p, cfg, xf):
    """Router in f32. xf: (T, D) -> gates (T, k) f32, idx (T, k) int64,
    and the Switch load-balancing loss (a 0-d f32 tensor)."""
    probs, gates, idx = _top_k(p["router"], cfg, xf)
    return gates, idx, _switch_loss(cfg, probs.mean(dim=0),
                                    _counts(idx, cfg.num_experts))


def _route_on_mesh(p, cfg, xf, tp, gather=True):
    """`_route` on this rank's rows xf (T, D), the router fetched whole:
    gates and idx of these rows, a Switch loss, and the per-expert counts
    of the rows the slots are ranked among (or None).

    Where the data axes split the batch and ``gather`` is set: this
    rank's share of the whole batch's loss, and every data rank's counts
    (n, E) in the order the batch is split (no gradient). The loss is a
    product of two means over the whole batch, so the share is ``E *
    coef * sum(probs.sum(0) / (n T) * ce)`` with ``ce`` from every
    rank's counts: the shares sum over the data axes to the reference's
    loss, and the gradient through ``probs`` stays this rank's.

    Else (a batch replicated over the data axes, whose rows are the
    whole batch on every rank; or ``gather`` off: `moe_local`'s shards
    and a decode step) the rows are routed as on one device: their own
    loss, no counts, no collective."""
    E = cfg.num_experts
    router = tp.weight(p["router"], "layers/moe/router", 1, 0, E)
    probs, gates, idx = _top_k(router, cfg, xf)
    if not (gather and tp.rows_split):
        return gates, idx, _switch_loss(cfg, probs.mean(dim=0),
                                        _counts(idx, E)), None
    table = tp.gather_data(_counts(idx, E), kind="count_all_gather")
    me = probs.sum(dim=0) / (xf.shape[0] * table.shape[0])
    return gates, idx, _switch_loss(cfg, me, table.sum(dim=0)), table


def _experts_on_mesh(p, cfg, tp):
    """This rank's experts [e0, e1) (``tp.split(E)``) of each expert
    weight: its own shard where ``model`` divides E, else cut from the
    leaf gathered whole (`Sharded.weight`)."""
    e0, e1 = tp.split(cfg.num_experts)
    return e0, e1, {name: tp.weight(p[name], f"layers/moe/{name}", 0, e0,
                                    e1)
                    for name in ("w_gate", "w_up", "w_down")}


def silu(x):
    """x * sigmoid(x) with the sigmoid as 1 / (1 + exp(-x)) and every step
    rounded to x's dtype, the order in which the reference's
    ``jax.nn.silu`` rounds a bf16 input on the CPU; `F.silu` rounds once
    and differs in the last bit of ~40% of bf16 values, which the expert
    products then carry into the layer's output."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _experts_ffn(p, buf):
    """buf: (E, C, D) -> (E, C, D) through each expert's SwiGLU."""
    h = silu(torch.matmul(buf, p["w_gate"]))
    h = h * torch.matmul(buf, p["w_up"])
    return torch.matmul(h, p["w_down"])


def moe_sorted(p, cfg, x, tp=None, gather=True):
    """Sort-based capacity-C dispatch. x: (B, S, D) -> (out, aux_loss).

    Everything stays on the device with static shapes (no host sync):
    a dropped assignment is written to a spare row past the buffer.

    With ``tp`` x is this rank's rows of the batch (`_route_on_mesh`).
    Where they are a split of the batch (and ``gather`` is set) the
    capacity is the whole batch's, and an assignment's slot is its rank
    within its expert in the whole batch's stable sort: the counts of
    the data ranks before this one (the batch's order) plus its rank
    among this rank's rows; aux is this rank's share. Else (a replicated
    batch, or `moe_local`'s shards) capacity and slots are those of
    these rows alone. Each ``model`` rank fills and runs only its
    experts' rows of the buffer, on x and the gates entering the split
    work (`Sharded.copy`), and the partial outputs are summed over
    ``model`` (`Sharded.reduce`); a rank with no expert joins the sum
    with zeros.
    """
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xf = x.reshape(T, D)
    A = T * k                                             # assignments
    table = None
    if tp is None:
        gates, idx, aux = _route(p, cfg, xf)
        e0, e1, w = 0, E, p
    else:
        gates, idx, aux, table = _route_on_mesh(p, cfg, xf, tp, gather)
        e0, e1, w = _experts_on_mesh(p, cfg, tp)
        xf, gates = tp.copy(xf), tp.copy(gates)
    n = 1 if table is None else table.shape[0]
    cap = max(int(A * n / E * cfg.capacity_factor), 8)
    El = e1 - e0
    if El == 0:                         # no expert here: only the sum
        return tp.reduce(torch.zeros_like(xf)).reshape(B, S, D), aux
    dev = x.device
    flat_e = idx.reshape(A)
    sort_i = torch.argsort(flat_e, stable=True)           # as jnp.argsort
    se = flat_e[sort_i]                                   # sorted expert ids
    tok = sort_i // k                                     # source token
    # slot within the expert's group = rank - first rank of that expert
    gstart = torch.searchsorted(se, torch.arange(E, device=dev))  # left
    slot = torch.arange(A, device=dev) - gstart[se]
    if table is not None:          # after the data ranks before this one
        before = table[:tp.mesh.index(tp.data)].sum(dim=0)
        slot = slot + before.long()[se]
    keep = (slot < cap) & (se >= e0) & (se < e1)          # this rank's
    le = se - e0                                          # local expert

    # the reference's `.at[se, slot].set(..., mode="drop")`: kept rows to
    # their (expert, slot), dropped ones (and other ranks' experts) to the
    # spare row El * cap
    rows = torch.where(keep, le * cap + slot, El * cap)
    flat = x.new_zeros((El * cap + 1, D))
    flat.index_copy_(0, rows, xf[tok])
    out_buf = _experts_ffn(w, flat[:El * cap].view(El, cap, D))

    contrib = out_buf[le.clamp(0, El - 1), slot.clamp_max(cap - 1)]
    contrib = torch.where(keep[:, None], contrib, 0)      # (A, D)
    # back to assignment order, weighted by the gates in x's dtype, summed
    # over k
    y = torch.empty_like(contrib)
    y[sort_i] = contrib
    y = (y.reshape(T, k, D) * gates[..., None].to(x.dtype)).sum(dim=1)
    if tp is not None:
        y = tp.reduce(y)
    return y.reshape(B, S, D), aux


def moe_dense(p, cfg, x, tp=None, gather=True):
    """Dropless masked-dense dispatch (decode and oracle; E/k x the
    operations). x: (B, S, D) -> (out, aux_loss). With ``tp`` each
    ``model`` rank runs its experts on every token and combines them
    with its columns of the (T, E) weight; the f32 partial outputs are
    summed over ``model`` (a rank with no expert runs empty products and
    adds zeros). With ``gather`` off (a decode step, which throws the
    loss away) no counts are gathered and the loss is that of this
    rank's rows (`_route_on_mesh`)."""
    B, S, D = x.shape
    E = cfg.num_experts
    T = B * S
    xf = x.reshape(T, D)
    if tp is None:
        gates, idx, aux = _route(p, cfg, xf)
        e0, e1, w_e = 0, E, p
    else:
        gates, idx, aux, _ = _route_on_mesh(p, cfg, xf, tp, gather)
        e0, e1, w_e = _experts_on_mesh(p, cfg, tp)
        xf, gates = tp.copy(xf), tp.copy(gates)
    # combine weight per (token, expert), f32
    w = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    w.scatter_add_(1, idx, gates)
    h = silu(torch.matmul(xf, w_e["w_gate"]))             # (E, T, F)
    h = h * torch.matmul(xf, w_e["w_up"])
    y = torch.matmul(h, w_e["w_down"])                    # (E, T, D)
    out = torch.einsum("etd,te->td", y.float(), w[:, e0:e1])
    if tp is not None:
        out = tp.reduce(out)
    return out.to(x.dtype).reshape(B, S, D), aux


def moe_local(p, cfg, x, tp=None):
    """Shard-local dispatch, the reference's ``shard_map`` over the data
    axes. On one device there is no data axis to keep tokens on, so it is
    `moe_sorted`, as in the reference. On a mesh each data rank's rows go
    through `moe_sorted` with a capacity of their own and slots ranked
    among them (no count gather), the experts over ``model`` as there,
    and the loss is the mean of the data ranks' (no gradient: training
    runs the global sort). Where the data axes do not split the batch (a
    replicated batch: the reference's ``B % n != 0``) it is the global
    `moe_sorted`."""
    if tp is None or not tp.rows_split:
        return moe_sorted(p, cfg, x, tp)
    y, aux = moe_sorted(p, cfg, x, tp, gather=False)
    return y, tp.sum_data(aux) / tp.mesh.axes_size(tp.data)


def moe_layer(p, cfg, x, tp=None, train=False):
    """The layer by ``cfg.moe_impl``, as the reference's: "local" runs
    `moe_local` in a prefill, and in training (``train``) the global
    `moe_sorted` (on one device the two are the same). A prefill throws
    its loss away, so its "dense" layer gathers no counts."""
    if cfg.moe_impl == "dense":
        return moe_dense(p, cfg, x, tp, gather=train)
    if cfg.moe_impl == "local" and not train:
        return moe_local(p, cfg, x, tp)
    return moe_sorted(p, cfg, x, tp)
