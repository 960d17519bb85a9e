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


def _route(p, cfg, xf):
    """Router in f32. xf: (T, D) -> gates (T, k) f32, idx (T, k) int64,
    and the Switch load-balancing loss (a 0-d f32 tensor)."""
    logits = xf.float() @ p["router"]                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    E = cfg.num_experts
    me = probs.mean(dim=0)                                # mean router prob
    ce = torch.zeros((E,), dtype=torch.float32, device=xf.device)
    ce.index_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1),
                                                      dtype=torch.float32))
    ce = ce / ce.sum().clamp_min(1.0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_loss
    return gates, idx, aux


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


def moe_sorted(p, cfg, x):
    """Sort-based capacity-C dispatch. x: (B, S, D) -> (out, aux_loss).

    Everything stays on the device with static shapes (no host sync):
    a dropped assignment is written to a spare row past the buffer.
    """
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xf = x.reshape(T, D)
    gates, idx, aux = _route(p, cfg, xf)

    A = T * k                                             # assignments
    cap = max(int(A / E * cfg.capacity_factor), 8)
    dev = x.device
    flat_e = idx.reshape(A)
    sort_i = torch.argsort(flat_e, stable=True)           # as jnp.argsort
    se = flat_e[sort_i]                                   # sorted expert ids
    tok = sort_i // k                                     # source token
    # slot within the expert's group = rank - first rank of that expert
    gstart = torch.searchsorted(se, torch.arange(E, device=dev))  # left
    slot = torch.arange(A, device=dev) - gstart[se]
    keep = slot < cap

    # the reference's `.at[se, slot].set(..., mode="drop")`: kept rows to
    # their (expert, slot), dropped ones to the spare row E * cap
    rows = torch.where(keep, se * cap + slot, E * cap)
    flat = x.new_zeros((E * cap + 1, D))
    flat.index_copy_(0, rows, xf[tok])
    out_buf = _experts_ffn(p, flat[:E * cap].view(E, cap, D))

    contrib = out_buf[se, slot.clamp_max(cap - 1)]        # (A, D)
    contrib = torch.where(keep[:, None], contrib, 0)
    # back to assignment order, weighted by the gates in x's dtype, summed
    # over k
    y = torch.empty_like(contrib)
    y[sort_i] = contrib
    y = (y.reshape(T, k, D) * gates[..., None].to(x.dtype)).sum(dim=1)
    return y.reshape(B, S, D), aux


def moe_dense(p, cfg, x):
    """Dropless masked-dense dispatch (decode and oracle; E/k x the
    operations). x: (B, S, D) -> (out, aux_loss)."""
    B, S, D = x.shape
    E = cfg.num_experts
    T = B * S
    xf = x.reshape(T, D)
    gates, idx, aux = _route(p, cfg, xf)
    # combine weight per (token, expert), f32
    w = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    w.scatter_add_(1, idx, gates)
    h = silu(torch.matmul(xf, p["w_gate"]))               # (E, T, F)
    h = h * torch.matmul(xf, p["w_up"])
    y = torch.matmul(h, p["w_down"])                      # (E, T, D)
    out = torch.einsum("etd,te->td", y.float(), w)
    return out.to(x.dtype).reshape(B, S, D), aux


def moe_local(p, cfg, x):
    """Shard-local dispatch. On one device there is no data axis to keep
    tokens on, so it is `moe_sorted`, as in the reference."""
    return moe_sorted(p, cfg, x)


def moe_layer(p, cfg, x):
    if cfg.moe_impl == "dense":
        return moe_dense(p, cfg, x)
    if cfg.moe_impl == "local":
        return moe_local(p, cfg, x)
    return moe_sorted(p, cfg, x)
