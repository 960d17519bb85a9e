"""Decoder-only LM assembly: the dense, vlm, moe, ssm and hybrid families.

The counterpart of ``repro.models.lm``. The vlm family is the dense
decoder fed precomputed embeddings (``cfg.embed_input``: the prefill
batch's ``inputs_embeds``); its decode steps embed tokens. Params keep
the reference's tree: leaf names and a stacked leading layer axis
(``params["layers"][name][i]`` is layer i), so the codec writes the same
bytes in the same order. The reference's ``jax.lax.scan`` over layers is
a Python loop here. Prefill and decode run under
``torch.inference_mode()``; prefill writes each layer's cache slice into
a preallocated cache, and `decode_step` updates the cache's leaves
(``k``, ``v``, ``slot_pos``, ``conv``, ``ssm``) IN PLACE and returns a
dict that shares them (the reference returns a new cache).
``plain=True`` runs the kernels' plain versions instead of the kernels
(attention and the selective scan), on any device. The moe family's
prefill layers dispatch by ``cfg.moe_impl`` and its decode layers always
run the dropless `moe_dense`, as the reference's do.

Serving on a mesh (every family; an encoder-decoder's steps are
`repro_torch.models.encdec`'s): `prefill` and `decode_step` take
a serving placement ``tp`` (``launch.sharding.serve_placement``) and run
on this rank's shards under the reference's serving shardings: params
and batch (tokens, or the vlm family's ``inputs_embeds``) as in
training (the experts over ``model``, or the
fallback's layout), the prefill cache W over ``model``, the decode
cache head_dim over ``model`` (`kv_cache.to_decode_layout` moves one to
the other), the conv and ssm states d_inner over ``model`` in both, the
logits vocab over ``model`` (whole where ``model`` does not divide it,
as internvl2-2b's odd vocab). A batch the data axes do not divide (B 1
of ``long_500k``) is replicated over them, and the moe family then
routes this rank's rows as the whole batch (`moe.moe_sorted`).

Training: `forward_train` runs the stack without a cache and with grad
enabled, each layer under the remat policy ``cfg.remat_policy``
(`checkpoint_layer`: "none", "full", or "dots", which saves the outputs
of the projection products as the reference's
``dots_with_no_batch_dims_saveable`` does), then `chunked_ce_loss`. On
the card the attention's gradient is its hand-written backward kernel
(`repro_torch.kernels.flash_attention.ops.mha`) and the selective scan's
is its own (`repro_torch.kernels.ssm_scan.ops.selective_scan`), so every
family trains there; on the CPU the same autograd Functions run the
plain versions.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import kv_cache as kvc
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
#: the families whose layers are the dense decoder's
DENSE = ("dense", "vlm")
LOSS_CHUNK = 2048
REMAT_POLICIES = ("none", "dots", "full")
#: the products the "dots" policy saves: matrix products without batch
#: dimensions (an (B, S, D) @ (D, F) projection reaches the dispatcher as
#: one ``mm``); batched products (attention's, the experts') recompute
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def check_supported(cfg) -> None:
    """Raise for a family the port does not have; an encoder-decoder runs
    through `repro_torch.models.encdec`, whatever its family."""
    if cfg.family not in FAMILIES and not cfg.is_encoder_decoder:
        raise NotImplementedError(f"family {cfg.family!r} is not ported")


# ------------------------------------------------------------------- params

def init_layer_params(generator, cfg, dtype, device=None):
    fam = cfg.family
    ones = dict(dtype=dtype, device=device if device is not None
                else generator.device)
    p = {"ln1": torch.ones((cfg.d_model,), **ones)}
    if fam in DENSE + ("moe", "hybrid"):
        p["attn"] = L.init_attention(generator, cfg, dtype, device)
        p["ln2"] = torch.ones((cfg.d_model,), **ones)
    if fam in DENSE + ("hybrid",):
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device)
    if fam == "moe":
        p["moe"] = MOE.init_moe(generator, cfg, dtype, device)
    if fam in ("ssm", "hybrid"):
        p["mamba"] = M.init_mamba(generator, cfg, dtype, device)
    if fam == "hybrid":
        p["bn_attn"] = torch.ones((cfg.d_model,), **ones)
        p["bn_mamba"] = torch.ones((cfg.d_model,), **ones)
    return p


def _stack_into(stacked, layer, i):
    for name, leaf in layer.items():
        if isinstance(leaf, dict):
            _stack_into(stacked[name], leaf, i)
        else:
            stacked[name][i].copy_(leaf)


def _empty_stacked(layer, n):
    return {name: (_empty_stacked(leaf, n) if isinstance(leaf, dict)
                   else leaf.new_empty((n,) + tuple(leaf.shape)))
            for name, leaf in layer.items()}


def init_stack(init_layer, generator, cfg, n, dtype, device):
    """``n`` layers of ``init_layer`` drawn one at a time into a stacked
    tree, so peak memory is the stack plus one layer; on the meta device
    the tree of structs, from one layer's shapes."""
    stacked = None
    for i in range(n):
        layer = init_layer(generator, cfg, dtype, device)
        if stacked is None:
            stacked = _empty_stacked(layer, n)
        if device.type == "meta":
            break
        _stack_into(stacked, layer, i)
    return stacked


def init_params(generator, cfg, device=None):
    """Seeded init from ``generator`` on its device.

    Layers are drawn one at a time into the stacked tree (`init_stack`).
    On the meta device (``generator=None, device="meta"``) it returns the
    tree of structs.
    """
    check_supported(cfg)
    dtype = DTYPES[cfg.param_dtype]
    device = generator.device if device is None else torch.device(device)
    embed = L.dense_init(generator, (cfg.vocab_size, cfg.d_model), 1, dtype,
                         device)
    params = {
        "embed": embed,
        "layers": init_stack(init_layer_params, generator, cfg,
                             cfg.num_layers, dtype, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), 0, dtype, device)
    return params


def param_structs(cfg):
    """The params tree as meta tensors: shapes and dtypes, no data."""
    return init_params(None, cfg, device="meta")


def layer_params(layers, i):
    """Layer i of the stacked tree."""
    return {name: (layer_params(leaf, i) if isinstance(leaf, dict)
                   else leaf[i])
            for name, leaf in layers.items()}


# ----------------------------------------------------------------- sublayers

def _fuse(cfg, lp, attn_out, m_out):
    """Hymba's head fusion: the mean of the two normed branches."""
    return 0.5 * (L.rms_norm(attn_out, lp["bn_attn"], cfg.norm_eps)
                  + L.rms_norm(m_out, lp["bn_mamba"], cfg.norm_eps))


def _seq_sublayers(cfg, lp, x, plain=False, tp=None, train=False):
    """One layer over a full sequence. Returns (x, cache_out, aux): the
    layer's ``k``/``v`` and/or ``conv``/``ssm``, and the moe family's
    load-balancing loss (None for the others). A ``moe_impl`` of
    "local" runs `moe_local` in a prefill and the global `moe_sorted` in
    training (``train``), as the reference's does (on one device the
    two are the same). With ``tp`` (on a mesh) attention, the Mamba
    block, the MLP and the experts run on this rank's share
    (`layers.attention_layer`, `mamba.mamba_layer`, `moe.moe_layer`),
    each branch summed over ``model`` before hymba's fusion, and in
    training the moe loss is this rank's share of the whole batch's."""
    fam = cfg.family
    cache_out, aux = {}, None
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if fam in DENSE + ("moe",):
        attn_out, (cache_out["k"], cache_out["v"]) = L.attention_layer(
            lp["attn"], cfg, h, plain=plain, tp=tp)
        x = x + attn_out
    elif fam == "ssm":
        m_out, st = M.mamba_layer(lp["mamba"], cfg, h, plain=plain, tp=tp)
        cache_out.update(st)
        return x + m_out, cache_out, aux           # mamba block has no MLP
    else:                                          # hybrid
        attn_out, (cache_out["k"], cache_out["v"]) = L.attention_layer(
            lp["attn"], cfg, h, plain=plain, tp=tp)
        m_out, st = M.mamba_layer(lp["mamba"], cfg, h, plain=plain, tp=tp)
        cache_out.update(st)
        x = x + _fuse(cfg, lp, attn_out, m_out)
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if fam == "moe":
        moe_out, aux = MOE.moe_layer(lp["moe"], cfg, h2, tp, train)
        return x + moe_out, cache_out, aux
    return x + L.mlp_layer(lp["mlp"], h2, tp), cache_out, aux


def _decode_sublayers(cfg, lp, x, cache, i, slot_pos, pos, plain=False,
                      tp=None):
    """One layer, one token; writes its K/V and SSM state into layer i of
    the cache, in place. With ``tp`` (a serving placement) attention, the
    Mamba step, the MLP and the experts run on this rank's share, each
    branch summed over ``model`` before hymba's fusion, the cache in the
    decode layout (`layers.attention_decode_layer`;
    `mamba.mamba_decode_step` on the rank's conv and ssm shards; the
    dropless `moe.moe_dense` on the rank's experts, with no count
    gather: the step throws its loss away, as the reference's does)."""
    fam = cfg.family
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if fam in DENSE + ("moe", "hybrid"):
        attn_out, _ = L.attention_decode_layer(
            lp["attn"], cfg, h, cache["k"][i], cache["v"][i], slot_pos, pos,
            plain=plain, tp=tp)
    if fam in ("ssm", "hybrid"):
        m_out, st = M.mamba_decode_step(
            lp["mamba"], cfg, h, {"conv": cache["conv"][i],
                                  "ssm": cache["ssm"][i]}, tp=tp)
        cache["conv"][i].copy_(st["conv"])
        cache["ssm"][i].copy_(st["ssm"])
    if fam == "ssm":
        return x + m_out
    x = x + (_fuse(cfg, lp, attn_out, m_out) if fam == "hybrid"
             else attn_out)
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if fam == "moe":
        # T = B tokens: the dropless dense dispatch, whatever moe_impl says
        return x + MOE.moe_dense(lp["moe"], cfg, h2, tp, gather=False)[0]
    return x + L.mlp_layer(lp["mlp"], h2, tp)


# ------------------------------------------------------------------- stacks

def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint_layer(policy, fn, *args):
    """``fn(*args)`` under a remat policy, when grad is enabled (else a
    plain call): "none" keeps every activation, "full" keeps only the
    inputs and recomputes the layer in the backward pass, "dots" keeps
    the products of `_DOTS` too (`torch.utils.checkpoint` without
    reentrancy; a selective checkpoint for "dots"). The loss and the
    gradients are the same under all three."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} is not one of "
                         f"{REMAT_POLICIES}")
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    contexts = functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


def run_stack(cfg, params, x, cache=None, plain=False, tp=None):
    """Run the layer stack over a full sequence. With ``cache`` (prefill)
    each layer's slice of it is written (on a mesh, ``tp``, this rank's
    shard of the prefill layout, `kv_cache.write_prefill_on_mesh`, each
    kv head sent by the first rank that holds it); without (training)
    nothing is, and each layer runs under `checkpoint_layer` (on a mesh
    its weights' gathers inside it, so the recompute gathers again).
    Returns the final-normed hidden states and, in training, the sum of
    the layers' moe losses (a 0-d f32 tensor; None in prefill)."""
    aux = (torch.zeros((), dtype=torch.float32, device=x.device)
           if cache is None else None)
    if cache is not None and tp is not None and "k" in cache:
        heads = L.mesh_heads(tp, cfg)
        me = heads[tp.mesh.coords["model"]]
        own = slice(me.o0 - me.k0, me.o1 - me.k0)
        counts = [r.o1 - r.o0 for r in heads]
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        if cache is None:
            x, aux_l = checkpoint_layer(cfg.remat_policy, _train_layer, cfg,
                                        lp, x, plain, tp)
            if aux_l is not None:
                aux = aux + aux_l
            continue
        x, out, _ = _seq_sublayers(cfg, lp, x, plain=plain, tp=tp)
        if "k" in out and tp is not None:
            for name in ("k", "v"):
                kvc.write_prefill_on_mesh(cache[name][i],
                                          out[name][:, :, own], tp, counts)
        elif "k" in out:                  # into the (ring) cache slice
            kvc.write_prefill_entries(cache["k"][i], out["k"])
            kvc.write_prefill_entries(cache["v"][i], out["v"])
        if "ssm" in out:
            cache["conv"][i].copy_(out["conv"])
            cache["ssm"][i].copy_(out["ssm"])
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _train_layer(cfg, lp, x, plain, tp=None):
    x, _, aux = _seq_sublayers(cfg, lp, x, plain=plain, tp=tp, train=True)
    return x, aux


def run_stack_decode(cfg, params, x, cache, pos, plain=False, tp=None):
    """Run the stack for one decode token; cache leaves have leading L.

    Where the cache has ``slot_pos``, it gets this token's position in
    slot ``pos % W`` first (every layer writes the same slot), all in
    place on the device. With ``tp`` the cache is this rank's shard of
    the decode layout (`_decode_sublayers`).
    """
    slot_pos = cache.get("slot_pos")
    if slot_pos is not None:
        W = slot_pos.shape[1]
        b_idx = torch.arange(slot_pos.shape[0], device=slot_pos.device)
        slot_pos[b_idx, (pos % W).long()] = pos
    for i in range(cfg.num_layers):
        x = _decode_sublayers(cfg, layer_params(params["layers"], i), x,
                              cache, i, slot_pos, pos, plain=plain, tp=tp)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), new_cache


# ------------------------------------------------------------------ top-level

def _lm_head(cfg, params, tp=None, whole=False):
    """The (D, V) head; with ``tp`` this rank's vocab columns [v0, v1)
    (``tp.split(V)``), or with ``whole`` every column, whole along D."""
    if tp is None:
        return params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    v0, v1 = (0, cfg.vocab_size) if whole else tp.split(cfg.vocab_size)
    if cfg.tie_embeddings:
        return tp.weight(params["embed"], "embed", 0, v0, v1).T
    return tp.weight(params["lm_head"], "lm_head", 1, v0, v1)


def embed_tokens(cfg, params, tokens, tp=None):
    """The tokens' rows of the embedding; with ``tp`` vocab-parallel
    where the embedding's vocab is split over ``model``: this rank looks
    up the tokens in its rows [v0, v1), zero elsewhere, and the sum over
    ``model`` is the embedding. Where the guard leaves the vocab whole
    (``model`` does not divide it) every rank looks the tokens up in its
    own copy, and nothing is sent."""
    if tp is None:
        return params["embed"][tokens]
    if tp.specs["embed"][0] != "model":
        return tp.weight(params["embed"], "embed", 0, 0,
                         cfg.vocab_size)[tokens]
    v0, v1 = tp.split(cfg.vocab_size)
    rows = tp.weight(params["embed"], "embed", 0, v0, v1)
    local = tokens.long() - v0
    inside = (local >= 0) & (local < v1 - v0)
    e = rows[local.clamp(0, v1 - v0 - 1)]
    return tp.reduce(torch.where(inside[..., None], e, torch.zeros_like(e)))


def _chunk_nll(h, t, head):
    """The summed negative log-likelihood of one chunk and its count of
    valid targets (targets < 0 are padding)."""
    logits = (h @ head).float()                         # (B, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, t.clamp_min(0).long()[..., None])[..., 0]
    valid = (t >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def _chunk_nll_on_mesh(h, t, head, tp, v0):
    """`_chunk_nll` on this rank's vocab columns [v0, v0 + Vl): the row
    max over ``model`` (no gradient), the sum of exponentials summed over
    ``model`` (`Sharded.reduce`), the gold logit from the rank whose
    columns hold it."""
    logits = (h @ head).float()                         # (B, chunk, Vl)
    vl = logits.shape[-1]
    m = tp.max(logits.detach().amax(dim=-1))
    lse = m + tp.reduce(torch.exp(logits - m[..., None]).sum(dim=-1)).log()
    local = t.long() - v0
    inside = (local >= 0) & (local < vl)
    gold = logits.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
    gold = tp.reduce(torch.where(inside, gold, torch.zeros_like(gold)))
    valid = (t >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def chunked_ce_loss(cfg, params, hidden, targets, chunk=LOSS_CHUNK, tp=None):
    """Cross-entropy without materialising the full (B, S, V) logits:
    ``chunk`` positions at a time, targets padded with -1, logsumexp in
    f32, as the reference's. Each chunk is checkpointed when grad is
    enabled, so its f32 logits are recomputed in the backward pass
    rather than kept. With ``tp`` the head is vocab-parallel
    (`_chunk_nll_on_mesh`) and the count of valid targets is summed over
    the data axes before the division: the result is this rank's share
    of the global batch's mean, and the shares sum to it."""
    B, S, D = hidden.shape
    head = _lm_head(cfg, params, tp)
    if tp is not None:
        v0 = tp.split(cfg.vocab_size)[0]
        hidden = tp.copy(hidden)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    fn, extra = ((_chunk_nll, ()) if tp is None
                 else (_chunk_nll_on_mesh, (tp, v0)))
    for c0 in range(0, hidden.shape[1], chunk):
        h, t = hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
        nll, n = (checkpoint(fn, h, t, head, *extra, use_reentrant=False)
                  if torch.is_grad_enabled() else fn(h, t, head, *extra))
        tot, cnt = tot + nll, cnt + n
    if tp is not None:
        cnt = tp.sum_data(cnt)
    return tot / cnt.clamp_min(1.0)


#: the families whose serving steps on a mesh are still to be ported, by
#: the ROADMAP item (Queue 1) that ports each: none since item 11d
SERVE_MESH_ITEMS: dict[str, str] = {}


def check_mesh(cfg, tp, serve: bool = False) -> None:
    """Exit for a config the reference does not train on a mesh of more
    than one rank: an enc-dec or vlm config, which its driver refuses.
    With ``serve`` (a prefill or decode step, which every family runs on
    a mesh) raise instead for a head_dim or d_inner that ``model`` does
    not divide (the decode cache's rules leave it whole): nothing runs
    half-sharded."""
    if tp is None:
        return
    if serve:
        _check_serve_split(cfg, tp)
        return
    if cfg.is_encoder_decoder or cfg.embed_input:
        raise SystemExit(f"{cfg.name}: the reference trains no enc-dec or "
                         f"vlm config on a mesh (its driver refuses them)")


def _check_serve_split(cfg, tp) -> None:
    """Raise where ``model`` (more than one rank) does not split the
    decode cache's head_dim (k and an encoder-decoder's cross_k:
    (L, B, W, K, hd)) or d_inner (ssm: (L, B, di, N)), naming the leaf
    and its shape: before any work of the step."""
    M = tp.mesh.shape["model"]
    for name, dim, what in (("k", 4, "head_dim"), ("cross_k", 4, "head_dim"),
                            ("ssm", 2, "d_inner")):
        path = f"cache/decode/{name}"
        if M > 1 and path in tp.specs and tp.specs[path][dim] != "model":
            raise NotImplementedError(
                f"{cfg.name}: the decode cache's {name} "
                f"{tp.shapes[path]} has a {what} of {tp.shapes[path][dim]}, "
                f"which model {M} does not split")


def forward_train(cfg, params, batch, plain=False, tp=None):
    """Returns (loss, metrics): the mean next-token cross-entropy of
    ``batch["targets"]`` plus the moe family's load-balancing loss, and
    ``{"ce_loss", "aux_loss"}``. batch: ``tokens`` (or with
    ``cfg.embed_input`` ``inputs_embeds``) and ``targets``. Runs with
    grad as the caller has it (never under inference mode), no cache.

    ``tp`` (a `repro_torch.parallel.placement.Sharded` on a mesh of more
    than one rank; the dense, moe, ssm and hybrid families,
    `check_mesh`): ``params`` are this rank's shards and ``batch`` its
    slice of the global batch, its rows split over the data axes;
    the loss is this rank's share of the global batch's mean (the shares
    over the data axes sum to it, and every rank of ``model`` holds the
    same), the moe family's load-balancing loss its share of the whole
    batch's (`moe.moe_sorted`), and ``ce_loss`` and ``aux_loss`` are the
    global values."""
    check_supported(cfg)
    check_mesh(cfg, tp)
    if cfg.embed_input:
        x = batch["inputs_embeds"].to(DTYPES[cfg.dtype])
    else:
        x = embed_tokens(cfg, params, batch["tokens"], tp)
    hidden, aux = run_stack(cfg, params, x, plain=plain, tp=tp)
    loss = chunked_ce_loss(cfg, params, hidden, batch["targets"], tp=tp)
    metrics = {"ce_loss": loss, "aux_loss": aux}
    if tp is not None:
        metrics["ce_loss"] = tp.sum_data(loss)
        if cfg.family == "moe":
            metrics["aux_loss"] = tp.sum_data(aux)
    return loss + aux, metrics


@torch.inference_mode()
def prefill(cfg, params, batch, cache_len=None, plain=False, tp=None):
    """Process the prompt (``batch["tokens"]``, or with
    ``cfg.embed_input`` ``batch["inputs_embeds"]`` (B, S, D) cast to
    ``cfg.dtype``); returns (last-token logits, decode cache).

    Without ``cache_len`` the cache is exactly S wide, as in the
    reference, so the first decode step overwrites slot 0 (position 0).

    ``tp`` (a serving placement, ``launch.sharding.serve_placement``, of
    this cache's whole shape; every family): ``params`` are this rank's
    shards and ``batch`` its rows, ``tokens`` or ``inputs_embeds`` (split
    over the data axes where they divide B, else every row);
    the moe layers dispatch by ``moe_impl`` ("local": each data rank's
    rows in a capacity of their own); the cache is this rank's shard of
    the prefill layout (W over ``model``, the conv and ssm states
    d_inner over ``model``; `kv_cache.to_decode_layout` moves it to the
    decode layout) and the logits its shard under ``logits_spec`` (its
    vocab columns where ``model`` divides V, else every column).
    """
    check_supported(cfg)
    check_mesh(cfg, tp, serve=True)
    if cfg.embed_input:
        x = batch["inputs_embeds"].to(DTYPES[cfg.dtype])
    else:
        x = embed_tokens(cfg, params, batch["tokens"], tp)
    B, S = x.shape[:2]
    W = kvc.cache_width(cfg, max(cache_len or S, S))
    if tp is None:
        cache = kvc.init_cache(cfg, B, W, dtype=x.dtype, device=x.device)
    else:
        k = tp.shapes.get("cache/prefill/k")
        if k and k[2] != W:
            raise ValueError(f"the placement's cache is {k[2]} slots wide, "
                             f"this prefill's {W}")
        cache = kvc.init_cache_on_mesh(cfg, tp, "prefill", dtype=x.dtype,
                                       device=x.device)
    hidden, _ = run_stack(cfg, params, x, cache, plain=plain, tp=tp)
    logits = (hidden[:, -1:] @ _serve_head(cfg, params, tp)).float()
    cache["pos"].fill_(S)
    if "slot_pos" in cache:
        cache["slot_pos"] = kvc.prefill_slot_pos(S, W, B, device=x.device)
    return logits, cache


def _serve_head(cfg, params, tp):
    """The head a serving step's logits come from: on a mesh this rank's
    vocab columns where ``logits_spec`` splits V over ``model``, else
    every column."""
    if tp is None:
        return _lm_head(cfg, params)
    return _lm_head(cfg, params, tp, whole=tp.specs["logits"][2] != "model")


@torch.inference_mode()
def decode_step(cfg, params, cache, token, plain=False, tp=None):
    """One token: (B, 1) int32 -> (logits (B, 1, V) f32, cache).

    The cache is updated in place; see the module docstring. With ``tp``
    (`prefill`'s) the cache is this rank's shard of the decode layout
    (head_dim over ``model``) and ``token`` its rows; the moe layers run
    the dropless `moe.moe_dense` on the rank's experts; the logits as
    `prefill`'s.
    """
    check_supported(cfg)
    check_mesh(cfg, tp, serve=True)
    x = embed_tokens(cfg, params, token, tp)
    hidden, new_cache = run_stack_decode(cfg, params, x, cache, cache["pos"],
                                         plain=plain, tp=tp)
    logits = (hidden @ _serve_head(cfg, params, tp)).float()
    return logits, new_cache
