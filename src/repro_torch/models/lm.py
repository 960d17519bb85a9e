"""Decoder-only LM assembly: the dense, moe, ssm and hybrid families.

The counterpart of ``repro.models.lm`` for those families. Params keep
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
"""
from __future__ import annotations

import torch

from repro_torch.models import kv_cache as kvc
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FAMILIES = ("dense", "moe", "ssm", "hybrid")


def check_supported(cfg) -> None:
    """Raise for the parts of the reference the port does not have yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    missing = [f for f in ("attn_bias", "uniform_decode",
                           "embed_input", "is_encoder_decoder")
               if getattr(cfg, f)]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not "
                                  f"ported yet")


# ------------------------------------------------------------------- params

def init_layer_params(generator, cfg, dtype, device=None):
    fam = cfg.family
    ones = dict(dtype=dtype, device=device if device is not None
                else generator.device)
    p = {"ln1": torch.ones((cfg.d_model,), **ones)}
    if fam in ("dense", "moe", "hybrid"):
        p["attn"] = L.init_attention(generator, cfg, dtype, device)
        p["ln2"] = torch.ones((cfg.d_model,), **ones)
    if fam in ("dense", "hybrid"):
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


def init_params(generator, cfg, device=None):
    """Seeded init from ``generator`` on its device.

    Layers are drawn one at a time into the stacked tree, so peak memory
    is the params plus one layer. On the meta device (``generator=None,
    device="meta"``) it returns the tree of structs.
    """
    check_supported(cfg)
    dtype = DTYPES[cfg.param_dtype]
    device = generator.device if device is None else torch.device(device)
    embed = L.dense_init(generator, (cfg.vocab_size, cfg.d_model), 1, dtype,
                         device)
    stacked = None
    for i in range(cfg.num_layers):
        layer = init_layer_params(generator, cfg, dtype, device)
        if stacked is None:
            stacked = _empty_stacked(layer, cfg.num_layers)
        if device.type != "meta":
            _stack_into(stacked, layer, i)
    params = {
        "embed": embed,
        "layers": stacked,
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


def _seq_sublayers(cfg, lp, x, plain=False):
    """One layer over a full sequence. Returns (x, cache_out) with the
    layer's ``k``/``v`` and/or ``conv``/``ssm``."""
    fam = cfg.family
    cache_out = {}
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if fam in ("dense", "moe"):
        attn_out, (cache_out["k"], cache_out["v"]) = L.attention_layer(
            lp["attn"], cfg, h, plain=plain)
        x = x + attn_out
    elif fam == "ssm":
        m_out, st = M.mamba_layer(lp["mamba"], cfg, h, plain=plain)
        cache_out.update(st)
        return x + m_out, cache_out                # mamba block has no MLP
    else:                                          # hybrid
        attn_out, (cache_out["k"], cache_out["v"]) = L.attention_layer(
            lp["attn"], cfg, h, plain=plain)
        m_out, st = M.mamba_layer(lp["mamba"], cfg, h, plain=plain)
        cache_out.update(st)
        x = x + _fuse(cfg, lp, attn_out, m_out)
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if fam == "moe":
        return x + MOE.moe_layer(lp["moe"], cfg, h2)[0], cache_out
    return x + L.mlp_layer(lp["mlp"], h2), cache_out


def _decode_sublayers(cfg, lp, x, cache, i, slot_pos, pos, plain=False):
    """One layer, one token; writes its K/V and SSM state into layer i of
    the cache, in place."""
    fam = cfg.family
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if fam in ("dense", "moe", "hybrid"):
        attn_out, _ = L.attention_decode_layer(
            lp["attn"], cfg, h, cache["k"][i], cache["v"][i], slot_pos, pos,
            plain=plain)
    if fam in ("ssm", "hybrid"):
        m_out, st = M.mamba_decode_step(
            lp["mamba"], cfg, h, {"conv": cache["conv"][i],
                                  "ssm": cache["ssm"][i]})
        cache["conv"][i].copy_(st["conv"])
        cache["ssm"][i].copy_(st["ssm"])
    if fam == "ssm":
        return x + m_out
    x = x + (_fuse(cfg, lp, attn_out, m_out) if fam == "hybrid"
             else attn_out)
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if fam == "moe":
        # T = B tokens: the dropless dense dispatch, whatever moe_impl says
        return x + MOE.moe_dense(lp["moe"], cfg, h2)[0]
    return x + L.mlp_layer(lp["mlp"], h2)


# ------------------------------------------------------------------- stacks

def run_stack(cfg, params, x, cache, plain=False):
    """Run the layer stack over a full sequence, writing each layer's
    slice of ``cache``. Returns the final-normed hidden states."""
    for i in range(cfg.num_layers):
        x, out = _seq_sublayers(cfg, layer_params(params["layers"], i), x,
                                plain=plain)
        if "k" in out:                    # into the (ring) cache slice
            kvc.write_prefill_entries(cache["k"][i], out["k"])
            kvc.write_prefill_entries(cache["v"][i], out["v"])
        if "ssm" in out:
            cache["conv"][i].copy_(out["conv"])
            cache["ssm"][i].copy_(out["ssm"])
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def run_stack_decode(cfg, params, x, cache, pos, plain=False):
    """Run the stack for one decode token; cache leaves have leading L.

    Where the cache has ``slot_pos``, it gets this token's position in
    slot ``pos % W`` first (every layer writes the same slot), all in
    place on the device.
    """
    slot_pos = cache.get("slot_pos")
    if slot_pos is not None:
        W = slot_pos.shape[1]
        b_idx = torch.arange(slot_pos.shape[0], device=slot_pos.device)
        slot_pos[b_idx, (pos % W).long()] = pos
    for i in range(cfg.num_layers):
        x = _decode_sublayers(cfg, layer_params(params["layers"], i), x,
                              cache, i, slot_pos, pos, plain=plain)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), new_cache


# ------------------------------------------------------------------ top-level

def _lm_head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def embed_tokens(cfg, params, tokens):
    return params["embed"][tokens]


@torch.inference_mode()
def prefill(cfg, params, batch, cache_len=None, plain=False):
    """Process the prompt; returns (last-token logits, decode cache).

    Without ``cache_len`` the cache is exactly S wide, as in the
    reference, so the first decode step overwrites slot 0 (position 0).
    """
    check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    W = kvc.cache_width(cfg, max(cache_len or S, S))
    cache = kvc.init_cache(cfg, B, W, dtype=x.dtype, device=x.device)
    hidden = run_stack(cfg, params, x, cache, plain=plain)
    logits = (hidden[:, -1:] @ _lm_head(cfg, params)).float()
    cache["pos"].fill_(S)
    if "slot_pos" in cache:
        cache["slot_pos"] = kvc.prefill_slot_pos(S, W, B, device=x.device)
    return logits, cache


@torch.inference_mode()
def decode_step(cfg, params, cache, token, plain=False):
    """One token: (B, 1) int32 -> (logits (B, 1, V) f32, cache).

    The cache is updated in place; see the module docstring.
    """
    check_supported(cfg)
    x = embed_tokens(cfg, params, token)
    hidden, new_cache = run_stack_decode(cfg, params, x, cache, cache["pos"],
                                         plain=plain)
    logits = (hidden @ _lm_head(cfg, params)).float()
    return logits, new_cache
