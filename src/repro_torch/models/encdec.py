"""Encoder-decoder LM (the SeamlessM4T backbone).

The counterpart of ``repro.models.encdec``. The encoder
takes precomputed frame embeddings (the modality frontend is a stub) and
attends bidirectionally; the decoder is causal self-attention plus
cross-attention over the encoder's output. Positions are additive
sinusoids (no RoPE). Params keep the reference's tree (``enc_layers``
and ``dec_layers`` stacked on a leading layer axis, ``enc_norm`` and an
untied ``lm_head``), so the codec writes the same bytes.

Prefill runs the encoder, then the decoder over the target prefix,
writing each decoder layer's self K/V and cross K/V into a preallocated
cache; `decode_step` updates the cache's ``k``, ``v`` and ``slot_pos`` IN
PLACE and returns a dict that shares its leaves (the reference returns a
new cache). Attention over a sequence (the encoder's, the decoder's and
the prefill cross-attention) runs the prefill kernel, one token's (self
and cross) the decode kernel; ``plain=True`` runs their plain versions,
on any device.

`forward_train` runs the encoder and the teacher-forced decoder with
grad and no cache, each layer under the remat policy
(`repro_torch.models.lm.checkpoint_layer`), then the chunked loss; the
encoder's bidirectional attention and the cross-attention at Sq != Sk
go through the differentiable `mha`, so on the card their gradients are
the backward kernel's. Its aux loss is 0, as the reference's.

Serving on a mesh: `prefill` and `decode_step` take a serving placement
``tp`` (``launch.sharding.serve_placement`` of a cache whose cross
leaves are the source's Ss wide) and run on this rank's shards under the
reference's serving shardings, as `repro_torch.models.lm`'s do: the
encoder, the decoder's self-attention, its cross-attention and the MLPs
on the rank's heads and d_ff columns (`layers` with the paths
``enc_layers/*`` and ``dec_layers/*``), the batch's rows split over the
data axes where they divide it; the self and cross K/V written into the
prefill layout (W and Ss over ``model``) and, after
`kv_cache.to_decode_layout`, read in the decode layout (head_dim over
``model``), the cross-attention's decode step on the head_dim-slice
pair with every slot valid. Training on a mesh exits, as the
reference's `launch/train.py` refuses it.
"""
from __future__ import annotations

import torch

from repro_torch.models import kv_cache as kvc
from repro_torch.models import layers as L
from repro_torch.models.lm import (DTYPES, _serve_head, check_mesh,
                                   checkpoint_layer, chunked_ce_loss,
                                   embed_tokens, init_stack, layer_params)


# ------------------------------------------------------------------- params

def init_enc_layer(generator, cfg, dtype, device=None):
    ones = dict(dtype=dtype, device=device if device is not None
                else generator.device)
    return {
        "ln1": torch.ones((cfg.d_model,), **ones),
        "attn": L.init_attention(generator, cfg, dtype, device),
        "ln2": torch.ones((cfg.d_model,), **ones),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init_dec_layer(generator, cfg, dtype, device=None):
    ones = dict(dtype=dtype, device=device if device is not None
                else generator.device)
    return {
        "ln1": torch.ones((cfg.d_model,), **ones),
        "attn": L.init_attention(generator, cfg, dtype, device),
        "ln_x": torch.ones((cfg.d_model,), **ones),
        "xattn": L.init_attention(generator, cfg, dtype, device),
        "ln2": torch.ones((cfg.d_model,), **ones),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init_params(generator, cfg, device=None):
    """Seeded init from ``generator`` on its device; on the meta device
    (``generator=None, device="meta"``) the tree of structs."""
    dtype = DTYPES[cfg.param_dtype]
    device = generator.device if device is None else torch.device(device)
    embed = L.dense_init(generator, (cfg.vocab_size, cfg.d_model), 1, dtype,
                         device)
    enc = init_stack(init_enc_layer, generator, cfg, cfg.num_encoder_layers,
                     dtype, device)
    dec = init_stack(init_dec_layer, generator, cfg, cfg.num_layers, dtype,
                     device)
    return {
        "embed": embed,
        "enc_layers": enc,
        "dec_layers": dec,
        "enc_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab_size), 0,
                                dtype, device),
    }


def param_structs(cfg):
    """The params tree as meta tensors: shapes and dtypes, no data."""
    return init_params(None, cfg, device="meta")


# ------------------------------------------------------------------ forward

def _add_pos(cfg, x, offset=0):
    """x plus the sinusoid embeddings of positions ``offset + arange(S)``
    (``offset`` an int, or (B, 1) for one token per row), cast to x's
    dtype."""
    positions = offset + torch.arange(x.shape[1], device=x.device)
    return x + L.sinusoid_pos_embed(positions, cfg.d_model).to(x.dtype)


def _enc_layer(cfg, lp, x, plain, tp=None):
    a, _ = L.attention_layer(lp["attn"], cfg,
                             L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                             use_rope=False, causal=False, plain=plain,
                             tp=tp, path="enc_layers/attn")
    x = x + a
    return x + L.mlp_layer(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps),
                           tp, "enc_layers/mlp")


def encode(cfg, params, src_embeds, plain=False, tp=None):
    """src_embeds: (B, Ss, D) -> encoder output (B, Ss, D) in cfg.dtype.
    With ``tp`` (on a mesh) ``src_embeds`` are this data rank's rows and
    each layer runs on the rank's heads and d_ff columns; the output,
    summed over ``model`` after each row-parallel product, is whole on
    every rank of ``model``."""
    x = _add_pos(cfg, src_embeds.to(DTYPES[cfg.dtype]))
    for i in range(cfg.num_encoder_layers):
        x = checkpoint_layer(cfg.remat_policy, _enc_layer, cfg,
                             layer_params(params["enc_layers"], i), x, plain,
                             tp)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(lp, cfg, enc_out, tp=None):
    """Project the encoder's output to this layer's cross K/V; with
    ``tp`` this rank's kv heads of them (`layers.cross_kv_on_mesh`)."""
    if tp is not None:
        return L.cross_kv_on_mesh(lp["xattn"], cfg, enc_out, tp)
    B, Ss, _ = enc_out.shape
    K, hd = cfg.num_kv_heads, cfg.head_dim
    k = (enc_out @ lp["xattn"]["wk"]).reshape(B, Ss, K, hd)
    v = (enc_out @ lp["xattn"]["wv"]).reshape(B, Ss, K, hd)
    return k, v


def _dec_layer(cfg, lp, x, enc_out, plain, tp=None):
    """One decoder layer over the target; returns x and the layer's self
    K/V and cross K/V (on a mesh, of this rank's kv heads)."""
    a, (k, v) = L.attention_layer(lp["attn"], cfg,
                                  L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                                  use_rope=False, plain=plain, tp=tp,
                                  path="dec_layers/attn")
    x = x + a
    ck, cv = _cross_kv(lp, cfg, enc_out, tp)
    x = x + L.cross_attention_layer(
        lp["xattn"], cfg, L.rms_norm(x, lp["ln_x"], cfg.norm_eps), ck, cv,
        plain=plain, tp=tp)
    x = x + L.mlp_layer(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps),
                        tp, "dec_layers/mlp")
    return x, k, v, ck, cv


def decode_seq(cfg, params, tgt_tokens, enc_out, cache=None, plain=False,
               tp=None):
    """Teacher-forced decoder pass over (B, St) tokens; returns the
    final-normed hidden states. With ``cache``, each layer's self K/V go
    into its first St slots and its cross K/V into ``cross_k`` and
    ``cross_v``; on a mesh (``tp``) into this rank's shards of the
    prefill layout (`kv_cache.write_prefill_on_mesh`, each kv head sent
    by the first rank that holds it), the tokens embedded
    vocab-parallel (`lm.embed_tokens`)."""
    x = _add_pos(cfg, embed_tokens(cfg, params, tgt_tokens, tp))
    St = x.shape[1]
    if cache is not None and tp is not None:
        heads = L.mesh_heads(tp, cfg)
        me = heads[tp.mesh.coords["model"]]
        own = slice(me.o0 - me.k0, me.o1 - me.k0)
        counts = [r.o1 - r.o0 for r in heads]
    for i in range(cfg.num_layers):
        x, k, v, ck, cv = checkpoint_layer(
            cfg.remat_policy, _dec_layer, cfg,
            layer_params(params["dec_layers"], i), x, enc_out, plain, tp)
        if cache is not None and tp is not None:
            for name, t in (("k", k), ("v", v), ("cross_k", ck),
                            ("cross_v", cv)):
                kvc.write_prefill_on_mesh(cache[name][i], t[:, :, own], tp,
                                          counts, name)
        elif cache is not None:
            cache["k"][i, :, :St] = k
            cache["v"][i, :, :St] = v
            cache["cross_k"][i] = ck
            cache["cross_v"][i] = cv
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward_train(cfg, params, batch, plain=False, tp=None):
    """Returns (loss, metrics) for ``batch["src_embeds"]`` (B, Ss, D),
    ``batch["tgt_tokens"]`` and ``batch["targets"]`` (B, St); the aux loss
    is 0, as in the reference. A mesh placement ``tp`` of more than one
    rank exits (`lm.check_mesh`), as the reference's driver refuses an
    enc-dec config."""
    check_mesh(cfg, tp)
    enc_out = encode(cfg, params, batch["src_embeds"], plain=plain)
    hidden = decode_seq(cfg, params, batch["tgt_tokens"], enc_out,
                        plain=plain)
    loss = chunked_ce_loss(cfg, params, hidden, batch["targets"])
    return loss, {"ce_loss": loss,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}


@torch.inference_mode()
def prefill(cfg, params, batch, cache_len=None, plain=False, tp=None):
    """Encode ``batch["src_embeds"]`` (B, Ss, D) and run the decoder over
    ``batch["tgt_tokens"]`` (B, St); returns (last-token logits, decode
    cache).

    The self cache is W = ``cache_len or St`` slots wide, zero past St,
    as the reference's; without ``cache_len`` the first decode step
    overwrites slot 0 (position 0), as in the decoder-only case.

    ``tp`` (a serving placement of this cache's whole shape, the cross
    leaves Ss wide): ``params`` are this rank's shards and ``batch`` its
    rows (split over the data axes where they divide B, else every row);
    the cache is this rank's shard of the prefill layout (W and Ss over
    ``model``, or whole where ``model`` does not divide them) and the
    logits its shard under ``logits_spec``, as `lm.prefill`'s.
    """
    check_mesh(cfg, tp, serve=True)
    tgt = batch["tgt_tokens"]
    B, St = tgt.shape
    W = cache_len or St
    if W < St:
        raise ValueError(f"cache_len {W} is shorter than the target prefix "
                         f"{St}")
    enc_out = encode(cfg, params, batch["src_embeds"], plain=plain, tp=tp)
    device = enc_out.device
    if tp is None:
        # self K/V in the decoder's dtype (the embedding's), cross K/V in
        # the encoder's (cfg.dtype), as the reference's
        cache = {"pos": torch.full((B,), St, dtype=torch.int32,
                                   device=device),
                 **kvc.init_attn_cache(cfg, B, W,
                                       dtype=params["embed"].dtype,
                                       device=device),
                 "slot_pos": kvc.prefill_slot_pos(St, W, B, device=device),
                 **kvc.init_cross_cache(cfg, B, enc_out.shape[1],
                                        dtype=enc_out.dtype, device=device)}
    else:
        shapes = (tp.shapes["cache/prefill/k"][2],
                  tp.shapes["cache/prefill/cross_k"][2])
        if shapes != (W, enc_out.shape[1]):
            raise ValueError(f"the placement's cache is {shapes} slots wide "
                             f"(self, cross), this prefill's "
                             f"{(W, enc_out.shape[1])}")
        cache = kvc.init_cache_on_mesh(cfg, tp, "prefill",
                                       dtype=params["embed"].dtype,
                                       device=device)
        for name in ("cross_k", "cross_v"):
            cache[name] = cache[name].to(enc_out.dtype)
        cache["pos"].fill_(St)
        cache["slot_pos"] = kvc.prefill_slot_pos(St, W, B, device=device)
    hidden = decode_seq(cfg, params, tgt, enc_out, cache=cache, plain=plain,
                        tp=tp)
    logits = (hidden[:, -1:] @ _serve_head(cfg, params, tp)).float()
    return logits, cache


@torch.inference_mode()
def decode_step(cfg, params, cache, token, plain=False, tp=None):
    """One decoder token (B, 1) against the self and cross caches ->
    (logits (B, 1, V) f32, cache), the cache updated in place.

    The cross-attention runs the decode kernel with every source slot
    valid: a ``slot_pos`` of ``arange(Ss)`` per row and ``pos = Ss - 1``,
    built once per step; they are not cache leaves. With ``tp``
    (`prefill`'s) the cache is this rank's shard of the decode layout
    (head_dim over ``model``) and ``token`` its rows: self-attention
    through `layers.attention_decode_layer`, cross-attention through
    `layers.cross_attention_decode_layer` on the head_dim-slice pair;
    the logits as `prefill`'s.
    """
    check_mesh(cfg, tp, serve=True)
    pos = cache["pos"]
    B = token.shape[0]
    x = _add_pos(cfg, embed_tokens(cfg, params, token, tp),
                 offset=pos[:, None])
    slot_pos = cache["slot_pos"]
    W = slot_pos.shape[1]
    slot_pos[torch.arange(B, device=pos.device), (pos % W).long()] = pos
    Ss = cache["cross_k"].shape[2]
    every_slot = torch.arange(Ss, dtype=torch.int32, device=pos.device
                              ).expand(B, Ss).contiguous()
    last = torch.full((B,), Ss - 1, dtype=torch.int32, device=pos.device)
    for i in range(cfg.num_layers):
        lp = layer_params(params["dec_layers"], i)
        a, _ = L.attention_decode_layer(
            lp["attn"], cfg, L.rms_norm(x, lp["ln1"], cfg.norm_eps),
            cache["k"][i], cache["v"][i], slot_pos, pos, use_rope=False,
            plain=plain, tp=tp, path="dec_layers/attn")
        x = x + a
        x = x + L.cross_attention_decode_layer(
            lp["xattn"], cfg, L.rms_norm(x, lp["ln_x"], cfg.norm_eps),
            cache["cross_k"][i], cache["cross_v"][i], every_slot, last,
            plain=plain, tp=tp)
        x = x + L.mlp_layer(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps),
                            tp, "dec_layers/mlp")
    logits = (L.rms_norm(x, params["final_norm"], cfg.norm_eps)
              @ _serve_head(cfg, params, tp)).float()
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits, new_cache
