"""KV and SSM cache containers.

The counterpart of ``repro.models.kv_cache``: plain dicts of tensors with
a leading layer axis. ``slot_pos`` holds the absolute position stored in
each ring slot (-1 = empty), which makes masking exact for full and ring
caches alike. The SSM families keep a bf16 conv tail and an f32 state
per layer; the ssm family has no ``slot_pos``.

On a mesh (``tp``: a serving placement,
``repro_torch.launch.sharding.serve_placement``) each rank holds its
shard of every leaf in one of the reference's two layouts: "prefill",
k and v (L, B / data, W / model, K, hd), and "decode", (L, B / data, W,
K, hd / model), an encoder-decoder's cross_k and cross_v alike with the
source's Ss in place of W; ``pos`` and ``slot_pos`` split over the data
axes alike (`init_cache_on_mesh`). A prefill writes its layers' K/V into
the prefill layout (`write_prefill_on_mesh`) and `to_decode_layout`
moves the cache to the decode layout once a request.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import collectives as C
from repro_torch.parallel.placement import shard_shape

ATTN_FAMILIES = ("dense", "vlm", "moe", "audio", "hybrid")
SSM_FAMILIES = ("ssm", "hybrid")


def cache_width(cfg, seq_len: int) -> int:
    """Ring-buffer width: full seq for dense, window-bounded for SWA."""
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_attn_cache(cfg, batch, seq_len, dtype=torch.bfloat16,
                    device="cpu"):
    L = cfg.num_layers
    W = cache_width(cfg, seq_len)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((L, batch, W, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((L, batch, W, K, hd), dtype=dtype, device=device),
    }


def init_ssm_cache(cfg, batch, device="cpu"):
    """The conv tail in bf16 whatever the model's dtype, as the
    reference's `mamba_layer` and `mamba_decode_step` return it; the state
    in f32."""
    L = cfg.num_layers
    di, N, c = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": torch.zeros((L, batch, c - 1, di), dtype=torch.bfloat16,
                            device=device),
        "ssm": torch.zeros((L, batch, di, N), dtype=torch.float32,
                           device=device),
    }


def init_cross_cache(cfg, batch, src_len, dtype=torch.bfloat16,
                     device="cpu"):
    """Cross-attention K/V over the encoded source, per decoder layer."""
    shape = (cfg.num_layers, batch, src_len, cfg.num_kv_heads, cfg.head_dim)
    return {"cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg, batch, seq_len, dtype=torch.bfloat16, device="cpu",
               src_len=None):
    """Full decode cache for one model instance; an encoder-decoder's
    cross K/V are ``src_len`` wide, by default ``seq_len`` as the
    reference's."""
    if cfg.family not in ATTN_FAMILIES + SSM_FAMILIES:
        raise NotImplementedError(f"{cfg.family} caches are not ported")
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.family in ATTN_FAMILIES:
        cache.update(init_attn_cache(cfg, batch, seq_len, dtype=dtype,
                                     device=device))
        W = cache_width(cfg, seq_len)
        cache["slot_pos"] = torch.full((batch, W), -1, dtype=torch.int32,
                                       device=device)
    if cfg.family in SSM_FAMILIES:
        cache.update(init_ssm_cache(cfg, batch, device=device))
    if cfg.is_encoder_decoder:
        cache.update(init_cross_cache(cfg, batch, src_len or seq_len,
                                      dtype=dtype, device=device))
    return cache


def write_prefill_entries(cache_k, k):
    """Write prefill K (B, S, K, hd) into a ring cache (B, W, K, hd).

    Writes IN PLACE and returns ``cache_k`` (the reference returns an
    updated copy).
    """
    W = cache_k.shape[1]
    S = k.shape[1]
    if S <= W:
        cache_k[:, :S] = k
        return cache_k
    # keep the last W positions (ring layout: slot = pos % W)
    slots = torch.arange(S - W, S, device=k.device) % W
    cache_k[:, slots] = k[:, S - W:]
    return cache_k


def prefill_slot_pos(seq_len, width, batch, device="cpu"):
    """slot_pos after a prefill of ``seq_len`` tokens into width-W ring."""
    slots = torch.arange(width, device=device)
    if seq_len <= width:
        pos = torch.where(slots < seq_len, slots, -1)
    else:
        last = seq_len - 1
        # slot s holds the largest position p <= last with p % W == s
        pos = last - ((last - slots) % width)
    return pos.to(torch.int32).expand(batch, width).contiguous()


# ------------------------------------------------------------ on a mesh

def init_cache_on_mesh(cfg, tp, kind: str, dtype=torch.bfloat16,
                       device="cpu"):
    """This rank's shards, in the ``kind`` layout, of the cache whose
    whole shapes the serving placement ``tp`` holds (``cache/{kind}/*``):
    zeros, and ``slot_pos`` -1. B is ``pos``'s; W is ``k``'s where the
    cache has attention (the ssm family's cache has no W), an
    encoder-decoder's source length ``cross_k``'s."""
    B = tp.shapes[f"cache/{kind}/pos"][0]
    k = tp.shapes.get(f"cache/{kind}/k")
    W = k[2] if k else 1                # no leaf of the ssm family's has W
    cross = tp.shapes.get(f"cache/{kind}/cross_k")
    whole = init_cache(cfg, B, W, dtype=dtype, device="meta",
                       src_len=cross[2] if cross else None)
    out = {}
    for name, leaf in whole.items():
        spec = tp.specs[f"cache/{kind}/{name}"]
        shape = shard_shape(tuple(leaf.shape), spec, tp.mesh)
        out[name] = (torch.full(shape, -1, dtype=leaf.dtype, device=device)
                     if name == "slot_pos" else
                     torch.zeros(shape, dtype=leaf.dtype, device=device))
    return out


def write_prefill_on_mesh(cache_k, k, tp, counts, name="k"):
    """Write one layer's prefill K into this rank's shard ``cache_k``
    (B, W / model, K, hd; or (B, W, K, hd) where ``model`` does not
    divide W) of the prefill layout's leaf ``name``, IN PLACE. ``k``
    (B, S, Ko, hd) holds the kv heads this rank is the first to hold,
    ``counts`` every ``model`` rank's Ko: each rank lays its heads into
    the ring of W slots (`write_prefill_entries`) and sends slots
    [j W / model, (j + 1) W / model) to rank j (every slot where W is
    not split), which concatenates the heads in rank order: one
    ``all_to_all``. The cross K/V (``name`` "cross_k", "cross_v") fill
    their Ss slots in order: no ring wraps."""
    W = tp.shapes[f"cache/prefill/{name}"][2]
    ring = k.new_zeros((k.shape[0], W) + tuple(k.shape[2:]))
    write_prefill_entries(ring, k)
    split = 1 if tp.specs[f"cache/prefill/{name}"][2] == "model" else None
    cache_k.copy_(C.all_to_all(ring, tp.mesh, "model", split, 2,
                               recv=counts))
    return cache_k


def to_decode_layout(cache, tp):
    """A prefill-layout cache (this rank's shards) in the decode layout:
    k and v (and an encoder-decoder's cross_k and cross_v), where the
    cache has them, from W (Ss) over ``model`` to head_dim over
    ``model``, one ``all_to_all`` a leaf (the reference's per-request
    reshard), or a local cut where ``model`` does not divide W (Ss).
    ``pos``, ``slot_pos``, ``conv`` and ``ssm`` have one spec in both
    layouts and pass through. Returns a new dict; the prefill leaves can
    be freed."""
    out = dict(cache)
    mesh = tp.mesh
    for name in [n for n in ("k", "v", "cross_k", "cross_v") if n in cache]:
        if tp.specs[f"cache/decode/{name}"][4] != "model":
            raise NotImplementedError(
                f"the decode cache's head_dim {cache[name].shape[4]} does "
                f"not split over model {mesh.shape['model']}")
        x = cache[name]
        if tp.specs[f"cache/prefill/{name}"][2] == "model":
            x = C.all_to_all(x, mesh, "model", 4, 2)
        else:
            part = x.shape[4] // mesh.shape["model"]
            x = x.narrow(4, mesh.coords["model"] * part, part).contiguous()
        out[name] = x
    return out
