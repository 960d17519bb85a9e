"""The port's dense layers and cache helpers against repro.models.

Inputs are drawn with numpy from a seed and handed to both packages; bf16
inputs are rounded from the same f32 draws on both sides. Tolerances as
in tests/test_kernels.py: fp32 2e-5, bf16 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import kv_cache as ref_kvc
from repro.models import layers as ref_layers
from repro_torch.models import kv_cache as kvc
from repro_torch.models import layers

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a, dtype):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.array(a)).to(td)


def _close(ref, out, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


def _cfg(**kw):
    return ref_registry.get_smoke("llama3-8b").replace(**kw)


def _params(rng, shapes, scale=0.1):
    return {k: rng.standard_normal(s).astype(np.float32) * scale
            for k, s in shapes.items()}


def _attn_params(rng, cfg):
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return _params(rng, {"wq": (D, H * hd), "wk": (D, K * hd),
                         "wv": (D, K * hd), "wo": (H * hd, D)})


def _split(tree, dtype):
    ref = {k: _pair(v, dtype)[0] for k, v in tree.items()}
    port = {k: _pair(v, dtype)[1] for k, v in tree.items()}
    return ref, port


def ring_slot_pos(W, fill, B):
    slots = np.arange(W)
    if fill <= W:
        sp = np.where(slots < fill, slots, -1)
    else:
        last = fill - 1
        sp = last - ((last - slots) % W)
    return np.broadcast_to(sp.astype(np.int32), (B, W)).copy()


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x, s = rng.standard_normal((2, 8, 64)), rng.standard_normal(64)
    (jx, tx), (js, ts) = _pair(x, dtype), _pair(s, dtype)
    _close(ref_layers.rms_norm(jx, js, 1e-6), layers.rms_norm(tx, ts, 1e-6),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("decode", [False, True])
def test_apply_rope(dtype, decode):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1 if decode else 16, 4, 32))
    pos = (np.array([[40], [7]], np.int32) if decode
           else np.arange(16, dtype=np.int32)[None])
    jx, tx = _pair(x, dtype)
    _close(ref_layers.apply_rope(jx, jnp.asarray(pos), 500_000.0),
           layers.apply_rope(tx, torch.from_numpy(pos), 500_000.0), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_attention(dtype):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(s) for s in
               ((2, 16, 4, 32), (2, 16, 2, 32), (2, 16, 2, 32)))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    mask = np.tril(np.ones((16, 16), bool))[None, None, None]
    _close(ref_layers.full_attention(jq, jk, jv, jnp.asarray(mask)),
           layers.full_attention(tq, tk, tv, torch.from_numpy(mask)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,fill", [(0, 20), (8, 40)])
def test_decode_attention(dtype, window, fill):
    rng = np.random.default_rng(3)
    B, W = 2, 24
    q, kc, vc = (rng.standard_normal(s) for s in
                 ((B, 1, 4, 32), (B, W, 2, 32), (B, W, 2, 32)))
    sp = ring_slot_pos(W, fill, B)
    pos = np.array([fill - 1, fill - 3], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kc, vc))
    ref = ref_layers.decode_attention(jq, jk, jv, jnp.asarray(sp),
                                      jnp.asarray(pos), window=window)
    out = layers.decode_attention(tq, tk, tv, torch.from_numpy(sp),
                                  torch.from_numpy(pos), window=window)
    _close(ref, out, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 8])
def test_attention_layer(dtype, window):
    """The port's prefill path (the kernel's plain version on CPU)
    against the reference's full (or, with a window, blocked) path."""
    cfg = _cfg(sliding_window=window)
    rng = np.random.default_rng(4)
    jp, tp = _split(_attn_params(rng, cfg), dtype)
    jx, tx = _pair(rng.standard_normal((2, 24, cfg.d_model)), dtype)
    ref_out, (rk, rv) = ref_layers.attention_layer(jp, cfg, jx)
    out, (k, v) = layers.attention_layer(tp, cfg, tx)
    for r, o in ((ref_out, out), (rk, k), (rv, v)):
        _close(r, o, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_decode_layer(dtype):
    cfg = _cfg()
    rng = np.random.default_rng(5)
    B, W, K, hd = 2, 16, cfg.num_kv_heads, cfg.head_dim
    jp, tp = _split(_attn_params(rng, cfg), dtype)
    jx, tx = _pair(rng.standard_normal((B, 1, cfg.d_model)), dtype)
    jk, tk = _pair(rng.standard_normal((B, W, K, hd)), dtype)
    jv, tv = _pair(rng.standard_normal((B, W, K, hd)), dtype)
    pos = np.array([16, 9], np.int32)
    sp = ring_slot_pos(W, 17, B)
    sp[1] = np.where(np.arange(W) <= 9, np.arange(W), -1)
    ref_out, (rk, rv) = ref_layers.attention_decode_layer(
        jp, cfg, jx, jk, jv, jnp.asarray(sp), jnp.asarray(pos))
    out, (k, v) = layers.attention_decode_layer(
        tp, cfg, tx, tk, tv, torch.from_numpy(sp), torch.from_numpy(pos))
    assert k is tk and v is tv                  # written in place
    for r, o in ((ref_out, out), (rk, k), (rv, v)):
        _close(r, o, dtype)


def _qk_norm_params(rng, cfg):
    """Attention params with q/k-norm scales near 1 (Qwen3)."""
    tree = _attn_params(rng, cfg)
    for name in ("q_norm", "k_norm"):
        tree[name] = (1 + 0.1 * rng.standard_normal(cfg.head_dim)).astype(
            np.float32)
    return tree


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_attention_with_qk_norm_matches_reference(dtype):
    cfg = ref_registry.get_smoke("qwen3-moe-30b-a3b")
    jd, td, _ = DTYPES[dtype]
    ref = ref_layers.init_attention(jax.random.PRNGKey(0), cfg, jd)
    out = layers.init_attention(torch.Generator().manual_seed(0), cfg, td)
    assert list(out) == list(ref)
    for name, leaf in ref.items():
        assert tuple(out[name].shape) == leaf.shape, name
        assert out[name].dtype == td, name
    for name in ("q_norm", "k_norm"):
        assert torch.equal(out[name], torch.ones(cfg.head_dim, dtype=td))


@pytest.mark.parametrize("dtype", DTYPES)
def test_project_qkv_with_qk_norm(dtype):
    """q and k RMS-normed over hd per head after the reshape, v not."""
    cfg = ref_registry.get_smoke("qwen3-moe-30b-a3b")
    rng = np.random.default_rng(8)
    jp, tp = _split(_qk_norm_params(rng, cfg), dtype)
    jx, tx = _pair(rng.standard_normal((2, 12, cfg.d_model)), dtype)
    for r, o in zip(ref_layers._project_qkv(jp, cfg, jx),
                    layers._project_qkv(tp, cfg, tx)):
        _close(r, o, dtype)
    q = layers._project_qkv(tp, cfg, tx)[0].float()
    rms = q.div(tp["q_norm"].float()).square().mean(-1).sqrt()
    torch.testing.assert_close(rms, torch.ones_like(rms),
                               atol=DTYPES[dtype][2], rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_layers_with_qk_norm(dtype):
    """Prefill and one decode step of a q/k-normed layer (qwen3-moe smoke,
    hd 16, rope theta 1e6) against the reference."""
    cfg = ref_registry.get_smoke("qwen3-moe-30b-a3b")
    rng = np.random.default_rng(9)
    jp, tp = _split(_qk_norm_params(rng, cfg), dtype)
    jx, tx = _pair(rng.standard_normal((2, 20, cfg.d_model)), dtype)
    ref_out, (rk, rv) = ref_layers.attention_layer(jp, cfg, jx)
    out, (k, v) = layers.attention_layer(tp, cfg, tx)
    for r, o in ((ref_out, out), (rk, k), (rv, v)):
        _close(r, o, dtype)
    B, W, K, hd = 2, 24, cfg.num_kv_heads, cfg.head_dim
    jx1, tx1 = _pair(rng.standard_normal((B, 1, cfg.d_model)), dtype)
    jk, tk = _pair(rng.standard_normal((B, W, K, hd)), dtype)
    jv, tv = _pair(rng.standard_normal((B, W, K, hd)), dtype)
    pos = np.array([20, 30], np.int32)
    sp = np.stack([ring_slot_pos(W, 21, 1)[0], ring_slot_pos(W, 31, 1)[0]])
    ref_out, (rk, rv) = ref_layers.attention_decode_layer(
        jp, cfg, jx1, jk, jv, jnp.asarray(sp), jnp.asarray(pos))
    out, (k, v) = layers.attention_decode_layer(
        tp, cfg, tx1, tk, tv, torch.from_numpy(sp), torch.from_numpy(pos))
    for r, o in ((ref_out, out), (rk, k), (rv, v)):
        _close(r, o, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_layer(dtype):
    rng = np.random.default_rng(6)
    jp, tp = _split(_params(rng, {"w_gate": (64, 96), "w_up": (64, 96),
                                  "w_down": (96, 64)}), dtype)
    jx, tx = _pair(rng.standard_normal((2, 8, 64)), dtype)
    _close(ref_layers.mlp_layer(jp, jx), layers.mlp_layer(tp, tx), dtype)


@pytest.mark.parametrize("S,W", [(10, 16), (16, 16), (40, 16)])
def test_write_prefill_entries(S, W):
    rng = np.random.default_rng(7)
    cache = rng.standard_normal((2, W, 2, 8)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 8)).astype(np.float32)
    ref = ref_kvc.write_prefill_entries(jnp.asarray(cache), jnp.asarray(k),
                                        None)
    out = kvc.write_prefill_entries(torch.from_numpy(cache.copy()),
                                    torch.from_numpy(k))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("S,W", [(10, 16), (16, 16), (40, 16), (33, 8)])
def test_prefill_slot_pos(S, W):
    ref = ref_kvc.prefill_slot_pos(S, W, 3)
    out = kvc.prefill_slot_pos(S, W, 3)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cache_width_and_init_cache_match_reference():
    for cfg in (_cfg(), _cfg(sliding_window=8)):
        assert kvc.cache_width(cfg, 32) == ref_kvc.cache_width(cfg, 32)
        ref = ref_kvc.init_cache(cfg, 2, 32)
        out = kvc.init_cache(cfg, 2, 32)
        assert set(out) == set(ref)
        for name in ref:
            assert tuple(out[name].shape) == ref[name].shape
            np.testing.assert_array_equal(out[name].float().numpy(),
                                          np.asarray(ref[name], np.float32))
