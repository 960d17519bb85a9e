"""The hand-written CUDA kernels against their plain versions, on a card.

Marked ``cuda``: each test skips, with a reason, where there is no CUDA
device (a CUDA kernel has no interpret mode). Run on a machine with an
H100 and nvcc:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Whether there is a card is decided in a fixture, never at import or
collection time, so every worker collects the same tests.
"""
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels.decode_attention import (decode_mha, decode_mha_ref,
                                                  decode_scores_hd,
                                                  decode_scores_hd_ref,
                                                  decode_values_hd,
                                                  decode_values_hd_ref)
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import (mha, mha_bwd, mha_ref,
                                                 mha_ref_bwd,
                                                 mha_ref_with_lse,
                                                 mha_with_lse)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssm_scan import (selective_scan, selective_scan_bwd,
                                          selective_scan_states, ssm_scan_ref,
                                          ssm_scan_ref_bwd)
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models import Model, serving

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: the backward kernel: each gradient's largest error over its largest
#: |value| (f32 sums in another order; bf16 inputs, outputs and dout)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def _close(out, ref, dtype):
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def ring_slot_pos(W, fill, B, device):
    slots = torch.arange(W, device=device)
    if fill <= W:
        sp = torch.where(slots < fill, slots, -1)
    else:
        sp = (fill - 1) - ((fill - 1 - slots) % W)
    return sp.to(torch.int32).expand(B, W).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
    (2, 256, 4, 2, 64, True, 0),
    (1, 128, 4, 4, 64, False, 0),
    (2, 256, 8, 2, 128, True, 96),
    (1, 200, 2, 1, 64, True, 0),
    (1, 192, 6, 3, 32, True, 64),
    (1, 300, 25, 5, 64, True, 128),         # hymba's heads, G = 5
])
def test_flash_attention_matches_plain(card, dtype, B, S, H, K, hd, causal,
                                       window):
    gen = torch.Generator(device=card).manual_seed(0)
    q = _randn(gen, (B, S, H, hd), dtype)
    k, v = (_randn(gen, (B, S, K, hd), dtype) for _ in range(2))
    before = flash_ops.launches
    out = mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    _close(out, mha_ref(q, k, v, causal=causal, window=window), dtype)


@pytest.mark.parametrize("B,S,H,K,hd,window", [
    (1, 2048, 32, 8, 128, 0),               # llama3-8b serve shape
    (1, 2048, 25, 5, 64, 2048),             # hymba-1.5b serve shape
    (1, 3000, 25, 5, 64, 2048),             # hymba, window shorter than S
    (1, 1000, 32, 8, 128, 0),               # ragged S
])
def test_flash_attention_tensor_core_body_at_serve_shapes(card, B, S, H, K,
                                                          hd, window):
    assert flash_ops.body(torch.bfloat16, hd) == "wgmma"
    gen = torch.Generator(device=card).manual_seed(3)
    q = _randn(gen, (B, S, H, hd), torch.bfloat16)
    k, v = (_randn(gen, (B, S, K, hd), torch.bfloat16) for _ in range(2))
    before = flash_ops.launches
    out = mha(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    _close(out, mha_ref(q, k, v, causal=True, window=window), torch.bfloat16)


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 64),
                                      (torch.float32, 64)])
def test_flash_attention_reads_views_of_a_fused_projection(card, dtype, hd):
    """q, k and v as head slices of one (B, S, H + 2K, hd) tensor: the
    kernel reads them through their strides, nothing is copied."""
    B, S, H, K = 2, 700, 8, 2
    gen = torch.Generator(device=card).manual_seed(4)
    qkv = _randn(gen, (B, S, H + 2 * K, hd), dtype)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
    assert not q.is_contiguous()
    before = flash_ops.launches
    out = mha(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    _close(out, mha_ref(q, k, v, causal=True, window=0), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,causal", [(300, 1000, False),
                                          (1000, 300, True),
                                          (77, 77, True),     # under one tile
                                          (50, 90, False)])
def test_flash_attention_queries_and_keys_of_different_lengths(card, dtype,
                                                               Sq, Sk,
                                                               causal):
    gen = torch.Generator(device=card).manual_seed(8)
    q = _randn(gen, (2, Sq, 8, 128), dtype)
    k, v = (_randn(gen, (2, Sk, 2, 128), dtype) for _ in range(2))
    before = flash_ops.launches
    out = mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    _close(out, mha_ref(q, k, v, causal=causal), dtype)


def test_flash_attention_tensor_core_body_rejects_misaligned_views(card):
    gen = torch.Generator(device=card).manual_seed(5)
    wide = _randn(gen, (1, 256, 4, 72), torch.bfloat16)
    k = _randn(gen, (1, 256, 2, 64), torch.bfloat16)
    before = flash_ops.launches
    with pytest.raises(ValueError, match="aligned"):
        mha(wide[..., 1:65], k, k)              # base 2 bytes off
    with pytest.raises(ValueError, match="multiple of 16"):
        odd = _randn(gen, (1, 256, 4, 65), torch.bfloat16)
        mha(odd[..., :64], k, k)                # head stride 130 bytes
    assert flash_ops.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,W,hd,window,fill,pos", [
    (1, 32, 8, 2048, 128, 0, 2049, 2048),   # llama serve shape, B = 1
    (8, 32, 8, 2048, 128, 0, 2049, 2048),   # llama serve shape, B = 8
    (1, 32, 8, 2048, 128, 0, 100, 100),     # whole splits empty
    (2, 25, 5, 2048, 64, 2048, 700, 700),   # hymba, partial fill
    (1, 25, 5, 1000, 64, 0, 1000, 1000),    # W not a multiple of C
    (2, 8, 2, 512, 64, 0, 0, 0),            # no valid slot: mean of V
    (2, 10, 2, 100, 64, 0, 77, 77),         # one block, no cluster split
])
def test_flash_decode_cluster_split(card, dtype, B, H, K, W, hd, window, fill,
                                    pos):
    gen = torch.Generator(device=card).manual_seed(6)
    q = _randn(gen, (B, 1, H, hd), dtype)
    kc, vc = (_randn(gen, (B, W, K, hd), dtype) for _ in range(2))
    sp = ring_slot_pos(W, fill, B, card)
    p = torch.full((B,), pos, dtype=torch.int32, device=card)
    C = decode_ops.cluster_size(W, B, K)
    assert C in (1, 2, 4, 8) and (C == 1 or C * 128 <= W)
    before = decode_ops.launches
    out = decode_mha(q, kc, vc, sp, p, window=window)
    torch.cuda.synchronize()
    assert decode_ops.launches == before + 1
    ref = decode_mha_ref(q, kc, vc, sp, p, window=window)
    _close(out, ref, dtype)
    if fill == 0:
        torch.testing.assert_close(
            out.float(), vc.float().mean(dim=1, keepdim=True).repeat_interleave(
                H // K, dim=2), atol=TOL[dtype], rtol=TOL[dtype])


def test_flash_decode_bf16_rejects_misaligned_caches(card):
    gen = torch.Generator(device=card).manual_seed(7)
    q = _randn(gen, (1, 1, 8, 64), torch.bfloat16)
    wide = _randn(gen, (1, 256, 2, 72), torch.bfloat16)
    sp = ring_slot_pos(256, 256, 1, card)
    pos = torch.full((1,), 256, dtype=torch.int32, device=card)
    before = decode_ops.launches
    with pytest.raises(ValueError, match="aligned"):
        decode_mha(q, wide[..., 4:68], wide[..., 4:68], sp, pos)
    assert decode_ops.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,W,hd,window,fill", [
    (2, 4, 2, 512, 64, 0, 512),
    (2, 4, 2, 512, 64, 0, 200),
    (1, 8, 4, 384, 128, 128, 500),
    (3, 2, 1, 100, 64, 0, 77),
    (2, 32, 8, 256, 128, 0, 257),
    (1, 25, 5, 512, 64, 512, 513),          # hymba's heads, G = 5
    (2, 10, 2, 300, 64, 0, 250),            # G = 5, partial fill
])
def test_flash_decode_matches_plain(card, dtype, B, H, K, W, hd, window,
                                    fill):
    gen = torch.Generator(device=card).manual_seed(1)
    q = _randn(gen, (B, 1, H, hd), dtype)
    kc, vc = (_randn(gen, (B, W, K, hd), dtype) for _ in range(2))
    sp = ring_slot_pos(W, fill, B, card)
    pos = torch.full((B,), fill, dtype=torch.int32, device=card)
    before = decode_ops.launches
    out = decode_mha(q, kc, vc, sp, pos, window=window)
    torch.cuda.synchronize()
    assert decode_ops.launches == before + 1
    _close(out, decode_mha_ref(q, kc, vc, sp, pos, window=window), dtype)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,N,strided", [
    (2, 256, 128, 16, False),
    (1, 100, 256, 16, False),               # ragged S
    (2, 128, 64, 8, False),
    (1, 1000, 512, 16, True),               # B, C as slices of one projection
    (3, 70, 200, 16, True),                 # di not a multiple of a block
])
def test_ssm_scan_matches_plain(card, xdtype, B, S, di, N, strided):
    gen = torch.Generator(device=card).manual_seed(2)
    dt = torch.nn.functional.softplus(_randn(gen, (B, S, di),
                                             torch.float32)) * 0.1
    xr = _randn(gen, (B, S, di), xdtype)
    if strided:
        proj = _randn(gen, (B, S, 8 + 2 * N), torch.float32)
        Bm, Cm = proj[..., 8:8 + N], proj[..., 8 + N:]
    else:
        Bm, Cm = (_randn(gen, (B, S, N), torch.float32) for _ in range(2))
    A = -torch.exp(_randn(gen, (di, N), torch.float32) * 0.5)
    h0 = _randn(gen, (B, di, N), torch.float32) * 0.1
    before = scan_ops.launches
    y, h = selective_scan(dt, xr, Bm, Cm, A, h0)
    torch.cuda.synchronize()
    assert scan_ops.launches == before + 1
    y_ref, h_ref = ssm_scan_ref(dt, xr, Bm, Cm, A, h0)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)
    # state continuation: two halves with the carried state
    half = S // 2
    y1, h1 = selective_scan(dt[:, :half], xr[:, :half], Bm[:, :half],
                            Cm[:, :half], A, h0)
    y2, h2 = selective_scan(dt[:, half:], xr[:, half:], Bm[:, half:],
                            Cm[:, half:], A, h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(h2, h, atol=1e-4, rtol=1e-4)


def _long_memory_scan_inputs(gen, B, S, di, N, rank=8):
    """The scan's inputs as `mamba_layer` gives them, with the model's
    long-memory dt = softplus(z - 4.6) ~ 0.01 and A = -(1..N)
    (`init_mamba`): xr bf16, B and C column slices of one projection, a
    nonzero h0."""
    f32 = torch.float32
    dt = torch.nn.functional.softplus(_randn(gen, (B, S, di), f32) - 4.6)
    xr = _randn(gen, (B, S, di), torch.bfloat16)
    proj = _randn(gen, (B, S, rank + 2 * N), f32)
    A = -torch.arange(1, N + 1, device=gen.device, dtype=f32).expand(
        di, N).contiguous()
    h0 = _randn(gen, (B, di, N), f32)
    return dt, xr, proj[..., rank:rank + N], proj[..., rank + N:], A, h0


def _scan_close(ins, R=0):
    before = scan_ops.launches
    y, h = scan_ops.selective_scan_at(*ins, R=R)
    torch.cuda.synchronize()
    assert scan_ops.launches == before + 1
    y_ref, h_ref = ssm_scan_ref(*ins)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("di", [8192, 3200])     # falcon-mamba-7b, hymba-1.5b
def test_ssm_scan_long_memory_at_serve_shapes(card, di):
    """The serve shapes (B = 1, S = 2048, N = 16) with the kernel's own R,
    on the model's long-memory inputs."""
    gen = torch.Generator(device=card).manual_seed(3)
    _scan_close(_long_memory_scan_inputs(gen, 1, 2048, di, 16))


@pytest.mark.parametrize("R,N", [(2, 16), (4, 16), (8, 16), (16, 16),
                                 (2, 8), (4, 8), (8, 8)])
def test_ssm_scan_every_states_per_thread(card, R, N):
    """Every R forced, on long-memory inputs with a ragged S and di and
    B = 2."""
    gen = torch.Generator(device=card).manual_seed(4)
    _scan_close(_long_memory_scan_inputs(gen, 2, 777, 300, N), R=R)


@pytest.mark.parametrize("S", [0, 1, 5])
def test_ssm_scan_short_sequences(card, S):
    """Fewer steps than a chunk, and none: h_final is h0 carried S steps."""
    gen = torch.Generator(device=card).manual_seed(5)
    _scan_close(_long_memory_scan_inputs(gen, 1, S, 3200, 16))


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("di,offset", [(301, 0), (300, 1)])
def test_ssm_scan_unaligned_layouts(card, xdtype, di, offset):
    """An odd di, or xr a view at an odd offset: rows are not 16-byte
    aligned, and the kernel takes plain loads and stores."""
    gen = torch.Generator(device=card).manual_seed(6)
    dt, _, Bm, Cm, A, h0 = _long_memory_scan_inputs(gen, 2, 300, di, 16)
    xr = _randn(gen, (2, 300, di + offset), xdtype)[..., offset:]
    _scan_close((dt, xr, Bm, Cm, A, h0))


def test_ssm_scan_states_per_thread_rule(card):
    """R = 4 where that still gives every SM a block (128 * 4 / N channels
    a block), else 2: on an H100 (132 SMs) 4 at di 8192 and 2 at di 3200."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for B, di, N in [(1, 8192, 16), (1, 3200, 16), (4, 3200, 16),
                     (1, 512, 16), (1, 8192, 8), (2, 2048, 8)]:
        blocks_at_4 = B * -(-di // (128 * 4 // N))
        want = 4 if blocks_at_4 >= sms else 2
        assert scan_ops.states_per_thread(B, di, N) == want
    if sms == 132:
        assert scan_ops.states_per_thread(1, 8192, 16) == 4
        assert scan_ops.states_per_thread(1, 3200, 16) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S", [(1, 2048), (8, 256)])
def test_flash_attention_at_qwen3_moe_heads(card, dtype, B, S):
    """qwen3-moe-30b-a3b's heads: 32 q heads over 4 kv heads (G 8), hd
    128, causal."""
    gen = torch.Generator(device=card).manual_seed(9)
    q = _randn(gen, (B, S, 32, 128), dtype)
    k, v = (_randn(gen, (B, S, 4, 128), dtype) for _ in range(2))
    before = flash_ops.launches
    out = mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    _close(out, mha_ref(q, k, v, causal=True), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,fill,pos", [(1, 2049, 2048),   # serve: first wrap
                                        (8, 2049, 2048),
                                        (1, 700, 700),     # partial fill
                                        (8, 1500, 1500)])
def test_flash_decode_at_qwen3_moe_heads(card, dtype, B, fill, pos):
    """G 8 at hd 128 against a W 2048 ring cache."""
    H, K, W, hd = 32, 4, 2048, 128
    gen = torch.Generator(device=card).manual_seed(10)
    q = _randn(gen, (B, 1, H, hd), dtype)
    kc, vc = (_randn(gen, (B, W, K, hd), dtype) for _ in range(2))
    sp = ring_slot_pos(W, fill, B, card)
    p = torch.full((B,), pos, dtype=torch.int32, device=card)
    before = decode_ops.launches
    out = decode_mha(q, kc, vc, sp, p)
    torch.cuda.synchronize()
    assert decode_ops.launches == before + 1
    _close(out, decode_mha_ref(q, kc, vc, sp, p), dtype)


def test_qwen3_moe_full_width_kernel_path_matches_plain_path(card):
    """qwen3-moe-30b-a3b at full width, 2 layers, B 1, S 512: prefill and
    one decode step through the kernels against the plain path."""
    cfg = registry.get("qwen3-moe-30b-a3b").replace(num_layers=2)
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, 512), dtype=torch.int32,
                         device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    out = {}
    for plain in (False, True):
        before = (flash_ops.launches, decode_ops.launches)
        logits, cache = model.prefill(params, {"tokens": toks}, plain=plain)
        step, _ = model.decode_step(params, cache, toks[:, :1], plain=plain)
        torch.cuda.synchronize()
        launched = (flash_ops.launches - before[0],
                    decode_ops.launches - before[1])
        assert launched == ((0, 0) if plain else (2, 2))
        out[plain] = (logits, step)
    for a, b in zip(out[False], out[True]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=0.3, rtol=0.05)


@pytest.mark.parametrize("arch", ["llama3-8b", "falcon-mamba-7b",
                                  "hymba-1.5b", "yi-34b", "qwen2-72b",
                                  "mixtral-8x22b"])
def test_model_kernel_path_matches_plain_path(card, arch):
    cfg = registry.get_smoke(arch)
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 48), dtype=torch.int32,
                         device=card)
    out = {}
    for plain in (False, True):
        logits, cache = model.prefill(params, {"tokens": toks}, plain=plain)
        step, _ = model.decode_step(params, cache, toks[:, :1], plain=plain)
        out[plain] = (logits, step)
    for a, b in zip(out[False], out[True]):
        torch.testing.assert_close(a, b, atol=0.3, rtol=0.05)


@pytest.mark.parametrize("scenario", ["LLM-COLD", "LLM-PREFILL",
                                      "LLM-DECODE", "EMB"])
def test_serving_core_kernel_path_matches_plain_path(card, scenario,
                                                     monkeypatch):
    """A tiny MLServe core through the kernels (hd 32: the SIMT prefill
    body, the G 2 cluster decode) against ``plain=True`` on the same
    payload bytes: logits and float cache leaves at atol 0.3, rtol 0.05,
    integer leaves exactly, greedy tokens equal wherever the plain path's
    top-2 margin exceeds 0.3 (a flip under it excuses what it reaches)."""
    payloads = serving.seed_payloads(scenario)
    seen = {False: [], True: []}
    out = {}
    cfg = serving._bundle(serving.SCENARIO_INPUTS[scenario][0])["cfg"]
    for plain in (False, True):
        orig = serving._next_token

        def spy(logits, orig=orig, plain=plain):
            tok = orig(logits)
            seen[plain].append((logits[:, -1].float(), tok))
            return tok

        monkeypatch.setattr(serving, "_next_token", spy)
        before = (flash_ops.launches, decode_ops.launches)
        res = serving.run_scenario(scenario, payloads, plain=plain)
        torch.cuda.synchronize()
        monkeypatch.setattr(serving, "_next_token", orig)
        launched = (flash_ops.launches - before[0],
                    decode_ops.launches - before[1])
        L = cfg.num_layers
        want = {"LLM-COLD": (L, L), "LLM-PREFILL": (L, 0),
                "LLM-DECODE": (0, L), "EMB": (L, 0)}[scenario]
        assert launched == ((0, 0) if plain else want)
        out[plain] = res
    flipped = False
    for (kl, kt), (pl, pt) in zip(seen[False], seen[True]):
        torch.testing.assert_close(kl, pl, atol=0.3, rtol=0.05)
        top2 = pl.topk(2, dim=-1).values
        for b in torch.nonzero((kt != pt).ravel()).ravel().tolist():
            assert float(top2[b, 0] - top2[b, 1]) <= 0.3
            flipped = True
    if scenario == "LLM-DECODE":
        (k_body, k_tok), (p_body, p_tok) = out[False], out[True]
        assert k_tok == p_tok or flipped
        out = {False: k_body, True: p_body}
    assert len(out[False]) == len(out[True])
    kernel, plain = (serving.load_output(scenario, out[p]) for p in (False,
                                                                     True))
    if isinstance(kernel, dict):
        for key in kernel:
            if kernel[key].dtype == torch.int32:
                assert torch.equal(kernel[key], plain[key]), key
            else:
                torch.testing.assert_close(kernel[key], plain[key], atol=0.3,
                                           rtol=0.05)
    else:
        assert torch.isfinite(kernel).all()
        # a flipped first token feeds LLM-COLD's step another token
        if not (flipped and not torch.allclose(kernel, plain, atol=0.3,
                                               rtol=0.05)):
            torch.testing.assert_close(kernel, plain, atol=0.3, rtol=0.05)


@pytest.mark.parametrize("system", ["nexus", "baseline"])
def test_worker_node_runs_a_handler_on_the_card(card, system):
    """LLM-COLD through the port's worker node on the card: the handler's
    core launches both attention kernels on the guest thread, and the
    durable output equals the kernel-path core's on the same bytes, cold
    and warm."""
    from repro_torch.core.runtime import WorkerNode
    from repro_torch.core.workloads import ml_suite
    payloads = serving.seed_payloads("LLM-COLD")
    direct = serving.run_scenario("LLM-COLD", payloads)
    L = serving._bundle("llm")["cfg"].num_layers
    node = WorkerNode(system, byte_scale=1.0)
    try:
        assert node.device.type == "cuda"
        node.deploy(ml_suite("tiny")["LLM-COLD"])
        node.seed_input("LLM-COLD", payloads=payloads)
        for cold in (True, False):
            before = (flash_ops.launches, decode_ops.launches)
            res = node.invoke("LLM-COLD").result(timeout=300)
            assert res.cold == cold
            assert (flash_ops.launches - before[0],
                    decode_ops.launches - before[1]) == (L, L)
            assert node.store.get("out",
                                  f"{res.invocation_id}-out") == direct
    finally:
        node.shutdown()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,causal,window", [
    (2, 200, 4, 2, True, 0),                # the moe smoke heads, G 2
    (1, 160, 4, 2, True, 48),
    (1, 70, 8, 1, False, 0),                # G 8, bidirectional
])
def test_flash_attention_takes_head_dim_16(card, dtype, B, S, H, K, causal,
                                           window):
    gen = torch.Generator(device=card).manual_seed(11)
    q = _randn(gen, (B, S, H, 16), dtype)
    k, v = (_randn(gen, (B, S, K, 16), dtype) for _ in range(2))
    assert flash_ops.body(dtype, 16) == "simt"
    before = flash_ops.launches
    out = mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    _close(out, mha_ref(q, k, v, causal=causal, window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,W,window,fill,pos", [
    (2, 4, 2, 300, 0, 300, 300),            # the moe smoke heads, G 2
    (1, 4, 2, 2048, 0, 2049, 2048),         # first wrap, cluster split
    (1, 4, 2, 256, 96, 400, 399),           # wrapped ring, window
    (2, 8, 1, 512, 0, 37, 37),              # G 8, partial fill
    (2, 4, 2, 64, 0, 0, 0),                 # no valid slot: mean of V
    (1, 4, 2, 9, 0, 9, 9),                  # fewer slots than lanes
])
def test_flash_decode_takes_head_dim_16(card, dtype, B, H, K, W, window, fill,
                                        pos):
    gen = torch.Generator(device=card).manual_seed(12)
    q = _randn(gen, (B, 1, H, 16), dtype)
    kc, vc = (_randn(gen, (B, W, K, 16), dtype) for _ in range(2))
    sp = ring_slot_pos(W, fill, B, card)
    p = torch.full((B,), pos, dtype=torch.int32, device=card)
    before = decode_ops.launches
    out = decode_mha(q, kc, vc, sp, p, window=window)
    torch.cuda.synchronize()
    assert decode_ops.launches == before + 1
    _close(out, decode_mha_ref(q, kc, vc, sp, p, window=window), dtype)


def test_flash_decode_hd16_bf16_rejects_misaligned_caches(card):
    gen = torch.Generator(device=card).manual_seed(13)
    q = _randn(gen, (1, 1, 4, 16), torch.bfloat16)
    wide = _randn(gen, (1, 64, 2, 24), torch.bfloat16)
    sp = ring_slot_pos(64, 64, 1, card)
    pos = torch.full((1,), 64, dtype=torch.int32, device=card)
    before = decode_ops.launches
    with pytest.raises(ValueError, match="aligned"):
        decode_mha(q, wide[..., 2:18], wide[..., 2:18], sp, pos)
    assert decode_ops.launches == before


@pytest.mark.parametrize("system", ["baseline", "nexus-tcp", "nexus-async",
                                    "nexus", "nexus-sdk-only",
                                    "nexus-prefetch-only", "wasm"])
def test_moe_runs_through_the_node_on_the_card(card, system):
    """MOE (the moe role's tiny config, hd 16) through the port's node on
    the card, cold and warm: L flash launches and no decode launch per
    invocation, the durable output the kernel-path core's."""
    from repro_torch.core.runtime import WorkerNode
    from repro_torch.core.workloads import ml_suite
    payloads = serving.seed_payloads("MOE")
    direct = serving.run_scenario("MOE", payloads)
    L = serving._bundle("moe")["cfg"].num_layers
    node = WorkerNode(system, byte_scale=1.0)
    try:
        node.deploy(ml_suite("tiny")["MOE"])
        node.seed_input("MOE", payloads=payloads)
        for cold in (True, False):
            before = (flash_ops.launches, decode_ops.launches)
            res = node.invoke("MOE").result(timeout=300)
            assert res.cold == cold
            assert (flash_ops.launches - before[0],
                    decode_ops.launches - before[1]) == (L, 0)
            assert node.store.get("out",
                                  f"{res.invocation_id}-out") == direct
    finally:
        node.shutdown()


def test_cache_serves_the_second_invocation_on_the_card(card):
    """LLM-PREFILL twice on one node with the SharedCache on: the second
    invocation's GETs hit, and both outputs are the kernel-path core's."""
    from repro_torch.core.cache import CacheSpec
    from repro_torch.core.runtime import WorkerNode
    from repro_torch.core.workloads import ml_suite
    payloads = serving.seed_payloads("LLM-PREFILL")
    direct = serving.run_scenario("LLM-PREFILL", payloads)
    node = WorkerNode("nexus", byte_scale=1.0,
                      cache=CacheSpec(capacity_mb=64.0))
    try:
        node.deploy(ml_suite("tiny")["LLM-PREFILL"])
        node.seed_input("LLM-PREFILL", payloads=payloads)
        for _ in range(2):
            res = node.invoke("LLM-PREFILL").result(timeout=300)
            assert node.store.get("out",
                                  f"{res.invocation_id}-out") == direct
        node.drain(timeout_s=60.0)
        stats = node.cache_stats()
        assert stats["lookups"] == 4 and stats["hits"] == 2
        assert node.backend.stats["cache_hits"] == 2
    finally:
        node.shutdown()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,W,hd,window,fill,pos", [
    (1, 56, 8, 2048, 128, 0, 2049, 2048),       # yi-34b serve, B 1
    (8, 56, 8, 2048, 128, 0, 2049, 2048),       # yi-34b serve, B 8
    (1, 48, 8, 4096, 128, 4096, 8193, 8192),    # mixtral-8x22b serve ring
    (1, 48, 8, 8192, 128, 4096, 9000, 9000),    # wrapped, window 4096
    (2, 7, 1, 300, 16, 64, 400, 399),           # yi-34b smoke heads
    (2, 6, 1, 256, 16, 96, 400, 399),           # G 6 at hd 16
    (1, 7, 1, 384, 64, 0, 200, 200),            # G 7, partial fill
    (2, 12, 2, 512, 32, 0, 0, 0),               # G 6, no valid slot
])
def test_flash_decode_at_group_sizes_6_and_7(card, dtype, B, H, K, W, hd,
                                             window, fill, pos):
    """Both bodies at G 6 and 7: the bf16 tile's padding rows and the
    f32 loop's G heads, with wrapped rings and windows."""
    gen = torch.Generator(device=card).manual_seed(11)
    q = _randn(gen, (B, 1, H, hd), dtype)
    kc, vc = (_randn(gen, (B, W, K, hd), dtype) for _ in range(2))
    sp = ring_slot_pos(W, fill, B, card)
    p = torch.full((B,), pos, dtype=torch.int32, device=card)
    assert H // K in decode_ops.GROUPS
    before = decode_ops.launches
    out = decode_mha(q, kc, vc, sp, p, window=window)
    torch.cuda.synchronize()
    assert decode_ops.launches == before + 1
    _close(out, decode_mha_ref(q, kc, vc, sp, p, window=window), dtype)


@pytest.mark.parametrize("H,K", [(3, 1), (9, 1), (24, 2)])
def test_flash_decode_raises_outside_its_group_sizes(card, H, K):
    gen = torch.Generator(device=card).manual_seed(12)
    q = _randn(gen, (1, 1, H, 64), torch.bfloat16)
    kc = _randn(gen, (1, 256, K, 64), torch.bfloat16)
    sp = ring_slot_pos(256, 256, 1, card)
    p = torch.full((1,), 256, dtype=torch.int32, device=card)
    before = decode_ops.launches
    with pytest.raises(ValueError, match="group"):
        decode_mha(q, kc, kc, sp, p)
    assert decode_ops.launches == before


@pytest.mark.parametrize("dtype,B,S,H,K,window", [
    (torch.bfloat16, 1, 2048, 56, 8, 0),        # yi-34b serve shape
    (torch.float32, 1, 1024, 56, 8, 0),
    (torch.bfloat16, 1, 8192, 48, 8, 4096),     # mixtral-8x22b serve shape
    (torch.float32, 1, 1500, 48, 8, 512),
])
def test_flash_attention_at_yi_and_mixtral_heads(card, dtype, B, S, H, K,
                                                 window):
    """56 (G 7) and 48 (G 6) q heads over 8 kv heads at hd 128, causal,
    mixtral's with its window."""
    gen = torch.Generator(device=card).manual_seed(13)
    q = _randn(gen, (B, S, H, 128), dtype)
    k, v = (_randn(gen, (B, S, K, 128), dtype) for _ in range(2))
    before = flash_ops.launches
    out = mha(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    _close(out, mha_ref(q, k, v, causal=True, window=window), dtype)


def test_qwen2_bias_and_mixtral_window_on_the_card(card):
    """qwen2-72b smoke with nonzero QKV biases and mixtral-8x22b smoke
    past its 64-slot window, kernel path against plain path: a prefill
    of 100 tokens and decode steps beyond it."""
    for arch in ("qwen2-72b", "mixtral-8x22b"):
        cfg = registry.get_smoke(arch)
        model = Model(cfg)
        gen = torch.Generator(device=card).manual_seed(0)
        params = model.init_params(gen)
        if cfg.attn_bias:
            for name in ("bq", "bk", "bv"):
                leaf = params["layers"]["attn"][name]
                leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                       device=card).to(leaf.dtype))
        toks = torch.randint(0, cfg.vocab_size, (2, 100), dtype=torch.int32,
                             device=card, generator=gen)
        out = {}
        for plain in (False, True):
            logits, cache = model.prefill(params, {"tokens": toks},
                                          plain=plain)
            steps = [logits]
            for i in range(3):
                logits, cache = model.decode_step(params, cache,
                                                  toks[:, i:i + 1],
                                                  plain=plain)
                steps.append(logits)
            out[plain] = steps
        for a, b in zip(out[False], out[True]):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, atol=0.3, rtol=0.05)


#: internvl2-2b's heads (H 16 over K 8, G 2, hd 128) and
#: seamless-m4t-large-v2's (H 16 over K 16, G 1, hd 64)
INTERNVL2, SEAMLESS = (16, 8, 128), (16, 16, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,Sq,Sk,causal", [
    (INTERNVL2, 2048, 2048, True),
    (SEAMLESS, 2048, 2048, False),          # the encoder
    (SEAMLESS, 2048, 2048, True),           # the decoder
    (SEAMLESS, 2048, 1500, False),          # cross-attention, ragged source
], ids=["internvl2-causal", "seamless-encoder", "seamless-decoder",
        "seamless-cross-1500"])
def test_flash_attention_at_vlm_and_encdec_heads(card, dtype, heads, Sq, Sk,
                                                 causal):
    H, K, hd = heads
    gen = torch.Generator(device=card).manual_seed(14)
    q = _randn(gen, (1, Sq, H, hd), dtype)
    k, v = (_randn(gen, (1, Sk, K, hd), dtype) for _ in range(2))
    before = flash_ops.launches
    out = mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    _close(out, mha_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,B,W,fill,pos", [
    (INTERNVL2, 1, 2048, 2049, 2048),       # the served ring's first wrap
    (INTERNVL2, 8, 2048, 2049, 2048),
    (SEAMLESS, 1, 2048, 2049, 2048),        # the decoder's self ring
    (SEAMLESS, 8, 2048, 2049, 2048),
    (SEAMLESS, 1, 2048, 2048, 2047),        # the cross cache: every slot
    (SEAMLESS, 8, 2048, 2048, 2047),
    (SEAMLESS, 1, 1500, 1500, 1499),        # ... of a ragged source
    (SEAMLESS, 8, 1500, 1500, 1499),
])
def test_flash_decode_at_vlm_and_encdec_heads(card, dtype, heads, B, W, fill,
                                              pos):
    H, K, hd = heads
    gen = torch.Generator(device=card).manual_seed(15)
    q = _randn(gen, (B, 1, H, hd), dtype)
    kc, vc = (_randn(gen, (B, W, K, hd), dtype) for _ in range(2))
    sp = ring_slot_pos(W, fill, B, card)
    p = torch.full((B,), pos, dtype=torch.int32, device=card)
    before = decode_ops.launches
    out = decode_mha(q, kc, vc, sp, p)
    torch.cuda.synchronize()
    assert decode_ops.launches == before + 1
    _close(out, decode_mha_ref(q, kc, vc, sp, p), dtype)


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-large-v2"])
def test_vlm_and_encdec_kernel_path_matches_plain_path(card, arch):
    """The smoke configs from bf16 embeddings (seamless: 56 source frames
    against a 48-token target prefix): prefill and 3 decode steps,
    kernel path against plain path, with the launches of each."""
    cfg = registry.get_smoke(arch)
    model = Model(cfg)
    gen = torch.Generator(device=card).manual_seed(0)
    params = model.init_params(gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), dtype=torch.int32,
                         device=card, generator=gen)
    emb = _randn(gen, (2, 56 if cfg.is_encoder_decoder else 48, cfg.d_model),
                 torch.bfloat16)
    batch = ({"src_embeds": emb, "tgt_tokens": toks}
             if cfg.is_encoder_decoder else {"inputs_embeds": emb})
    out = {}
    flash0, decode0 = flash_ops.launches, decode_ops.launches
    for plain in (False, True):
        logits, cache = model.prefill(params, batch, plain=plain)
        steps = [logits]
        for i in range(3):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, i:i + 1], plain=plain)
            steps.append(logits)
        out[plain] = steps
    # per prefill the encoder's, the decoder's and the cross layers; per
    # step the self and the cross layers
    L = cfg.num_layers
    if cfg.is_encoder_decoder:
        assert flash_ops.launches - flash0 == cfg.num_encoder_layers + 2 * L
        assert decode_ops.launches - decode0 == 3 * 2 * L
    else:
        assert flash_ops.launches - flash0 == L
        assert decode_ops.launches - decode0 == 3 * L
    for a, b in zip(out[False], out[True]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=0.3, rtol=0.05)


# ------------------------------------------------------ attention backward

def _grads_close(got, want, dtype, what=""):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        assert torch.isfinite(a).all(), f"{what} {name}"
        assert err <= BWD_TOL[dtype] * scale, (f"{what} {name}: max error "
                                               f"{err:.3e} of max {scale:.3e}")


def _bwd_inputs(card, seed, B, Sq, Sk, H, K, hd, dtype):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = _randn(gen, (B, Sq, H, hd), dtype)
    k, v = (_randn(gen, (B, Sk, K, hd), dtype) for _ in range(2))
    dout = _randn(gen, (B, Sq, H, hd), dtype)
    return q, k, v, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal,window", [
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 128, 4, 4, 64, False, 0),      # G 1, bidirectional
    (2, 256, 256, 8, 2, 128, True, 96),     # a window
    (1, 200, 200, 2, 1, 64, True, 0),       # ragged, G 2
    (1, 192, 192, 6, 3, 32, True, 64),      # hd 32
    (1, 300, 300, 25, 5, 64, True, 128),    # hymba's heads, G 5
    (1, 130, 130, 6, 1, 16, True, 0),       # hd 16, G 6
    (1, 256, 256, 7, 1, 64, True, 0),       # G 7
    (1, 256, 256, 8, 1, 128, True, 0),      # G 8
    (1, 200, 150, 16, 16, 64, False, 0),    # cross: Sq > Sk
    (2, 100, 300, 4, 2, 64, False, 0),      # Sq < Sk, bidirectional
    (1, 100, 300, 4, 2, 32, True, 0),       # Sq < Sk, causal
    (1, 300, 200, 4, 2, 128, True, 0),      # Sq > Sk, causal
])
def test_flash_attention_bwd_matches_plain(card, dtype, B, Sq, Sk, H, K, hd,
                                           causal, window):
    """Through the body `bwd_body` picks (bf16 hd 64/128: tensor cores),
    on the forward's lse."""
    q, k, v, dout = _bwd_inputs(card, 20, B, Sq, Sk, H, K, hd, dtype)
    out, lse = mha_with_lse(q, k, v, causal=causal, window=window)
    before = flash_ops.bwd_launches
    got = mha_bwd(q, k, v, out, dout, lse=lse, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.bwd_launches == before + 1
    want = mha_ref_bwd(q, k, v, out, dout, causal=causal, window=window)
    _grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_is_deterministic(card, dtype):
    """Two runs of the same backward give the same bits: no atomics."""
    q, k, v, dout = _bwd_inputs(card, 21, 2, 500, 500, 16, 2, 128, dtype)
    out, lse = mha_with_lse(q, k, v)
    a = mha_bwd(q, k, v, out, dout, lse=lse)
    b = mha_bwd(q, k, v, out, dout, lse=lse)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("B,S,H,K,hd,window", [
    (1, 1024, 25, 5, 64, 0),        # hymba's heads
    (1, 1100, 8, 2, 64, 300),       # ragged, a window
    (2, 1024, 32, 8, 128, 0),       # llama3-8b's heads
    (1, 1300, 16, 2, 128, 0),       # ragged, G 8
])
def test_flash_attention_bwd_tensor_core_body_at_long_sequences(card, B, S, H,
                                                                K, hd,
                                                                window):
    """bf16 at hd 64 and 128 through the tensor-core body over many tiles
    of a row (P^T and dS^T in bf16), against the plain backward."""
    assert flash_ops.bwd_body(torch.bfloat16, hd) == "wgmma"
    q, k, v, dout = _bwd_inputs(card, 26, B, S, S, H, K, hd, torch.bfloat16)
    out, lse = mha_with_lse(q, k, v, window=window)
    got = mha_bwd(q, k, v, out, dout, lse=lse, window=window)
    _grads_close(got, mha_ref_bwd(q, k, v, out, dout, window=window),
                 torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,H,K,hd,causal,window", [
    (300, 300, 8, 2, 128, True, 0),
    (500, 500, 25, 5, 64, True, 128),
    (200, 150, 4, 4, 64, False, 0),
    (192, 192, 6, 3, 32, True, 64),
    (130, 130, 4, 2, 16, True, 48),
])
def test_mha_with_lse_matches_plain_lse(card, dtype, Sq, Sk, H, K, hd, causal,
                                        window):
    """The forward's lse (both bodies) against the plain row lse; the
    output is the one `mha` gives, bit for bit."""
    q, k, v, _ = _bwd_inputs(card, 27, 2, Sq, Sk, H, K, hd, dtype)
    out, lse = mha_with_lse(q, k, v, causal=causal, window=window)
    ref_out, ref_lse = mha_ref_with_lse(q, k, v, causal=causal,
                                        window=window)
    assert lse.shape == (2, H, Sq) and lse.dtype == torch.float32
    assert torch.equal(out, mha(q, k, v, causal=causal, window=window))
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    _close(out, ref_out, dtype)


def test_mha_bwd_raises_without_lse_on_the_card(card):
    q, k, v, dout = _bwd_inputs(card, 28, 1, 64, 64, 4, 2, 64,
                                torch.bfloat16)
    out, lse = mha_with_lse(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        mha_bwd(q, k, v, out, dout, lse=None)
    with pytest.raises(ValueError, match="lse"):
        mha_bwd(q, k, v, out, dout, lse=lse[:, :2])


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128),
                                      (torch.float32, 64)])
def test_flash_attention_bwd_reads_views_and_noncontiguous_dout(card, dtype,
                                                                hd):
    """q, k and v as head slices of one fused projection, and a dout that
    is a transposed view: gradients of the views, through autograd."""
    B, S, H, K = 2, 300, 8, 2
    gen = torch.Generator(device=card).manual_seed(22)
    qkv = _randn(gen, (B, S, H + 2 * K, hd), dtype).requires_grad_(True)
    dout = _randn(gen, (B, H, S, hd), dtype).transpose(1, 2)
    assert not dout.is_contiguous()
    out = mha(qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:])
    (got,) = torch.autograd.grad(out, qkv, dout)
    plain = qkv.detach().requires_grad_(True)
    ref = mha_ref(plain[:, :, :H], plain[:, :, H:H + K], plain[:, :, H + K:])
    (want,) = torch.autograd.grad(ref, plain, dout)
    _grads_close((got[:, :, :H], got[:, :, H:H + K], got[:, :, H + K:]),
                 (want[:, :, :H], want[:, :, H:H + K], want[:, :, H + K:]),
                 dtype)


def test_mha_autograd_launches_and_inference_mode(card):
    """With grad, one forward and one backward launch; under
    inference_mode only the forward, and nothing requires grad."""
    q, k, v, dout = _bwd_inputs(card, 23, 1, 256, 256, 8, 2, 128,
                                torch.bfloat16)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    f0, b0 = flash_ops.launches, flash_ops.bwd_launches
    out = mha(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    assert (flash_ops.launches - f0, flash_ops.bwd_launches - b0) == (1, 1)
    _, lse = mha_ref_with_lse(q.detach(), k.detach(), v.detach())
    _grads_close(grads, mha_bwd(q.detach(), k.detach(), v.detach(),
                                out.detach(), dout, lse=lse), torch.bfloat16)
    with torch.inference_mode():
        again = mha(*leaves)
    assert not again.requires_grad
    assert (flash_ops.launches - f0, flash_ops.bwd_launches - b0) == (2, 2)


def test_inference_mode_forward_writes_no_lse(card, monkeypatch):
    """Under inference_mode (the serve paths) the forward kernel is given
    a null lse and launches once; with grad it is given one, saved for
    the backward."""
    seen = []
    real = flash_ops._forward

    def spy(q, k, v, causal, window, with_lse=False):
        seen.append(with_lse)
        return real(q, k, v, causal, window, with_lse=with_lse)

    monkeypatch.setattr(flash_ops, "_forward", spy)
    q, k, v, _ = _bwd_inputs(card, 29, 1, 256, 256, 8, 2, 128,
                             torch.bfloat16)
    f0, b0 = flash_ops.launches, flash_ops.bwd_launches
    with torch.inference_mode():
        out = mha(q, k, v)
    assert seen == [False] and isinstance(out, torch.Tensor)
    assert (flash_ops.launches - f0, flash_ops.bwd_launches - b0) == (1, 0)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    mha(*leaves).sum().backward()
    assert seen == [False, True]
    assert (flash_ops.launches - f0, flash_ops.bwd_launches - b0) == (2, 1)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_mha_autograd_inside_checkpoint(card, policy):
    """The autograd Function inside ``torch.utils.checkpoint``: the
    recompute launches the forward again, the gradients are those of the
    run without a checkpoint, bit for bit."""
    from repro_torch.models.lm import checkpoint_layer
    q, k, v, dout = _bwd_inputs(card, 24, 2, 300, 300, 8, 2, 64,
                                torch.bfloat16)
    w = _randn(torch.Generator(device=card).manual_seed(25), (64, 64),
               torch.bfloat16).requires_grad_(True)

    def layer(x):
        return mha(x @ w, k, v, window=100)

    x = q.requires_grad_(True)
    plain = torch.autograd.grad(layer(x), (x, w), dout)
    f0, b0 = flash_ops.launches, flash_ops.bwd_launches
    out = checkpoint_layer(policy, layer, x)
    got = torch.autograd.grad(out, (x, w), dout)
    assert (flash_ops.launches - f0, flash_ops.bwd_launches - b0) == (2, 1)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_loss_backward_kernel_matches_plain(card, dtype):
    """llama3-8b smoke: the loss and every gradient leaf on the kernel
    path against the plain path, from the same params and batch, with
    one forward and one backward attention launch per layer, and the
    layer's recompute under the remat policy."""
    from repro_torch.models import serialize
    cfg = registry.get_smoke("llama3-8b").replace(dtype=dtype,
                                                  param_dtype=dtype)
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 65), dtype=torch.int32,
                         device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    leaves = serialize.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for plain in (False, True):
        f0, b0 = flash_ops.launches, flash_ops.bwd_launches
        loss, _ = model.loss(params, batch, plain=plain)
        grads = torch.autograd.grad(loss, leaves)
        out[plain] = (loss, grads, flash_ops.launches - f0,
                      flash_ops.bwd_launches - b0)
    L = cfg.num_layers
    assert out[False][2:] == (2 * L, L)         # forward, recompute, backward
    assert out[True][2:] == (0, 0)
    tol = BWD_TOL[getattr(torch, dtype)]
    torch.testing.assert_close(out[False][0], out[True][0], atol=tol,
                               rtol=tol)
    for a, b in zip(out[False][1], out[True][1]):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 5 * tol * max(b.float().abs().max().item(), 1e-6)


def _scan_bwd_inputs(gen, B, S, di, N, xdtype):
    """Long-memory scan inputs (xr in xdtype, B and C views of one
    projection, nonzero h0) and the cotangents dy and dh_final."""
    dt, xr, Bm, Cm, A, h0 = _long_memory_scan_inputs(gen, B, S, di, N)
    xr = xr.to(xdtype)
    dy = _randn(gen, (B, S, di), torch.float32)
    dhf = _randn(gen, (B, di, N), torch.float32)
    return (dt, xr, Bm, Cm, A, h0), dy, dhf


def _scan_grads_close(got, want, xdtype):
    for name, a, b in zip(("ddt", "dx", "dB", "dC", "dA", "dh0"), got, want):
        tol = BWD_TOL[torch.bfloat16] if name == "dx" and \
            xdtype == torch.bfloat16 else BWD_TOL[torch.float32]
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * max(b.float().abs().max().item(), 1e-30), name


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,di,N", [(2, 333, 300, 16), (1, 100, 512, 8),
                                      (2, 300, 176, 16), (1, 1000, 3200, 16)])
def test_ssm_scan_bwd_matches_plain(card, xdtype, B, S, di, N):
    """The backward kernel on the forward's boundary states against
    `ssm_scan_ref_bwd`, each gradient within 1e-4 of its largest |value|
    (dx in bf16 within 2e-2), at every R it takes, block counts that are
    not a multiple of the cluster among them (di 300: 19 blocks at R 2, 10
    at R 4; di 176: 11 and 6; hymba's 3200: 200 and 100); the forward
    with its states gives y and h_final bit for bit as the forward
    without."""
    gen = torch.Generator(device=card).manual_seed(30)
    ins, dy, dhf = _scan_bwd_inputs(gen, B, S, di, N, xdtype)
    y, h = selective_scan(*ins)
    f0 = scan_ops.launches
    y1, h1, hs = selective_scan_states(*ins)
    assert scan_ops.launches == f0 + 1
    assert torch.equal(y, y1) and torch.equal(h, h1)
    want = ssm_scan_ref_bwd(*ins, dy, dhf)
    for R in (0,) + scan_ops.BWD_PER_THREAD:
        b0 = scan_ops.bwd_launches
        got = selective_scan_bwd(*ins[:5], hs, dy, dhf, R=R)
        torch.cuda.synchronize()
        assert scan_ops.bwd_launches == b0 + 1
        assert got[1].dtype == xdtype
        _scan_grads_close(got, want, xdtype)


def test_ssm_scan_bwd_is_deterministic_and_takes_no_dh_final(card):
    """Two runs equal bit for bit; dh_final None is zero; S = 0 launches
    nothing and passes dh_final to dh0."""
    gen = torch.Generator(device=card).manual_seed(31)
    ins, dy, dhf = _scan_bwd_inputs(gen, 2, 1000, 3200, 16, torch.bfloat16)
    _, _, hs = selective_scan_states(*ins)
    a = selective_scan_bwd(*ins[:5], hs, dy, dhf)
    b = selective_scan_bwd(*ins[:5], hs, dy, dhf)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _scan_grads_close(selective_scan_bwd(*ins[:5], hs, dy),
                      ssm_scan_ref_bwd(*ins, dy, None), torch.bfloat16)
    empty, dy0, dhf0 = _scan_bwd_inputs(gen, 1, 0, 64, 16, torch.float32)
    _, _, hs0 = selective_scan_states(*empty)
    b0 = scan_ops.bwd_launches
    out = selective_scan_bwd(*empty[:5], hs0, dy0, dhf0)
    assert scan_ops.bwd_launches == b0
    assert torch.equal(out[5], dhf0) and not out[4].any()


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_families_refuse_to_train_on_the_card(card, arch):
    """The ssm and hybrid families train on the card: a smoke model's loss
    and every gradient leaf on the kernel path against the plain path,
    with one forward scan per layer and its recompute under the remat
    policy, one backward scan per layer, and for the hybrid the
    attention's kernels beside them; the plain path launches nothing."""
    from repro_torch.models import serialize
    cfg = registry.get_smoke(arch)
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 65), dtype=torch.int32,
                         device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    leaves = serialize.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for plain in (False, True):
        c0 = (scan_ops.launches, scan_ops.bwd_launches, flash_ops.launches,
              flash_ops.bwd_launches)
        loss, _ = model.loss(params, batch, plain=plain)
        grads = torch.autograd.grad(loss, leaves)
        out[plain] = (loss, grads, (scan_ops.launches - c0[0],
                                    scan_ops.bwd_launches - c0[1],
                                    flash_ops.launches - c0[2],
                                    flash_ops.bwd_launches - c0[3]))
    L = cfg.num_layers
    fwd = L * (1 + (cfg.remat_policy != "none"))
    attn = (fwd, L) if cfg.family == "hybrid" else (0, 0)
    assert out[False][2] == (fwd, L) + attn
    assert out[True][2] == (0, 0, 0, 0)
    tol = BWD_TOL[getattr(torch, cfg.dtype)]
    torch.testing.assert_close(out[False][0], out[True][0], atol=tol,
                               rtol=tol)
    for a, b in zip(out[False][1], out[True][1]):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 5 * tol * max(b.float().abs().max().item(), 1e-6)


# --------------------------------------- the head_dim-slice decode pair

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,W,hs,window,fill", [
    (2, 32, 8, 2048, 64, 0, 2049),     # llama's heads, hd 128 over model 2
    (2, 32, 8, 2048, 32, 0, 2049),     # over model 4
    (8, 32, 8, 2048, 8, 0, 2049),      # over model 16, B 8
    (1, 64, 8, 2048, 32, 0, 2049),     # qwen2's G 8
    (1, 56, 8, 2048, 16, 0, 700),      # yi's G 7, partial fill
    (2, 4, 4, 300, 8, 100, 350),       # G 1, a window
    (1, 6, 3, 1000, 16, 0, 1000),      # G 2, W not a multiple of 128
    (2, 8, 2, 64, 32, 0, 0),           # no valid slot: the mean of V
    (8, 25, 5, 2048, 4, 2048, 2100),   # hymba's G 5, hd 64 over model 16
    (1, 25, 5, 2048, 4, 2048, 2049),   # B 1 (long_500k), bf16 rows of 8 B
    (2, 25, 5, 2048, 16, 2048, 2049),  # hd 64 over model 4
    (2, 25, 5, 2048, 32, 2048, 2049),  # over model 2
    (2, 10, 2, 48, 4, 20, 70),         # slice 4, a window of 20
    (2, 32, 4, 2048, 64, 0, 2049),     # qwen3's G 8 over K 4, model 2
    (2, 48, 8, 4096, 64, 4096, 8193),  # mixtral's G 6, its window, model 2
    (8, 48, 8, 4096, 8, 4096, 8193),   # mixtral's decode_32k rank, model 16
    (1, 48, 8, 4096, 8, 4096, 524289),  # mixtral's long_500k rank
    (2, 12, 2, 1000, 64, 300, 1500),   # G 6, a window short of the ring
    (2, 12, 2, 1000, 8, 300, 1500),    # the same at slice 8
    # seamless's G 1 (hd 64): its decode_32k rank (model 16) with every
    # slot valid (slot_pos arange(W), pos W - 1), as the cross decode
    # calls it, and after the self ring's wrap; its (1, 4) rank alike
    (8, 16, 16, 32768, 4, 0, 32768),
    (8, 16, 16, 2048, 4, 0, 2049),
    (2, 16, 16, 2048, 16, 0, 2048),
    (2, 16, 16, 2048, 16, 0, 2049),
    (8, 16, 8, 2048, 8, 0, 2049),      # internvl2's G 2, hd 128 over 16
    (2, 16, 8, 2048, 64, 0, 2049),     # its (1, 2) rank, over model 2
])
def test_decode_pair_matches_plain(card, dtype, B, H, K, W, hs, window,
                                   fill):
    """Each kernel of the pair against its plain version on the same
    inputs, and the values kernel on the plain scores."""
    gen = torch.Generator(device=card).manual_seed(11)
    q = _randn(gen, (B, H, hs), dtype)
    kc, vc = (_randn(gen, (B, W, K, hs), dtype) for _ in range(2))
    sp = ring_slot_pos(W, fill, B, card)
    pos = torch.full((B,), max(fill - 1, 0), dtype=torch.int32, device=card)
    before = (decode_ops.scores_launches, decode_ops.values_launches)
    s = decode_scores_hd(q, kc)
    s_ref = decode_scores_hd_ref(q, kc)
    torch.testing.assert_close(s, s_ref, atol=TOL[torch.float32] * hs,
                               rtol=TOL[torch.float32])
    out = decode_values_hd(s_ref, vc, sp, pos, head_dim=128, window=window)
    torch.cuda.synchronize()
    assert (decode_ops.scores_launches, decode_ops.values_launches) == (
        before[0] + 1, before[1] + 1)
    _close(out, decode_values_hd_ref(s_ref, vc, sp, pos, head_dim=128,
                                     window=window), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4, 16])
def test_decode_pair_over_slices_equals_flash_decode_plain(card, dtype, n):
    """The pair over the n head_dim slices of hd 128 (the partial scores
    summed as the all-reduce sums them) against the one-device plain
    decode on the whole heads, after the ring's first wrap."""
    gen = torch.Generator(device=card).manual_seed(12)
    B, H, K, W, hd = 2, 32, 8, 2048, 128
    q = _randn(gen, (B, 1, H, hd), dtype)
    kc, vc = (_randn(gen, (B, W, K, hd), dtype) for _ in range(2))
    sp = ring_slot_pos(W, W + 1, B, card)
    pos = torch.full((B,), W, dtype=torch.int32, device=card)
    hs = hd // n
    parts = [slice(j * hs, (j + 1) * hs) for j in range(n)]
    s = sum(decode_scores_hd(q[:, 0, :, p].contiguous(),
                             kc[..., p].contiguous()) for p in parts)
    out = torch.cat([decode_values_hd(s, vc[..., p].contiguous(), sp, pos,
                                      head_dim=hd) for p in parts], dim=-1)
    _close(out[:, None], decode_mha_ref(q, kc, vc, sp, pos), dtype)


@pytest.mark.parametrize("H, K, hs, hd, window", [
    (32, 8, 16, 128, 0), (25, 5, 4, 64, 2048),
    (16, 16, 4, 64, 0), (16, 8, 8, 128, 0)])      # G 1 and G 2
def test_decode_pair_runs_bit_for_bit(card, H, K, hs, hd, window):
    gen = torch.Generator(device=card).manual_seed(13)
    q = _randn(gen, (2, H, hs), torch.bfloat16)
    kc, vc = (_randn(gen, (2, 2048, K, hs), torch.bfloat16) for _ in "kv")
    sp = ring_slot_pos(2048, 2049, 2, card)
    pos = torch.full((2,), 2048, dtype=torch.int32, device=card)
    runs = []
    for _ in range(2):
        s = decode_scores_hd(q, kc)
        runs.append((s, decode_values_hd(s, vc, sp, pos, head_dim=hd,
                                         window=window)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4, 16])
def test_decode_pair_over_hymba_slices_equals_flash_decode_plain(card, dtype,
                                                                n):
    """hymba-1.5b's heads (H 25 over K 5, G 5, hd 64) with its window of
    2048: the pair over the n head_dim slices (32, 16 and 4: model 2, 4
    and 16) against the one-device plain decode, after the ring's first
    wrap."""
    gen = torch.Generator(device=card).manual_seed(15)
    B, H, K, W, hd = 2, 25, 5, 2048, 64
    q = _randn(gen, (B, 1, H, hd), dtype)
    kc, vc = (_randn(gen, (B, W, K, hd), dtype) for _ in range(2))
    sp = ring_slot_pos(W, W + 1, B, card)
    pos = torch.full((B,), W, dtype=torch.int32, device=card)
    hs = hd // n
    parts = [slice(j * hs, (j + 1) * hs) for j in range(n)]
    s = sum(decode_scores_hd(q[:, 0, :, p].contiguous(),
                             kc[..., p].contiguous()) for p in parts)
    out = torch.cat([decode_values_hd(s, vc[..., p].contiguous(), sp, pos,
                                      head_dim=hd, window=W)
                     for p in parts], dim=-1)
    _close(out[:, None], decode_mha_ref(q, kc, vc, sp, pos, window=W), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 16])
def test_decode_pair_over_mixtral_slices_equals_flash_decode_plain(
        card, dtype, n):
    """mixtral-8x22b's heads (H 48 over K 8, G 6, hd 128) with a window of
    1024 inside a wrapped ring of 2048: the pair over the n head_dim
    slices (64 and 8: model 2 and 16) against the one-device plain
    decode."""
    gen = torch.Generator(device=card).manual_seed(16)
    B, H, K, W, hd, window = 2, 48, 8, 2048, 128, 1024
    q = _randn(gen, (B, 1, H, hd), dtype)
    kc, vc = (_randn(gen, (B, W, K, hd), dtype) for _ in range(2))
    sp = ring_slot_pos(W, W + 1, B, card)
    pos = torch.full((B,), W, dtype=torch.int32, device=card)
    hs = hd // n
    parts = [slice(j * hs, (j + 1) * hs) for j in range(n)]
    s = sum(decode_scores_hd(q[:, 0, :, p].contiguous(),
                             kc[..., p].contiguous()) for p in parts)
    out = torch.cat([decode_values_hd(s, vc[..., p].contiguous(), sp, pos,
                                      head_dim=hd, window=window)
                     for p in parts], dim=-1)
    _close(out[:, None], decode_mha_ref(q, kc, vc, sp, pos, window=window),
           dtype)


def test_decode_pair_takes_a_bf16_slice_of_4_at_8_bytes(card):
    """A bf16 K slice of 4 is one 8-byte vector a row: a slice cut at 8
    bytes into a wider cache (strides of 48 bytes) runs and matches the
    plain scores; one cut at 4 bytes raises without a launch."""
    gen = torch.Generator(device=card).manual_seed(16)
    wide = _randn(gen, (1, 64, 2, 24), torch.bfloat16)
    q = _randn(gen, (1, 4, 4), torch.bfloat16)
    before = decode_ops.scores_launches
    _close(decode_scores_hd(q, wide[..., 4:8]),
           decode_scores_hd_ref(q, wide[..., 4:8]), torch.float32)
    assert decode_ops.scores_launches == before + 1
    with pytest.raises(ValueError, match="aligned|multiple"):
        decode_scores_hd(q, wide[..., 2:6])
    assert decode_ops.scores_launches == before + 1


def test_decode_pair_refuses_what_it_does_not_take(card):
    """A slice outside 4-64 (12), a group over 8 and a misaligned K slice
    raise without a launch."""
    gen = torch.Generator(device=card).manual_seed(14)
    sp = ring_slot_pos(64, 64, 1, card)
    pos = torch.full((1,), 63, dtype=torch.int32, device=card)
    before = (decode_ops.scores_launches, decode_ops.values_launches)
    q12, k12 = _randn(gen, (1, 8, 12), torch.float32), _randn(
        gen, (1, 64, 2, 12), torch.float32)
    with pytest.raises(ValueError, match="slice"):
        decode_scores_hd(q12, k12)
    with pytest.raises(ValueError, match="slice"):
        decode_values_hd(torch.zeros((1, 8, 64), device=card), k12, sp, pos,
                         head_dim=128)
    q9, k9 = _randn(gen, (1, 9, 8), torch.float32), _randn(
        gen, (1, 64, 1, 8), torch.float32)
    with pytest.raises(ValueError, match="group"):
        decode_scores_hd(q9, k9)
    wide = _randn(gen, (1, 64, 2, 24), torch.bfloat16)
    with pytest.raises(ValueError, match="aligned|multiple"):
        decode_scores_hd(_randn(gen, (1, 4, 8), torch.bfloat16),
                         wide[..., 4:12])
    assert (decode_ops.scores_launches, decode_ops.values_launches) == before
