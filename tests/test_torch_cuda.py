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
from repro_torch.kernels.decode_attention import decode_mha, decode_mha_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import mha, mha_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssm_scan import selective_scan, ssm_scan_ref
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models import Model, serving

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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
                                  "hymba-1.5b"])
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
