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
from repro_torch.models import Model

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
