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


def test_model_kernel_path_matches_plain_path(card):
    cfg = registry.get_smoke("llama3-8b")
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
