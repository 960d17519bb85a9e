"""The port's cell table and analytic FLOPs model against the reference
(`repro.configs.base`, `repro.models.flops`).

The cell table is data and the FLOPs model pure arithmetic over configs,
so both are held equal exactly: lists element for element, and every
FLOP and byte figure equal as a float, on all 40 (arch x shape) cells.
"""
import dataclasses
import functools

import pytest

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.models import flops as ref_flops
from repro.models import kv_cache as ref_kvc
from repro.models import registry as ref_model_registry
from repro_torch.configs import (ARCH_IDS, SHAPES, all_cells,
                                 cell_is_runnable, registry)
from repro_torch.models import flops
from repro_torch.models import kv_cache as kvc

CELLS = ref_base.all_cells()


@functools.lru_cache(maxsize=None)
def _ref_count(cfg, active_only):
    return ref_model_registry.param_count(cfg, active_only=active_only)


@pytest.fixture
def ref_counts_cached(monkeypatch):
    """The reference's configs count their params once per config (each
    count traces the model's init)."""
    monkeypatch.setattr(ref_base.ModelConfig, "param_count",
                        lambda self: _ref_count(self, False))
    monkeypatch.setattr(ref_base.ModelConfig, "active_param_count",
                        lambda self: _ref_count(self, True))


def test_cell_table_equals_reference():
    assert ARCH_IDS == ref_base.ARCH_IDS
    assert registry.all_ids() == ref_registry.all_ids()
    assert list(SHAPES) == list(ref_base.SHAPES)
    for name, shape in SHAPES.items():
        assert (dataclasses.astuple(shape)
                == dataclasses.astuple(ref_base.SHAPES[name]))
        assert shape.is_decode == ref_base.SHAPES[name].is_decode
    assert all_cells() == CELLS
    assert len(CELLS) == 40


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_is_runnable_equals_reference(arch, shape):
    assert (cell_is_runnable(registry.get(arch), SHAPES[shape])
            == ref_base.cell_is_runnable(ref_registry.get(arch),
                                         ref_base.SHAPES[shape]))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equals_reference(ref_counts_cached, arch, shape):
    """Every key of `model_flops`, and `hbm_bytes_ideal` on 256 and 8
    devices, equal as floats (the arithmetic is in the same order)."""
    cfg, ref_cfg = registry.get(arch), ref_registry.get(arch)
    got = flops.model_flops(cfg, SHAPES[shape])
    want = ref_flops.model_flops(ref_cfg, ref_base.SHAPES[shape])
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
        assert type(got[key]) is type(want[key]), key
    for devices in (256, 8):
        assert (flops.hbm_bytes_ideal(cfg, SHAPES[shape], devices=devices)
                == ref_flops.hbm_bytes_ideal(ref_cfg, ref_base.SHAPES[shape],
                                             devices=devices))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layer_flops_equal_reference(arch):
    """The per-layer terms at shapes off the cell table: decode, causal
    and bidirectional prefill, past and within a window."""
    cfg, ref_cfg = registry.get(arch), ref_registry.get(arch)
    for B, Sq, Skv in ((1, 1, 7), (3, 1, 70_000), (2, 100, 100),
                       (4, 5000, 5000), (1, 4096, 8192)):
        for causal in (True, False):
            assert (flops._attn_flops_layer(cfg, B, Sq, Skv, causal)
                    == ref_flops._attn_flops_layer(ref_cfg, B, Sq, Skv,
                                                   causal))
        assert (flops._ssm_flops_layer(cfg, B, Sq)
                == ref_flops._ssm_flops_layer(ref_cfg, B, Sq))
    for S in (1, 4096, 524_288):
        assert kvc.cache_width(cfg, S) == ref_kvc.cache_width(ref_cfg, S)


def test_smoke_configs_flops_equal_reference(ref_counts_cached):
    shape = ref_base.InputShape("serve", 32, 2, "prefill")
    for arch in ARCH_IDS:
        for kind in ("train", "prefill", "decode"):
            s = dataclasses.replace(shape, kind=kind)
            assert (flops.model_flops(registry.get_smoke(arch), s)
                    == ref_flops.model_flops(ref_registry.get_smoke(arch), s))


class TestLongContext:
    def test_swa_ring_cache_is_window_bounded(self):
        """long_500k viability: cache width never exceeds the window."""
        cfg = registry.get_smoke("mixtral-8x22b")
        cache = kvc.init_cache(cfg, batch=1, seq_len=8192, device="meta")
        assert cache["k"].shape[2] == cfg.sliding_window
        assert cell_is_runnable(registry.get("mixtral-8x22b"),
                                SHAPES["long_500k"])[0]

    def test_full_attn_long_context_skipped(self):
        ok, why = cell_is_runnable(registry.get("llama3-8b"),
                                   SHAPES["long_500k"])
        assert not ok and "full-attn" in why

    def test_ssm_decode_state_is_o1(self):
        cfg = registry.get_smoke("falcon-mamba-7b")
        c1 = kvc.init_cache(cfg, batch=1, seq_len=1024, device="meta")
        c2 = kvc.init_cache(cfg, batch=1, seq_len=1 << 19, device="meta")
        assert c1["ssm"].shape == c2["ssm"].shape      # O(1) in context


class TestParamAccounting:
    def test_published_param_counts(self):
        """Analytic param counts land near the published model sizes."""
        expect = {"llama3-8b": 8.0e9, "qwen2-72b": 72.7e9,
                  "yi-34b": 34.4e9, "mixtral-8x22b": 141e9,
                  "falcon-mamba-7b": 7.3e9}
        for arch, n in expect.items():
            got = registry.get(arch).param_count()
            assert abs(got - n) / n < 0.12, f"{arch}: {got:.3g} vs {n:.3g}"

    def test_moe_active_params(self):
        cfg = registry.get("mixtral-8x22b")
        total, active = cfg.param_count(), cfg.active_param_count()
        assert active < total * 0.45          # top-2 of 8 experts + shared
        assert active > total * 0.15
