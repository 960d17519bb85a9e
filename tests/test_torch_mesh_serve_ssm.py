"""The ssm and hybrid families' serving steps on the CPU meshes (1, 2),
(1, 4) and (2, 2): the port's sharded ``prefill`` and ``decode_step`` on
gloo ranks against the reference's jitted steps under the dry run's
shardings (params, batch, the prefill and decode caches with the conv
and ssm states' d_inner over ``model``, the logits), from the same params
and tokens (tests/_torch_mesh.py). falcon-mamba-7b and hymba-1.5b smoke
in f32; hymba also with a window of 48 (the 64-token prompt wraps the
ring in the prefill) and with head_dim 16 (a slice of 4 on (1, 4)); both
at B 1 on (2, 2), the ``long_500k`` layout (the batch replicated over
``data``). The decode steps start from the reference's one-device
prefill cache placed by the decode rules. One reference subprocess for
every case, one spawn a world size."""
import dataclasses

import numpy as np
import pytest

from tests._torch_mesh import (MESHES, S, SERVE_STEPS, _f32, serve_batch,
                               serve_cases)

#: {key: (arch, overrides, meshes[, batch])}
CASES = {"falcon-mamba-7b": ("falcon-mamba-7b", {}, MESHES),
         "hymba-1.5b": ("hymba-1.5b", {}, MESHES),
         "hymba-1.5b window 48": ("hymba-1.5b", {"sliding_window": 48},
                                  ((1, 2),)),
         "hymba-1.5b head_dim 16": ("hymba-1.5b", {"head_dim": 16},
                                    ((1, 4),)),
         "falcon-mamba-7b B 1": ("falcon-mamba-7b", {}, ((2, 2),), 1),
         "hymba-1.5b B 1": ("hymba-1.5b", {}, ((2, 2),), 1)}
#: tests/test_torch_model.py's f32 tolerance; the conv tail, a bf16 leaf
#: of an f32 config, within one bf16 ulp (2^-7 relative), as
#: tests/test_torch_model.py's `_assert_cache_matches` holds it: the
#: packages round f32 values that differ in their last bits to bf16, and
#: one of 1536 elements can land on either side of a rounding boundary
ATOL = RTOL = 1e-4
BF16_ULP = 2 ** -7
#: the decode logits: tests/test_torch_model.py's SSM_F32_DECODE_TOL.
#: Where one element of a decode step's bf16 conv tail lands a bf16 ulp
#: from the reference's (falcon-mamba B 1 on (2, 2): 1 of 768 in layer 1,
#: 1.5703125 against 1.578125), the next step's logits move by 2.4e-4.
#: There the reference's sharded steps are within 1.2e-6 of its
#: one-device steps and the port's one-device steps within 1.9e-6 of the
#: reference's: a rank's in_proj columns round one element the other way
DECODE_TOL = 1e-3
RUNS = [(key, shape) for key, case in CASES.items() for shape in case[2]]


@pytest.fixture(scope="module")
def serves(tmp_path_factory):
    return serve_cases(CASES, tmp_path_factory.mktemp("serve_ssm"))


def _close(pair, what, rtol=RTOL):
    got, want = pair
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=rtol,
                               err_msg=str(what))


def _close_leaf(name, pair, what):
    _close(pair, what, BF16_ULP if name == "conv" else RTOL)


def _cfg(key):
    from repro_torch.configs import registry
    arch, overrides = CASES[key][:2]
    return _f32(registry.get_smoke(arch)).replace(**overrides)


def _rows(key, shape) -> int:
    """A data rank's rows: the batch split over ``data`` where it
    divides, else the whole batch (replicated)."""
    batch = serve_batch(CASES[key])
    return batch // shape[0] if batch % shape[0] == 0 else batch


@pytest.mark.parametrize("key, shape", RUNS,
                         ids=[f"{k}-{s[0]}x{s[1]}" for k, s in RUNS])
class TestSsmServeOnMesh:

    def test_prefill_logits_match_reference(self, serves, key, shape):
        for r, rank in enumerate(serves[key][1][shape]):
            _close(rank["prefill"]["logits"], (key, shape, r))

    def test_prefill_cache_matches_reference(self, serves, key, shape):
        """Every leaf: conv, ssm and pos, and hymba's k, v and
        slot_pos."""
        want = {"conv", "ssm", "pos"} | ({"k", "v", "slot_pos"} if "hymba"
                                         in key else set())
        for r, rank in enumerate(serves[key][1][shape]):
            assert set(rank["prefill"]["cache"]) == want
            for name, pair in rank["prefill"]["cache"].items():
                _close_leaf(name, pair, (key, shape, r, name))

    def test_prefill_shard_shapes_match_reference(self, serves, key, shape):
        ref, port = serves[key]
        want = ref["meshes"][shape]["prefill_shapes"]
        for rank in port[shape]:
            assert rank["prefill_shapes"] == want

    def test_decode_logits_match_reference(self, serves, key, shape):
        for r, rank in enumerate(serves[key][1][shape]):
            assert len(rank["decode"]["logits"]) == SERVE_STEPS
            for i, (got, want) in enumerate(rank["decode"]["logits"]):
                assert got.shape == want.shape
                np.testing.assert_allclose(got, want, atol=DECODE_TOL,
                                           rtol=DECODE_TOL, err_msg=str(
                                               (key, shape, r, "step", i)))

    def test_decode_cache_matches_reference(self, serves, key, shape):
        for r, rank in enumerate(serves[key][1][shape]):
            for name, pair in rank["decode"]["cache"].items():
                _close_leaf(name, pair, (key, shape, r, name))

    def test_decode_shard_shapes_match_reference(self, serves, key, shape):
        """The reference's shards, the conv and ssm states' d_inner over
        ``model``: exactly the rank's channels."""
        ref, port = serves[key]
        want = ref["meshes"][shape]["decode_shapes"]
        di = _cfg(key).d_inner // shape[1]
        for rank in port[shape]:
            assert rank["decode_shapes"] == want
            assert rank["decode_shapes"]["conv"][3] == di
            assert rank["decode_shapes"]["ssm"][2] == di

    def test_to_decode_layout_equals_the_decode_placement(self, serves, key,
                                                          shape):
        assert all(rank["layout_equal"] for rank in serves[key][1][shape])

    def test_collectives_by_kind(self, serves, key, shape):
        """A decode step exchanges each layer's ``in_proj`` columns by one
        ``all_to_all`` of (B / data) x 2 di / model elements and gathers
        no ``in_proj``; it sums each layer's ``x_proj`` (B / data, R + 2N)
        f32 and ``out_proj`` (B / data, 1, D) partial products and the
        vocab-parallel embedding over ``model``; hymba's attention adds
        its four ``all_to_all``s, its f32 score sum (B / data, H, W) and
        the row-parallel ``wo`` and MLP a layer. On (1, n) falcon gathers
        nothing, and neither does hymba on (1, 2); on (1, 4) hymba's
        smoke gathers only ``wk`` and ``wv`` (half a kv head a rank),
        as the dense family's does."""
        from repro_torch.models.kv_cache import cache_width

        cfg = _cfg(key)
        L, D, M = cfg.num_layers, cfg.d_model, shape[1]
        rows = _rows(key, shape)
        attn = cfg.family == "hybrid"
        proj = cfg.dt_rank + 2 * cfg.ssm_state
        for rank in serves[key][1][shape]:
            assert rank["prefill_collectives"]["calls"].get(
                "all_to_all", 0) == (2 * L if attn else 0)
            assert "layers/mamba/in_proj" in rank["prefill_gathers"]
            assert "layers/mamba/in_proj" not in rank["decode_gathers"]
            for c in rank["decode_collectives"]:
                calls, nbytes = c["calls"], c["bytes_by"]
                assert calls["in_proj_all_to_all"] == L
                assert nbytes["in_proj_all_to_all"] == (
                    L * rows * 2 * cfg.d_inner // M * 4)
                assert calls.get("all_to_all", 0) == (4 * L if attn else 0)
                assert calls["all_reduce"] == (4 if attn else 2) * L + 1
                assert nbytes["all_reduce"] == (
                    L * rows * proj * 4
                    + ((3 if attn else 1) * L + 1) * rows * D * 4)
                if attn:
                    W = cache_width(cfg, S)
                    assert calls["score_all_reduce"] == L
                    assert nbytes["score_all_reduce"] == (
                        L * rows * cfg.num_heads * W * 4)
                else:
                    assert "score_all_reduce" not in calls
                if shape[0] == 1 and (not attn or M == 2):
                    assert "all_gather" not in calls
            if shape[0] == 1 and attn and M == 4:
                assert set(rank["decode_gathers"]) == {
                    "layers/attn/wk", "layers/attn/wv"}

    def test_bytes_match_dry_run(self, serves, key, shape):
        """Each rank's params and decode cache: the dry run's per-device
        argument bytes of the decode step at this mesh. Both packages'
        dry runs hold k and v in bf16, so those are counted at the
        model's f32; conv is bf16 and ssm f32 in both packages, whatever
        the model's dtype, and stay as they are."""
        import torch

        from repro_torch.configs import InputShape
        from repro_torch.launch import dryrun
        from repro_torch.launch import sharding as SH
        from repro_torch.launch.mesh import Mesh

        cfg = _cfg(key)
        extra = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}
        cell = dryrun.build_cell(CASES[key][0], InputShape(
            "decode", S, serve_batch(CASES[key]), "decode"), extra=extra,
            mesh=Mesh(("data", "model"), shape))
        want = cell.argument_bytes()
        cache = cell.args["cache"]
        assert cache["conv"].dtype == torch.bfloat16
        assert cache["ssm"].dtype == torch.float32
        want["cache"] = SH.tree_bytes(
            {k: v.to(torch.float32) if k in ("k", "v") else v
             for k, v in cache.items()}, cell.arg_specs["cache"], cell.mesh)
        for rank in serves[key][1][shape]:
            assert rank["bytes"] == {"params": want["params"],
                                     "cache": want["cache"]}


@pytest.mark.parametrize("arch, overrides, shape, what", [
    ("falcon-mamba-7b", {}, (1, 3), "d_inner"),
    ("hymba-1.5b", {}, (1, 3), "head_dim"),
    ("hymba-1.5b", {"head_dim": 24}, (1, 16), "head_dim"),
], ids=["falcon-di256-model3", "hymba-model3", "hymba-hd24-model16"])
def test_a_split_that_model_does_not_divide_raises(arch, overrides, shape,
                                                   what):
    """Where ``model`` does not divide d_inner or head_dim (the decode
    cache's rules then leave it whole), both serving steps raise before
    any work, naming the shapes: nothing runs half-sharded."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import get_model
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.registry import param_structs

    cfg = registry.get_smoke(arch).replace(**overrides)
    tp = SH.serve_placement(Mesh(("data", "model"), shape),
                            param_structs(cfg),
                            kvc.init_cache(cfg, 2, 64, device="meta"))
    model = get_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{what} of .* model "
                       f"{shape[1]} does not split"):
        model.prefill(None, {"tokens": torch.zeros((2, 64),
                                                   dtype=torch.int32)},
                      tp=tp)
    with pytest.raises(NotImplementedError, match=f"{what} of"):
        model.decode_step(None, {}, torch.zeros((2, 1), dtype=torch.int32),
                          tp=tp)
