"""The dense family's serving steps on the CPU meshes (1, 2), (1, 4) and
(2, 2): the port's sharded ``prefill`` and ``decode_step`` on gloo ranks
against the reference's jitted steps under the dry run's shardings
(params, batch, the prefill and decode caches, the logits), from the same
params and tokens (tests/_torch_mesh.py). llama3-8b, granite-8b (tied
head), yi-34b (H 7 over K 1, hd 16: uneven heads, one kv head for every
rank) and qwen2-72b (QKV biases, drawn nonzero) smoke in f32; the decode
steps start from the reference's one-device prefill cache placed by the
decode rules, and the first of them evicts position 0. One reference
subprocess for every case, one spawn a world size. The vlm and enc-dec
families have files of their own (test_torch_mesh_serve_vlm.py,
test_torch_mesh_serve_encdec.py)."""
import dataclasses

import numpy as np
import pytest

from tests._torch_mesh import B, MESHES, S, SERVE_STEPS, _f32, serve_cases

ARCHS = ("llama3-8b", "granite-8b", "yi-34b", "qwen2-72b")
#: {key: (arch, overrides, meshes)}
CASES = {**{arch: (arch, {}, MESHES) for arch in ARCHS},
         "llama3-8b uniform_decode": ("llama3-8b", {"uniform_decode": True},
                                      ((2, 2),))}
#: tests/test_torch_model.py's f32 tolerance
ATOL = RTOL = 1e-4
RUNS = [(key, shape) for key, (_, _, meshes) in CASES.items()
        for shape in meshes]


@pytest.fixture(scope="module")
def serves(tmp_path_factory):
    return serve_cases(CASES, tmp_path_factory.mktemp("serve"))


def _close(pair, what):
    got, want = pair
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                               err_msg=str(what))


def _cfg(key):
    from repro_torch.configs import registry
    arch, overrides, _ = CASES[key]
    return _f32(registry.get_smoke(arch)).replace(**overrides)


@pytest.mark.parametrize("key, shape", RUNS,
                         ids=[f"{k}-{s[0]}x{s[1]}" for k, s in RUNS])
class TestServeOnMesh:

    def test_prefill_logits_match_reference(self, serves, key, shape):
        for r, rank in enumerate(serves[key][1][shape]):
            _close(rank["prefill"]["logits"], (key, shape, r))

    def test_prefill_cache_matches_reference(self, serves, key, shape):
        for r, rank in enumerate(serves[key][1][shape]):
            for name, pair in rank["prefill"]["cache"].items():
                _close(pair, (key, shape, r, name))

    def test_prefill_shard_shapes_match_reference(self, serves, key, shape):
        ref, port = serves[key]
        want = ref["meshes"][shape]["prefill_shapes"]
        for rank in port[shape]:
            assert rank["prefill_shapes"] == want

    def test_decode_logits_match_reference(self, serves, key, shape):
        for r, rank in enumerate(serves[key][1][shape]):
            assert len(rank["decode"]["logits"]) == SERVE_STEPS
            for i, pair in enumerate(rank["decode"]["logits"]):
                _close(pair, (key, shape, r, "step", i))

    def test_decode_cache_matches_reference(self, serves, key, shape):
        for r, rank in enumerate(serves[key][1][shape]):
            for name, pair in rank["decode"]["cache"].items():
                _close(pair, (key, shape, r, name))

    def test_decode_shard_shapes_match_reference(self, serves, key, shape):
        ref, port = serves[key]
        want = ref["meshes"][shape]["decode_shapes"]
        for rank in port[shape]:
            assert rank["decode_shapes"] == want

    def test_to_decode_layout_equals_the_decode_placement(self, serves, key,
                                                          shape):
        assert all(rank["layout_equal"] for rank in serves[key][1][shape])

    def test_collectives_by_kind(self, serves, key, shape):
        """A prefill sends each layer's k and v by one ``all_to_all``
        each; a decode step moves q, k, v and the outputs by four a layer,
        sums each layer's f32 scores (B / data, H, W) over ``model`` (its
        own kind), and the vocab-parallel embedding and each layer's two
        row-parallel products (B / data, 1, D). On (1, 2) every rank
        holds whole kv heads and no FSDP dim: nothing is gathered."""
        cfg = _cfg(key)
        L, D = cfg.num_layers, cfg.d_model
        rows = B // shape[0]
        for rank in serves[key][1][shape]:
            assert rank["prefill_collectives"]["calls"]["all_to_all"] == 2 * L
            for c in rank["decode_collectives"]:
                assert c["calls"]["all_to_all"] == 4 * L
                assert c["calls"]["score_all_reduce"] == L
                assert c["bytes_by"]["score_all_reduce"] == (
                    L * rows * cfg.num_heads * S * 4)
                assert c["calls"]["all_reduce"] == 2 * L + 1
                assert c["bytes_by"]["all_reduce"] == (
                    (2 * L + 1) * rows * D * 4)
                if shape == (1, 2) and key != "yi-34b":
                    assert "all_gather" not in c["calls"]

    def test_bytes_match_dry_run(self, serves, key, shape):
        """Each rank's params and decode cache: the dry run's per-device
        argument bytes of the decode step at this mesh (its cache, which
        both packages' dry runs hold in bf16, counted at the model's f32
        under the dry run's specs)."""
        import torch

        from repro_torch.configs import InputShape
        from repro_torch.launch import dryrun
        from repro_torch.launch import sharding as SH
        from repro_torch.launch.mesh import Mesh

        cfg = _cfg(key)
        extra = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}
        cell = dryrun.build_cell(CASES[key][0], InputShape(
            "decode", S, B, "decode"), extra=extra,
            mesh=Mesh(("data", "model"), shape))
        want = cell.argument_bytes()
        want["cache"] = SH.tree_bytes(
            {k: v.to(torch.float32) if v.is_floating_point() else v
             for k, v in cell.args["cache"].items()},
            cell.arg_specs["cache"], cell.mesh)
        for rank in serves[key][1][shape]:
            assert rank["bytes"] == {"params": want["params"],
                                     "cache": want["cache"]}


def test_a_prompt_that_model_does_not_divide():
    """A prompt of 63 on (1, 2): ``model`` does not divide W, so the
    prefill cache keeps every slot on each rank (the rule's guard) and
    `to_decode_layout` cuts the head_dim slice locally; the steps still
    equal the one-device steps."""
    from repro_torch.launch.ranks import spawn
    from tests._torch_mesh import RANK_TIMEOUT_S

    ranks = spawn("tests._torch_mesh:serve_one_device_pairs", 2, {
        "arch": "llama3-8b", "shape": (1, 2), "seq": 63},
        timeout_s=RANK_TIMEOUT_S)
    for r, rank in enumerate(ranks):
        assert rank["prefill_spec"][2] is None           # W not split
        assert len(rank["pairs"]) == SERVE_STEPS + 1
        for i, pair in enumerate(rank["pairs"]):
            _close(pair, ("rank", r, "output", i))
