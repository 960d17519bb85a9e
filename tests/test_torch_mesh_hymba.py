"""Hymba-1.5B (the hybrid family) smoke trained on the CPU meshes (1, 2),
(1, 4) and (2, 2) against the reference's jitted step under its state
and batch shardings (tests/_torch_mesh.py); and a smoke whose heads and
vocab split over ``model`` as the full config's do (H 10 over K 2, G 5,
as 25 over 5; an odd vocab of 513, as 32001) against the same reference
step and the port's one-device step."""
import numpy as np
import pytest

from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh
from tests._torch_mesh import (LOSS_RTOL, MeshCases, _close_leaves,
                               mesh_runs, runs)  # noqa: F401

ARCH = "hymba-1.5b"


class TestHymbaMesh(MeshCases):
    ARCH = ARCH

    @staticmethod
    def want_gathers(cfg, shape) -> dict:
        """``in_proj`` at every ``model`` > 1, in each layer's forward and
        its recompute (a rank's channels of ``[x | z]`` are never its own
        shard); the smoke's attention (H 4 over K 2, hd 32) as the dense
        family's: at ``model`` 4 the 16 k/v columns a rank are half a kv
        head, so wk and wv are gathered too; at ``model`` 2 each rank's
        heads are whole shards."""
        want = {"layers/mamba/in_proj": 2 * cfg.num_layers}
        if shape[1] == 4:
            want.update({f"layers/attn/{n}": 2 * cfg.num_layers
                         for n in ("wk", "wv")})
        return want


#: hymba-1.5b's split, cut to the smoke: G 5 (H 10 over K 2) and an odd
#: vocab, so the embedding and head are replicated over ``model`` and the
#: vocab-parallel loss cuts them
SPLIT_LIKE_FULL = {"num_heads": 10, "num_kv_heads": 2, "vocab_size": 513}
SPLIT_CASES = [
    # model 2: q heads [0, 5) and [5, 10), whole kv groups and shards
    ((1, 2), ("mamba/in_proj",)),
    # model 4: q heads [0, 2), [2, 5), [5, 7), [7, 10): 2.5 heads of
    # columns a rank, so wq, wk, wv and wo are gathered; the ranks whose
    # heads cross a group take one kv head a q head
    ((1, 4), ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mamba/in_proj")),
]
SPLIT_IDS = ["1x2", "1x4"]


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    """`mesh_runs` of the smoke with `SPLIT_LIKE_FULL` on (1, 2) and
    (1, 4)."""
    return mesh_runs(ARCH, tmp_path_factory.mktemp("split"),
                     SPLIT_LIKE_FULL, [shape for shape, _ in SPLIT_CASES])


@pytest.mark.parametrize("shape, gathered", SPLIT_CASES, ids=SPLIT_IDS)
def test_heads_and_vocab_split_as_the_full_config(split_runs, shape,
                                                  gathered):
    """Against the reference's jitted step under its shardings: loss and
    grad norm at rtol 1e-5, each params leaf's update within 2e-2 of its
    update in norm and first moments within 1e-4 of their largest
    |value|, the reference's shard shapes (the embedding and head whole
    over ``model``); every rank counts its gathers, two a layer (the
    forward and its recompute)."""
    mesh = Mesh(("data", "model"), shape)
    assert "model" not in SH.param_spec("embed", (513, 128), mesh)
    ref, port, _ = split_runs
    want = ref["meshes"][shape]
    for r in port[shape]:
        np.testing.assert_allclose([r["loss"], r["grad_norm"]],
                                   [want["loss"], want["grad_norm"]],
                                   rtol=LOSS_RTOL)
        assert r["gathers"] == {f"layers/{n}": 4 for n in gathered}
        assert {k: v for k, v in r["shard_shapes"].items()
                if k != "step"} == want["shard_shapes"]
    for what in ("params", "mu"):
        _close_leaves(port[shape][0][what], want[what], what, ref["params"])


@pytest.mark.parametrize("shape", [s for s, _ in SPLIT_CASES], ids=SPLIT_IDS)
def test_heads_and_vocab_split_matches_the_one_device_step(split_runs,
                                                           shape):
    """The same steps against the port's one-device step from the same
    params and batch, at the same tolerances."""
    ref, port, one = split_runs
    for r in port[shape]:
        np.testing.assert_allclose([r["loss"], r["grad_norm"]],
                                   [one["loss"], one["grad_norm"]],
                                   rtol=LOSS_RTOL)
    for what in ("params", "mu"):
        _close_leaves(port[shape][0][what], one[what], what, ref["params"])
