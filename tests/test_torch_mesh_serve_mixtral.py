"""Mixtral-8x22B's serving steps (the moe family with a sliding window:
top-2 of 4 experts in the smoke, window 64) on the CPU meshes (1, 2),
(1, 4) and (2, 2): the port's sharded ``prefill`` and ``decode_step`` on
gloo ranks against the reference's jitted steps under the dry run's
shardings, from the same params and tokens (tests/_torch_mesh.py
`MoeServeCases`), smoke in f32; at B 1 on (2, 2), the ``long_500k``
layout (the batch replicated over ``data``); with a window of 48, so the
64-token prompt wraps the ring; and the experts' fallback layout, where
``model`` does not divide E: E 3 on (1, 2) and on (1, 4), where rank 0
holds no expert. One reference subprocess for every case, one spawn a
world size."""
import pytest

from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel.placement import Sharded
from tests._torch_mesh import (MESHES, SERVE_STEPS, MoeServeCases,
                               serve_cases)

ARCH = "mixtral-8x22b"
#: E 3 over ``model`` 2 and 4, which do not divide it (the reference's
#: fallback rule: D of the stacked gate and up leaves over ``model``)
FALLBACK = ((1, 2), (1, 4))
#: {key: (arch, overrides, meshes[, batch])}
CASES = {"mixtral": (ARCH, {}, MESHES),
         "mixtral window 48": (ARCH, {"sliding_window": 48}, ((1, 2),)),
         "mixtral E 3": (ARCH, {"num_experts": 3}, FALLBACK),
         "mixtral B 1": (ARCH, {}, ((2, 2),), 1)}
RUNS = [(key, shape) for key, case in CASES.items() for shape in case[2]]


@pytest.fixture(scope="module")
def serves(tmp_path_factory):
    return serve_cases(CASES, tmp_path_factory.mktemp("serve_mixtral"))


@pytest.mark.parametrize("key, shape", RUNS,
                         ids=[f"{k}-{s[0]}x{s[1]}" for k, s in RUNS])
class TestMixtralServeOnMesh(MoeServeCases):
    CASES = CASES


def test_window_48_wraps_the_ring(serves):
    """The 64-token prompt in a ring of 48: the prefill cache is 48 slots
    wide (24 a rank over ``model`` 2), and the decode cache holds every
    slot with its head_dim halved."""
    ref, port = serves["mixtral window 48"]
    shapes = ref["meshes"][(1, 2)]
    assert shapes["prefill_shapes"]["k"][2] == 24
    assert shapes["decode_shapes"]["k"][2] == 48
    assert port[(1, 2)][0]["decode_shapes"]["k"][4] == 32 // 2


@pytest.mark.parametrize("shape", FALLBACK, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fallback_runs_each_rank_s_experts(serves, shape):
    """E 3: the reference's fallback specs (D of w_gate and w_up over
    ``model``), so each rank gathers w_gate and w_up over ``model`` in
    every layer of the prefill and of each decode step and cuts its
    experts of ``split(3)``: [0, 1) and [1, 3) on (1, 2); on (1, 4) rank
    0's range is empty ([0, 0)), so it runs no product and still joins
    the gathers and the sum over ``model``. The attention's k/v columns
    are gathered as the dense family's where ``model`` 4 splits its kv
    heads (the smoke's K 2)."""
    E, Lyr, D, F = 3, 2, 128, 256
    mesh = Mesh(("data", "model"), shape)
    assert SH.param_spec("layers/moe/w_gate", (Lyr, E, D, F), mesh) == (
        None, "data", "model", None)
    ranges = Sharded(mesh, {}, {}, ("data",), None).splits(E)
    assert ranges == ([(0, 1), (1, 3)] if shape[1] == 2 else
                      [(0, 0), (0, 1), (1, 2), (2, 3)])
    moe = {f"layers/moe/{n}": Lyr for n in ("w_gate", "w_up")}
    attn = ({f"layers/attn/{n}": Lyr for n in ("wk", "wv")}
            if shape[1] == 4 else {})
    for rank in serves["mixtral E 3"][1][shape]:
        assert rank["prefill_gathers"] == {**moe, **attn}
        assert rank["decode_gathers"] == {
            k: v * SERVE_STEPS for k, v in {**moe, **attn}.items()}
