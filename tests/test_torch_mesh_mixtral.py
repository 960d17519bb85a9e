"""Mixtral-8x22B (the moe family with a sliding window: top-2 of 4
experts in the smoke, window 64) smoke trained on the CPU meshes (1, 2),
(1, 4) and (2, 2) against the reference's jitted step under its state
and batch shardings (tests/_torch_mesh.py), its load-balancing loss on
its own; and the experts' fallback layout, where ``model`` does not
divide E (E 3 on (1, 2), E 6 on (1, 4)), against the same reference
step and the port's one-device step."""
import pytest

from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh
from tests._torch_mesh import (MESHES, MoeMeshCases, assert_step_matches,
                               mesh_cases)

ARCH = "mixtral-8x22b"


#: E over ``model`` sizes it does not divide: the reference's rule then
#: splits D of the stacked (L, E, D, F) gate and up leaves over ``model``
#: (and E over the data axes) and F of the (L, E, F, D) down leaf over
#: the data axes (ROADMAP Queue 3 item 5's stacked-axis miss); each rank
#: gathers gate and up over ``model`` and cuts its experts of
#: ``split(E)`` (E 3 over 2: [0, 1) and [1, 3))
FALLBACK = [(3, (1, 2)), (6, (1, 4))]
FALLBACK_IDS = ["E3-1x2", "E6-1x4"]


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """`mesh_cases` of the smoke on every mesh of `MESHES`, and with each
    E of `FALLBACK` on its mesh."""
    return mesh_cases(ARCH, tmp_path_factory.mktemp("ref"), {
        "main": (None, MESHES), **{f"E{E}": ({"num_experts": E}, [shape])
                                   for E, shape in FALLBACK}})


@pytest.fixture(scope="module")
def runs(cases):
    return cases["main"]


@pytest.fixture(params=FALLBACK, ids=FALLBACK_IDS)
def fallback_runs(request, cases):
    E, shape = request.param
    return E, shape, cases[f"E{E}"]


class TestMixtralMesh(MoeMeshCases):
    ARCH = ARCH


def test_fallback_layout_matches_reference(fallback_runs):
    """Against the reference's jitted step under its shardings: loss,
    grad norm and load-balancing loss at rtol 1e-5, updates within 2e-2
    in norm, first moments within 1e-4 of their largest |value|, the
    reference's shard shapes; every rank gathers ``w_gate`` and ``w_up``
    over ``model`` in each layer's forward and its recompute, and the
    attention's k/v columns as the dense family's at ``model`` 4."""
    E, shape, (ref, port, _) = fallback_runs
    mesh = Mesh(("data", "model"), shape)
    L, D, F = 2, 128, 256
    assert SH.param_spec("layers/moe/w_gate", (L, E, D, F), mesh) == (
        None, "data", "model", None)
    assert SH.param_spec("layers/moe/w_down", (L, E, F, D), mesh) == (
        None, None, "data", None)
    want = ref["meshes"][shape]
    assert_step_matches(want, port[shape], ref["params"])
    gathered = {f"layers/moe/{n}": 2 * L for n in ("w_gate", "w_up")}
    if shape[1] == 4:
        gathered.update({f"layers/attn/{n}": 2 * L for n in ("wk", "wv")})
    for r in port[shape]:
        assert r["gathers"] == gathered
        assert {k: v for k, v in r["shard_shapes"].items()
                if k != "step"} == want["shard_shapes"]


def test_fallback_layout_matches_the_one_device_step(fallback_runs):
    E, shape, (ref, port, one) = fallback_runs
    assert_step_matches(one, port[shape], ref["params"])
