"""Qwen3-30B-A3B (the moe family: top-k routing, experts over ``model``,
q/k norms) smoke trained on the CPU meshes (1, 2), (1, 4) and (2, 2)
against the reference's jitted step under its state and batch
shardings (tests/_torch_mesh.py), its load-balancing loss on its own; a
capacity that drops half the assignments on (2, 2), where the slots must
be the whole batch's; and ``moe_impl="dense"`` on (1, 2)."""
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models import lm, moe
from repro_torch.models.convert import params_from_numpy
from tests._torch_mesh import (MESHES, MoeMeshCases, _f32, _unflat,
                               assert_step_matches, mesh_cases)

ARCH = "qwen3-moe-30b-a3b"
#: the smoke's E 8 and k 2 over B 2 x S 64: A 256 assignments, a
#: capacity of int(256 / 8 x 0.5) = 16 a expert, so half of them drop
CAPACITY = {"capacity_factor": 0.5}
CAP_MESH = (2, 2)
DENSE = {"moe_impl": "dense"}
DENSE_MESH = (1, 2)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """`mesh_cases` of the smoke on every mesh of `MESHES`, with
    `CAPACITY` on (2, 2) (each data rank holds one of the batch's two
    rows) and with ``moe_impl="dense"`` on (1, 2)."""
    return mesh_cases(ARCH, tmp_path_factory.mktemp("ref"), {
        "main": (None, MESHES), "capacity": (CAPACITY, [CAP_MESH]),
        "dense": (DENSE, [DENSE_MESH])})


@pytest.fixture(scope="module")
def runs(cases):
    return cases["main"]


@pytest.fixture(scope="module")
def capacity_runs(cases):
    return cases["capacity"]


@pytest.fixture(scope="module")
def dense_runs(cases):
    return cases["dense"]


class TestQwen3MoeMesh(MoeMeshCases):
    ARCH = ARCH


def _layer0_moe_input(cfg, params, tokens):
    """Layer 0's MoE input (after attention and ``ln2``) and its moe
    params, on one device through the plain attention."""
    lp = lm.layer_params(params["layers"], 0)
    x = lm.embed_tokens(cfg, params, tokens)
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + L.attention_layer(lp["attn"], cfg, h, plain=True)[0]
    return L.rms_norm(x, lp["ln2"], cfg.norm_eps), lp["moe"]


def test_per_shard_slots_would_keep_other_assignments(capacity_runs):
    """The guard of the capacity case: on layer 0's MoE input, the port's
    one-device `moe_sorted` over the whole batch keeps other assignments
    than the same sort over each data rank's row on its own. At the
    shard's own capacity (8) tokens' outputs differ; at the whole batch's
    (16) row 0's agree, since it comes first in the whole batch's sort,
    and row 1's differ, since its slots start after row 0's counts. So a
    mesh that sorted only its rows would not match the reference."""
    ref, _, _ = capacity_runs
    cfg = _f32(registry.get_smoke(ARCH)).replace(**CAPACITY)
    params = params_from_numpy(_unflat(ref["params"]))
    tokens = torch.from_numpy(ref["batch"]["tokens"])
    with torch.no_grad():
        x, p = _layer0_moe_input(cfg, params, tokens)
        whole = moe.moe_sorted(p, cfg, x)[0]

        def per_row(c):
            return torch.cat([moe.moe_sorted(p, c, x[i:i + 1])[0]
                              for i in range(x.shape[0])])
        own_cap = (whole != per_row(cfg)).any(-1).sum(-1)     # (B,)
        whole_cap = (whole != per_row(cfg.replace(capacity_factor=1.0))
                     ).any(-1).sum(-1)
    assert int(own_cap.sum()) > 0, own_cap
    assert int(whole_cap[0]) == 0 and int(whole_cap[1]) > 0, whole_cap


def test_global_slots_match_reference(capacity_runs):
    """The capacity case on (2, 2) against the reference's jitted step:
    loss, grad norm and load-balancing loss at rtol 1e-5, updates within
    2e-2 in norm, first moments within 1e-4 of their largest |value|."""
    ref, port, _ = capacity_runs
    assert_step_matches(ref["meshes"][CAP_MESH], port[CAP_MESH],
                        ref["params"])


def test_global_slots_match_the_one_device_step(capacity_runs):
    ref, port, one = capacity_runs
    assert_step_matches(one, port[CAP_MESH], ref["params"])


def test_dense_dispatch_matches_reference(dense_runs):
    """Each rank runs its 4 experts on every token with its columns of
    the combine weight, the outputs summed over ``model``: against the
    reference's jitted step (GSPMD's partition of its `moe_dense`)."""
    ref, port, _ = dense_runs
    assert_step_matches(ref["meshes"][DENSE_MESH], port[DENSE_MESH],
                        ref["params"])
    assert [r["gathers"] for r in port[DENSE_MESH]] == [{}, {}]


def test_dense_dispatch_matches_the_one_device_step(dense_runs):
    ref, port, one = dense_runs
    assert_step_matches(one, port[DENSE_MESH], ref["params"])
