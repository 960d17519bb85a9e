"""Qwen3-30B-A3B's serving steps (the moe family: top-k routing, experts
over ``model``, q/k norms) on the CPU meshes (1, 2), (1, 4) and (2, 2):
the port's sharded ``prefill`` and ``decode_step`` on gloo ranks against
the reference's jitted steps under the dry run's shardings, from the
same params and tokens (tests/_torch_mesh.py `MoeServeCases`), smoke in
f32; at B 1 on (2, 2), the ``long_500k`` layout (the batch replicated
over ``data``); a capacity that drops half the prefill's assignments on
(2, 2), where the slots must be the whole batch's, and the same with
``moe_impl="local"``, where they must be each data rank's own; and
``moe_impl="dense"`` on (1, 2). The decode steps start from the
reference's one-device prefill cache and run the dropless dense
dispatch. One reference subprocess for every case, one spawn a world
size."""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models import lm, moe
from repro_torch.models.convert import params_from_numpy
from tests._torch_mesh import (MESHES, MoeServeCases, _f32, _unflat,
                               serve_cases)

ARCH = "qwen3-moe-30b-a3b"
#: the smoke's E 8 and k 2 over B 2 x S 64: A 256 assignments, a
#: capacity of int(256 / 8 x 0.5) = 16 a expert, so about half drop;
#: a data rank's own row has a capacity of 8
CAPACITY = {"capacity_factor": 0.5}
LOCAL = {"moe_impl": "local", **CAPACITY}
#: {key: (arch, overrides, meshes[, batch])}
CASES = {"qwen3": (ARCH, {}, MESHES),
         "qwen3 capacity 0.5": (ARCH, CAPACITY, ((2, 2),)),
         "qwen3 local capacity 0.5": (ARCH, LOCAL, ((2, 2),)),
         "qwen3 dense": (ARCH, {"moe_impl": "dense"}, ((1, 2),)),
         "qwen3 B 1": (ARCH, {}, ((2, 2),), 1)}
RUNS = [(key, shape) for key, case in CASES.items() for shape in case[2]]


@pytest.fixture(scope="module")
def serves(tmp_path_factory):
    return serve_cases(CASES, tmp_path_factory.mktemp("serve_qwen3"))


@pytest.mark.parametrize("key, shape", RUNS,
                         ids=[f"{k}-{s[0]}x{s[1]}" for k, s in RUNS])
class TestQwen3ServeOnMesh(MoeServeCases):
    CASES = CASES


def _layer0_moe_input(cfg, params, tokens):
    """Layer 0's MoE input (after attention and ``ln2``) and its moe
    params, on one device through the plain attention."""
    lp = lm.layer_params(params["layers"], 0)
    x = lm.embed_tokens(cfg, params, tokens)
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + L.attention_layer(lp["attn"], cfg, h, plain=True)[0]
    return L.rms_norm(x, lp["ln2"], cfg.norm_eps), lp["moe"]


def test_per_shard_slots_would_keep_other_assignments(serves):
    """The guard of the capacity cases: on layer 0's MoE input of the
    prompt, the one-device `moe_sorted` over the whole batch keeps other
    assignments than the same sort over each data rank's row on its own.
    At the row's own capacity (8, "local") tokens' outputs differ, so the
    sorted case would fail had a rank ranked its slots among its own row,
    and the local case had it used the whole batch's; at the whole
    batch's (16) row 0's agree and row 1's differ, since its slots start
    after row 0's counts."""
    ref, _ = serves["qwen3 capacity 0.5"]
    cfg = _f32(registry.get_smoke(ARCH)).replace(**CAPACITY)
    params = params_from_numpy(_unflat(ref["params"]))
    tokens = torch.from_numpy(ref["inputs"]["tokens"])
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


def test_local_and_sorted_prefills_differ(serves):
    """The reference's own prefills of the two capacity cases differ on
    (2, 2) (each data rank's capacity against the whole batch's), and the
    port matches each: the local dispatch is not the global one."""
    pairs = [serves[k][1][(2, 2)][0]["prefill"]["logits"]
             for k in ("qwen3 capacity 0.5", "qwen3 local capacity 0.5")]
    assert not np.allclose(pairs[0][1], pairs[1][1], atol=1e-4, rtol=1e-4)


def test_training_keeps_the_global_sort(monkeypatch):
    """With ``moe_impl="local"`` the training forward runs the global
    `moe_sorted`, as the reference's training does, and only a serving
    step reaches `moe_local` (one device: there the two compute the
    same)."""
    cfg = _f32(registry.get_smoke(ARCH)).replace(moe_impl="local",
                                                  num_layers=1)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((1, 8), dtype=torch.int32)

    def refused(*args, **kwargs):
        raise AssertionError("moe_local ran")
    monkeypatch.setattr(moe, "moe_local", refused)
    lm.forward_train(cfg, params, {"tokens": tokens, "targets": tokens},
                     plain=True)
    with pytest.raises(AssertionError, match="moe_local ran"):
        lm.prefill(cfg, params, {"tokens": tokens}, plain=True)
