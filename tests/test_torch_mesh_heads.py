"""The sharded step where heads do not split evenly over ``model``
(yi-34b smoke's 7 q heads over 1 kv head at model 2 and 4, and 8 over 4
at model 3) against the port's one-device step, on gloo CPU ranks
(tests/_torch_mesh.py)."""
import numpy as np
import pytest

from repro_torch.launch.ranks import spawn
from tests._torch_mesh import (LOSS_RTOL, RANK_TIMEOUT_S, _close_leaves,
                               one_step)


@pytest.mark.parametrize("arch, overrides, shape, gathered", [
    # yi-34b smoke: H 7 over K 1, hd 16: 3.5 q heads a rank at model 2,
    # 1.75 at model 4; ranks take 3 and 4 heads (1 or 2 at model 4)
    ("yi-34b", {}, (1, 2), ("wq", "wk", "wv", "wo")),
    ("yi-34b", {}, (1, 4), ("wq", "wk", "wv", "wo")),
    ("yi-34b", {}, (2, 2), ("wq", "wk", "wv", "wo")),
    # H 8 over K 4 (G 2), hd 16 at model 3: 3 divides neither 128 nor
    # 64 columns, so the projections are replicated and each rank cuts
    # its heads [0, 2), [2, 5), [5, 8); the middle rank's kv heads 1 and
    # 2 go one a q head
    ("llama3-8b", {"num_heads": 8, "num_kv_heads": 4, "head_dim": 16},
     (1, 3), ()),
], ids=["yi-1x2", "yi-1x4", "yi-2x2", "g2-1x3"])
def test_heads_that_do_not_split_evenly(arch, overrides, shape, gathered):
    """Where a rank's q heads are not whole shards (or not whole kv
    groups) the step still equals the port's one-device step: loss and
    grad norm at rtol 1e-5, each params leaf's update within 2e-2 of the
    one-device update in norm and first moments within 1e-4 of their
    largest |value|; every rank counts its gathers."""
    one = one_step(arch, overrides)
    ranks = spawn("tests._torch_mesh:one_step", shape[0] * shape[1], {
        "arch": arch, "overrides": overrides, "shape": shape},
        timeout_s=RANK_TIMEOUT_S)
    for r in ranks:
        np.testing.assert_allclose([r["loss"], r["grad_norm"]],
                                   [one["loss"], one["grad_norm"]],
                                   rtol=LOSS_RTOL)
        assert sorted(r["gathers"]) == sorted(f"layers/attn/{n}"
                                              for n in gathered)
    for what in ("params", "mu"):
        _close_leaves(ranks[0][what], one[what], what, one["init"])


@pytest.mark.parametrize("policy, shape", [("none", (2, 2)),
                                           ("full", (1, 4))])
def test_remat_policies_on_a_mesh(policy, shape):
    """The other remat policies on a mesh (the smoke configs' is "dots"):
    "full" gathers every weight again in the recompute, "none" keeps the
    gathered weights; both equal the one-device step, and the head-split
    gathers count one a layer per pass (at model 4: 2 a layer under
    "full", 1 under "none")."""
    overrides = {"remat_policy": policy}
    one = one_step("llama3-8b", overrides)
    ranks = spawn("tests._torch_mesh:one_step", shape[0] * shape[1], {
        "arch": "llama3-8b", "overrides": overrides, "shape": shape},
        timeout_s=RANK_TIMEOUT_S)
    passes = 1 if policy == "none" else 2
    for r in ranks:
        np.testing.assert_allclose([r["loss"], r["grad_norm"]],
                                   [one["loss"], one["grad_norm"]],
                                   rtol=LOSS_RTOL)
        assert r["gathers"] == ({} if shape[1] == 2 else {
            f"layers/attn/{n}": 2 * passes for n in ("wk", "wv")})
    for what in ("params", "mu"):
        _close_leaves(ranks[0][what], one[what], what, one["init"])
