"""Falcon-Mamba-7B (the ssm family) smoke trained on the CPU meshes
(1, 2), (1, 4) and (2, 2): the port's sharded step on gloo ranks, the
selective scan on each rank's d_inner channels, against the reference's
jitted step under its state and batch shardings (tests/_torch_mesh.py);
and the plain path's chunked scan under ``inner_remat`` on a mesh against
the same reference step and the one-device step."""
import numpy as np
import pytest

from tests._torch_mesh import (LOSS_RTOL, MeshCases, _close_leaves,
                               mesh_runs, runs)  # noqa: F401

ARCH = "falcon-mamba-7b"


class TestFalconMesh(MeshCases):
    ARCH = ARCH

    @staticmethod
    def want_gathers(cfg, shape) -> dict:
        """``in_proj``'s columns are ``[x | z]``: a rank's channels are a
        range of each half, never its own shard, so every rank gathers it
        over ``model`` once in each layer's forward and once in its remat
        recompute, at every ``model`` > 1. No other leaf is gathered."""
        return {"layers/mamba/in_proj": 2 * cfg.num_layers}


REMAT = {"inner_remat": True}
REMAT_MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def remat_runs(tmp_path_factory):
    """`mesh_runs` of the smoke under ``inner_remat`` on (1, 2) and
    (2, 2), the port through its plain path."""
    return mesh_runs(ARCH, tmp_path_factory.mktemp("remat"), REMAT,
                     REMAT_MESHES, plain=True)


@pytest.mark.parametrize("shape", REMAT_MESHES, ids=["1x2", "2x2"])
def test_plain_chunked_scan_with_inner_remat_on_a_mesh(remat_runs, shape):
    """``plain=True`` runs `mamba.ssm_scan_chunked` on each rank's
    channels (chunks of 128 steps under ``inner_remat``, over the smoke's
    S 64 one chunk), against the reference's jitted step under its
    shardings (its chunked scan under ``jax.checkpoint``): loss and grad
    norm at rtol 1e-5, updates within 2e-2 in norm, first moments within
    1e-4 of their largest |value|; ``in_proj`` gathered in each layer's
    forward and recompute."""
    ref, port, _ = remat_runs
    want = ref["meshes"][shape]
    for r in port[shape]:
        np.testing.assert_allclose([r["loss"], r["grad_norm"]],
                                   [want["loss"], want["grad_norm"]],
                                   rtol=LOSS_RTOL)
        assert r["gathers"] == {"layers/mamba/in_proj": 4}
    for what in ("params", "mu"):
        _close_leaves(port[shape][0][what], want[what], what, ref["params"])


@pytest.mark.parametrize("shape", REMAT_MESHES, ids=["1x2", "2x2"])
def test_plain_chunked_scan_on_a_mesh_matches_one_device(remat_runs, shape):
    """The same steps against the port's one-device plain step from the
    same params and batch, at the same tolerances."""
    ref, port, one = remat_runs
    for r in port[shape]:
        np.testing.assert_allclose([r["loss"], r["grad_norm"]],
                                   [one["loss"], one["grad_norm"]],
                                   rtol=LOSS_RTOL)
    for what in ("params", "mu"):
        _close_leaves(port[shape][0][what], one[what], what, ref["params"])
