"""The train driver on a mesh (``repro_torch.launch.train --mesh``), its
collectives (``parallel/collectives.py``), placement
(``parallel/placement.py``, built by ``launch/sharding.py``) and the
checkpoints of a sharded run, on gloo CPU ranks spawned by
``repro_torch.launch.ranks.spawn`` (each with its own time limit) and in
one ``python -m torch.distributed.run`` subprocess."""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import _items, save_checkpoint
from repro_torch.configs import registry
from repro_torch.core.storage import ObjectStore
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train
from repro_torch.launch.ranks import spawn
from tests._torch_mesh import RANK_TIMEOUT_S

ROOT = Path(__file__).resolve().parents[1]


def test_prod_mesh_on_a_world_of_one_exits_naming_its_ranks():
    for kind, n in (("prod", 256), ("multipod", 512)):
        with pytest.raises(SystemExit, match=f"needs {n} ranks"):
            train.main(["--arch", "llama3-8b", "--smoke", "--mesh", kind,
                        "--device", "cpu", "--steps", "1"])


def test_other_families_exit_on_a_mesh_of_two_naming_their_item():
    """On a (1, 2) mesh the vlm and enc-dec configs exit, as the
    reference's driver refuses them (the driver names the token-LM
    archs it covers, and `lm.check_mesh` refuses them under a placement);
    the moe, dense, ssm and hybrid families each train a `train.run`
    step. A moe batch whose rows the data axes cannot split (one row
    over data 2) exits: its capacity slots are counted from each data
    rank's own rows."""
    from repro_torch.models import lm

    archs = ["qwen3-moe-30b-a3b", "falcon-mamba-7b", "hymba-1.5b",
             "granite-8b", "internvl2-2b", "seamless-m4t-large-v2"]
    out = spawn("tests._torch_mesh:driver_refusals", 2, {
        "archs": archs, "moe_rows": "mixtral-8x22b"},
        timeout_s=RANK_TIMEOUT_S)
    for rank in out:
        for arch in archs[:4]:
            assert rank[arch] is None, (arch, rank[arch])
        for arch in archs[4:]:
            assert "token-LM" in rank[arch], (arch, rank[arch])
        assert "does not split over the data axes" in rank["moe rows"]
    tp = object()                        # any placement: only its presence
    for arch in archs[4:]:
        with pytest.raises(SystemExit, match="enc-dec or vlm"):
            lm.check_mesh(registry.get_smoke(arch), tp)
    for arch in archs[:4]:
        lm.check_mesh(registry.get_smoke(arch), tp)


@pytest.fixture(scope="module")
def checkpoints():
    """A one-device run's checkpoint at step 2, and the (1, 2) mesh's
    run (`driver_checkpoints`) that saves its own and resumes from it."""
    cfg = registry.get_smoke("llama3-8b")
    one = train.run(cfg, steps=2, batch=2, seq=64, ckpt_every=2,
                    device="cpu")
    objects = dict(one["runtime"][0].list_bucket("ckpts"))
    ranks = spawn("tests._torch_mesh:driver_checkpoints", 2,
                  {"restore_objects": objects}, timeout_s=RANK_TIMEOUT_S)
    return one, ranks


def test_sharded_checkpoint_is_the_one_device_checkpoint_of_its_state(
        checkpoints):
    """Rank 0 writes, object for object and byte for byte, what
    `save_checkpoint` writes for the gathered state; it restores on one
    device into that state, bit for bit."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.optim.adamw import TrainState

    _, ranks = checkpoints
    got, whole = ranks[0]["objects"], ranks[0]["whole"]
    state = TrainState(step=whole["step"], params={}, mu={}, nu={})
    for key, leaf in whole.items():
        *parents, name = key.split("/")
        if parents:
            node = getattr(state, parents[0])
            for p in parents[1:]:
                node = node.setdefault(p, {})
            node[name] = leaf
    store = ObjectStore()
    save_checkpoint(store, "ckpts", 2, state)
    want = dict(store.list_bucket("ckpts"))
    assert list(sorted(got)) == list(sorted(want))
    assert all(got[k] == want[k] for k in want)
    step, flat = restore_checkpoint(store, "ckpts")
    assert step == 2 and list(flat) == list(whole)
    assert all(torch.equal(flat[k], whole[k]) for k in whole)


def test_one_device_checkpoint_restores_onto_the_mesh(checkpoints):
    """The mesh run resumes from the one-device run's checkpoint: its
    shards, gathered, are that state bit for bit."""
    one, ranks = checkpoints
    want = dict(_items(one["state"]))
    for rank in ranks:
        assert rank["start_step"] == 2
    got = ranks[0]["restored"]
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


def test_mesh_run_tracks_the_one_device_run(checkpoints):
    """The (1, 2) mesh's two steps against the one-device driver's on the
    same corpus: losses within the bf16 tolerance of
    tests/test_torch_train.py (2e-2), every rank the same loss, each
    rank's state bytes the same, and the step's collectives counted."""
    one, ranks = checkpoints
    for rank in ranks:
        for a, b in zip(rank["records"], one["records"]):
            assert abs(a["loss"] - b["loss"]) <= 2e-2
            assert math.isfinite(a["grad_norm"])
            assert a["collectives"]["calls"]["all_reduce"] > 0
        assert rank["state_bytes"] == ranks[0]["state_bytes"]
    assert [r["loss"] for r in ranks[0]["records"]] == \
        [r["loss"] for r in ranks[1]["records"]]


def test_ranks_never_share_a_card_unasked(monkeypatch):
    """Two local ranks and one card: `rank_device` exits, unless the
    caller shares the card explicitly."""
    from repro_torch import device as D
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(SystemExit, match="2 ranks on this host and 1"):
        D.rank_device("cuda")
    assert D.rank_device("cuda", shared=True) == torch.device("cuda")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert D.rank_device("cuda") == torch.device("cuda", 0)


def test_rank_mesh_coordinates_are_row_major():
    m = mesh_mod.RankMesh(("pod", "data", "model"), (2, 2, 4), rank=13)
    assert m.coords == {"pod": 1, "data": 1, "model": 1}
    assert m.index(("pod", "data")) == 3 and m.index("model") == 1


#: the reduce-scatter cases: (dim, axes) of an integer-valued f32
#: tensor of RS_SHAPE, every dim a multiple of 4
RS_SHAPE = (4, 8, 4)
RS_CASES = [(dim, axes) for dim in (0, 1, 2)
            for axes in (("data",), ("model",), ("data", "model"))]


def _rs_input(rank):
    """Rank ``rank``'s input of a reduce-scatter case: integer values,
    exact in f32 when summed."""
    return torch.arange(float(math.prod(RS_SHAPE))).reshape(RS_SHAPE) * (
        rank + 1)


def collectives_rank():
    """On a (2, 2) gloo mesh: the forward and backward of `gather`,
    `copy_to` and `reduce_from`, `reduce_scatter` along dim 1; for each
    of `RS_CASES` `reduce_scatter` beside an all-reduce and a slice of
    the same input, and `gather`'s input gradient; `backend_note`; and
    one `train.run` step of llama3-8b smoke on the mesh (FSDP over
    data, tensor parallel over model), its records."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import rank_mesh
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.placement import axes_of

    mesh = rank_mesh(("data", "model"), (2, 2), backend="gloo")
    r = float(mesh.rank)
    x = torch.full((2, 3), r, requires_grad=True)
    g = C.gather(x, mesh, "model", 1)                 # (2, 6)
    (g * torch.arange(6.0)).sum().backward()
    out = {"gather": g.detach(), "gather_grad": x.grad.clone()}
    y = torch.full((3,), r, requires_grad=True)
    (C.copy_to(y, mesh, "data") * 2).sum().backward()
    out["copy_grad"] = y.grad.clone()
    z = torch.full((3,), r, requires_grad=True)
    s = C.reduce_from(z, mesh, "data")
    (s * 3).sum().backward()
    out["reduce"], out["reduce_grad"] = s.detach(), z.grad.clone()
    out["scatter"] = C.reduce_scatter(torch.arange(8.0).reshape(2, 4) + r,
                                      mesh, "model", 1)
    out["coords"] = mesh.coords
    for dim, axes in RS_CASES:
        v = _rs_input(mesh.rank)
        part = v.shape[dim] // mesh.axes_size(axes)
        mesh.stats.reset()
        rs = C.reduce_scatter(v, mesh, axes, dim)
        ran = dict(mesh.stats.calls)
        sliced = C.all_reduce(v, mesh, axes).narrow(
            dim, mesh.index(axes) * part, part)
        shard = v.narrow(dim, mesh.index(axes) * part, part).clone()
        shard.requires_grad_(True)
        whole = C.gather(shard, mesh, axes, dim)
        (whole * _rs_input(mesh.rank)).sum().backward()
        out[("rs", dim, axes)] = {"rs": rs, "sliced": sliced, "ran": ran,
                                  "gather_grad": shard.grad.clone()}
    out["note"] = C.backend_note(mesh)
    res = train.run(registry.get_smoke("llama3-8b"), steps=1, batch=2,
                    seq=32, ckpt_every=2, mesh=mesh)
    out["records"] = res["records"]
    out["fsdp"] = any("data" in axes_of(entry) for spec in
                      res["tp"].specs.values() for entry in spec)
    return out


@pytest.fixture(scope="module")
def collectives():
    """Every rank's `collectives_rank`, from one spawn of 4 gloo ranks."""
    return spawn("tests.test_torch_mesh_driver:collectives_rank", 4,
                 timeout_s=RANK_TIMEOUT_S)


def test_collectives_forward_and_backward(collectives):
    for rank, o in enumerate(collectives):
        d, m = o["coords"]["data"], o["coords"]["model"]
        peers = [2 * d, 2 * d + 1]                    # the model group
        want = torch.cat([torch.full((2, 3), float(p)) for p in peers], 1)
        assert torch.equal(o["gather"], want)
        # every model rank's loss reads this rank's columns: summed
        cols = torch.arange(6.0).reshape(1, 6)[:, 3 * m:3 * m + 3]
        assert torch.equal(o["gather_grad"], 2 * cols.expand(2, 3))
        assert torch.equal(o["copy_grad"], torch.full((3,), 4.0))
        ranks_d = [m, 2 + m]                          # the data group
        assert torch.equal(o["reduce"], torch.full((3,), float(sum(ranks_d))))
        assert torch.equal(o["reduce_grad"], torch.full((3,), 3.0))
        total = 2 * (torch.arange(8.0).reshape(2, 4)) + sum(peers)
        assert torch.equal(o["scatter"], total[:, 2 * m:2 * m + 2])


def _group(coords, axes):
    """The ranks of a (2, 2) mesh that share ``coords`` off ``axes``, and
    this rank's place among them."""
    members = [2 * d + m for d in range(2) for m in range(2)
               if ("data" in axes or d == coords["data"])
               and ("model" in axes or m == coords["model"])]
    return members, members.index(2 * coords["data"] + coords["model"])


@pytest.mark.parametrize("case", [("rs", d, a) for d, a in RS_CASES]
                         + ["llama-step", "backend-note"],
                         ids=[f"rs-dim{d}-{'+'.join(a)}" for d, a in RS_CASES]
                         + ["llama-step", "backend-note"])
def test_reduce_scatter_on_gloo(collectives, case):
    """`reduce_scatter` runs ``reduce_scatter_tensor`` under gloo, as
    under NCCL: along dims 0-2 over ``data``, ``model`` and both, each
    rank's part equals, exactly, an all-reduce and a slice of the same
    integer-valued input, and the sum the group's inputs make; `gather`'s
    input gradient is that reduce-scatter of the output's (every rank's
    output gradient is its own input). A (2, 2) step of llama3-8b smoke
    (FSDP over data, tensor parallel over model) counts reduce-scatters
    among its collectives; `backend_note` names no all-reduce and
    slice."""
    if case == "llama-step":
        for o in collectives:
            assert o["fsdp"]
            (rec,) = o["records"]
            assert rec["collectives"]["calls"].get("reduce_scatter", 0) > 0
            assert math.isfinite(rec["loss"])
        return
    if case == "backend-note":
        for o in collectives:
            assert o["note"] == "gloo"
            assert "slice" not in o["note"]
        return
    _, dim, axes = case
    for o in collectives:
        got = o[case]
        members, i = _group(o["coords"], axes)
        part = RS_SHAPE[dim] // len(members)
        total = _rs_input(0) * sum(q + 1 for q in members)
        want = total.narrow(dim, i * part, part)
        assert got["ran"] == {"reduce_scatter": 1}
        assert torch.equal(got["rs"], got["sliced"])
        assert torch.equal(got["rs"], want)
        assert torch.equal(got["gather_grad"], want)


def test_torch_distributed_run_trains_on_two_cpu_ranks():
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train --mesh debug --device cpu``: two ranks over
    gloo, rank 0 printing the mesh, each rank's state bytes and 2 steps."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "llama3-8b", "--smoke", "--mesh", "debug", "--device",
         "cpu", "--steps", "2", "--batch", "2", "--seq", "32"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "mesh 1x2" in proc.stdout and "state bytes by rank" in proc.stdout
    steps = [line for line in proc.stdout.splitlines()
             if line.startswith("step ")]
    assert len(steps) == 2, proc.stdout
    assert all(np.isfinite(float(s.split("loss=")[1].split()[0]))
               for s in steps)

