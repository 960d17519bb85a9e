"""Shared by tests/test_torch_mesh_*.py: the reference's jitted train step
on CPU meshes, and the port's sharded step on gloo CPU ranks.

The reference runs on several CPU devices only with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` set before jax is
imported, so `reference_steps` runs it in a subprocess of its own
(`_reference_main`), as ``repro/launch/train.py`` does: ``jax.jit`` of
``make_train_step`` with the state's and the batch's shardings as in and
out shardings, the state and batch ``device_put`` on the mesh, inside
``jax.set_mesh``, with GSPMD's Auto axes (the reference's rules and
``shard_hint`` are written for them; ``jax.make_mesh``'s default axes
are Explicit since jax 0.7, and under them the reference's embedding
gather raises ``DuplicateSpecError``: ROADMAP Queue 3 item 6). It
writes the initial params, the batch, and for each mesh the loss, grad
norm, post-step params and first moments, and each state leaf's
``NamedSharding.shard_shape``.

The port's side (`port_rank`) runs on ranks spawned by
``repro_torch.launch.ranks.spawn``, each a process of its own, from the
same params (``models.convert``) and batch: the placement
(``launch.sharding.placement``), ``state_to_mesh``, this rank's
``batch_spec`` slice, one ``make_train_step(model, tp=...)`` step,
``state_from_mesh``.

Everything runs in f32 (the smoke configs with ``dtype`` and
``param_dtype`` replaced), B 2 x S 64: B splits over ``data`` 2.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

B, S = 2, 64
#: the meshes, (data, model), each held to the reference's
MESHES = ((1, 2), (1, 4), (2, 2))
SEED, BATCH_SEED = 0, 8
#: the tolerances of tests/test_torch_train.py's f32 cases: the loss and
#: grad norm at rtol 1e-5, each first-moment leaf (0.1 x the clipped
#: gradient) within 1e-4 of its largest |value|. Each params leaf's
#: update (params - init) within UPDATE_TOL of the reference's update in
#: norm: a first Adam step is lr sign(g), which flips elementwise where
#: g ~ 0 (up to 0.12 of the largest update in one element), but the
#: worst leaf over every case here reads 4.0e-3 in norm (qwen2-72b's
#: ``bk``), and a skipped update reads 1
LOSS_RTOL, LEAF_TOL, UPDATE_TOL = 1e-5, 1e-4, 2e-2
REF_TIMEOUT_S, RANK_TIMEOUT_S = 240, 150
ROOT = Path(__file__).resolve().parents[1]


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def batch_np(vocab: int) -> dict:
    rng = np.random.default_rng(BATCH_SEED)
    toks = rng.integers(0, vocab, (B, S + 1), dtype=np.int32)
    return {"tokens": np.ascontiguousarray(toks[:, :-1]),
            "targets": np.ascontiguousarray(toks[:, 1:])}


def _flat(tree, prefix=""):
    """{path: leaf} in sorted-key order (jax's flatten order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ------------------------------------------------------------ the reference

def _reference_main(cases, out) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import registry
    from repro.launch import sharding as SH
    from repro.models import get_model
    from repro.optim import adamw_init, make_train_step

    result = {}
    for case, arch, overrides, meshes in cases:
        cfg = _f32(registry.get_smoke(arch)).replace(**(overrides or {}))
        model = get_model(cfg)
        params = model.init_params(jax.random.PRNGKey(SEED))
        batch = batch_np(cfg.vocab_size)
        rec = {"params": _flat(jax.tree.map(np.asarray, params)),
               "batch": batch, "meshes": {}}
        for shape in meshes:
            n = shape[0] * shape[1]
            mesh = jax.make_mesh(shape, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2,
                                 devices=jax.devices()[:n])
            state = adamw_init(params)
            sshard = SH.state_shardings(jax.eval_shape(lambda: state), mesh)
            bshapes = {k: jax.ShapeDtypeStruct(v.shape, jnp.int32)
                       for k, v in batch.items()}
            bshard = SH.batch_shardings(bshapes, mesh)
            step = jax.jit(make_train_step(model),
                           in_shardings=(sshard, bshard),
                           out_shardings=(sshard, None))
            with jax.set_mesh(mesh):
                st = jax.device_put(state, sshard)
                bt = jax.device_put({k: jnp.asarray(v)
                                     for k, v in batch.items()}, bshard)
                new, metrics = step(st, bt)
            shapes = {}
            for name in ("params", "mu", "nu"):
                sub_s = getattr(sshard, name)
                sub_v = getattr(new, name)
                leaves = jax.tree_util.tree_leaves_with_path(sub_v)
                shards = jax.tree.leaves(sub_s)
                for (path, leaf), sh in zip(leaves, shards):
                    key = "/".join(str(getattr(k, "key", k)) for k in path)
                    shapes[f"{name}/{key}"] = tuple(sh.shard_shape(
                        leaf.shape))
            rec["meshes"][shape] = {
                "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "aux_loss": float(metrics["aux_loss"]),
                "params": _flat(jax.tree.map(np.asarray, new.params)),
                "mu": _flat(jax.tree.map(np.asarray, new.mu)),
                "shard_shapes": shapes}
        result[case] = rec
    with open(out, "wb") as f:
        pickle.dump(result, f)


def reference_steps(cases, tmp: Path) -> dict:
    """The reference's sharded step for each of ``cases`` ((key, arch,
    overrides, meshes): the arch's smoke config with ``overrides`` on
    every mesh of ``meshes``), all in one subprocess with 4 host
    devices: {key: record}."""
    out = tmp / "reference.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH", "")])
    code = (f"from tests._torch_mesh import _reference_main; "
            f"_reference_main({list(cases)!r}, {str(out)!r})")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True,
                          timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


# ----------------------------------------------------------------- the port

def _unflat(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


def port_rank(arch, params, batch, meshes, overrides=None, plain=False):
    """On each mesh of ``meshes`` (all of this world's size), one sharded
    step of ``arch`` (smoke, f32, with ``overrides``; through the kernels'
    plain versions with ``plain``) from ``params`` (flat numpy) on
    ``batch``: the loss, grad norm, this rank's shard shapes and state
    bytes, the model-axis gathers, and on rank 0 the whole post-step
    params and first moments."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import rank_mesh
    from repro_torch.models import get_model
    from repro_torch.models.registry import param_structs
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw_init, make_train_step
    from repro_torch.parallel import placement as P

    model = get_model(_f32(registry.get_smoke(arch)).replace(
        **(overrides or {})), device="cpu")
    out = {}
    for shape in meshes:
        mesh = rank_mesh(("data", "model"), shape, backend="gloo")
        step = make_train_step(model, plain=plain, tp=SH.placement(
            mesh, param_structs(model.cfg)))
        state = P.state_to_mesh(adamw_init(params_from_numpy(
            _unflat(params))), step.tp)
        tensors = {k: P.local_shard(torch.from_numpy(v), SH.batch_spec(
            k, v.shape, mesh), mesh) for k, v in batch.items()}
        state, metrics = step(state, tensors)
        rec = {"loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "aux_loss": float(metrics["aux_loss"]),
               "shard_shapes": {p: tuple(t.shape) for p, t in
                                P.leaves_with_paths(state)},
               "state_bytes": P.state_bytes(state),
               "gathers": dict(step.tp.gathers)}
        rec["shard_shapes"] = {"/".join(map(str, p)): s for p, s in
                               rec["shard_shapes"].items()}
        full = P.state_from_mesh(state, step.tp)
        if mesh.rank == 0:
            rec["params"] = {k: v.numpy() for k, v in _flat(
                full.params).items()}
            rec["mu"] = {k: v.numpy() for k, v in _flat(full.mu).items()}
        out[shape] = rec
    return out


# ---------------------------------------------------------------- the cases

def port_one_device(arch, params, batch, overrides=None, plain=False):
    """The port's own one-device step from the same params and batch
    (``overrides`` and ``plain`` as `port_rank`'s)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw_init, make_train_step

    model = get_model(_f32(registry.get_smoke(arch)).replace(
        **(overrides or {})), device="cpu")
    state, metrics = make_train_step(model, plain=plain)(
        adamw_init(params_from_numpy(_unflat(params))),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "aux_loss": float(metrics["aux_loss"]),
            "params": {k: v.numpy() for k, v in _flat(state.params).items()},
            "mu": {k: v.numpy() for k, v in _flat(state.mu).items()}}


def port_ranks(jobs):
    """`port_rank` for each of ``jobs`` (its keyword arguments) in turn,
    on one spawn's ranks."""
    return [port_rank(**job) for job in jobs]


def mesh_cases(arch, tmp: Path, cases: dict, plain=False) -> dict:
    """``arch``'s smoke under each of ``cases`` ({key: (overrides,
    meshes)}): the reference's step on every mesh of each (one
    subprocess for all), the port's on the ranks of each world size
    among them (one spawn a world size for all; ``plain`` as
    `port_rank`'s), and the port's one-device step of each, all from the
    reference's params and batch of that case: {key: (ref, port, one)}."""
    from repro_torch.launch.ranks import spawn

    refs = reference_steps([(key, arch, overrides, tuple(meshes))
                            for key, (overrides, meshes) in cases.items()],
                           tmp)
    port = {key: {} for key in cases}
    for world in sorted({m[0] * m[1] for _, meshes in cases.values()
                         for m in meshes}):
        jobs = [(key, {"arch": arch, "params": refs[key]["params"],
                       "batch": refs[key]["batch"], "overrides": overrides,
                       "plain": plain, "meshes": [
                           m for m in meshes if m[0] * m[1] == world]})
                for key, (overrides, meshes) in cases.items()
                if any(m[0] * m[1] == world for m in meshes)]
        res = spawn("tests._torch_mesh:port_ranks", world,
                    {"jobs": [job for _, job in jobs]},
                    timeout_s=RANK_TIMEOUT_S * len(jobs))
        for i, (key, job) in enumerate(jobs):
            for shape in job["meshes"]:
                port[key][shape] = [r[i][shape] for r in res]
    return {key: (refs[key], port[key], port_one_device(
        arch, refs[key]["params"], refs[key]["batch"], overrides, plain))
        for key, (overrides, _) in cases.items()}


def mesh_runs(arch, tmp: Path, overrides=None, meshes=MESHES,
              plain=False):
    """`mesh_cases` of one case: ``arch``'s smoke with ``overrides`` on
    ``meshes``, (ref, port, one)."""
    return mesh_cases(arch, tmp, {"": (overrides, meshes)}, plain)[""]


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """The module's ``ARCH``: `mesh_runs` on every mesh of `MESHES` (the
    port on 2 ranks for (1, 2) and on 4 for (1, 4) and (2, 2))."""
    return mesh_runs(request.module.ARCH, tmp_path_factory.mktemp("ref"))


def _close_leaves(got: dict, want: dict, what: str, init=None) -> None:
    assert list(got) == list(want), what
    for key, b in want.items():
        a = got[key]
        assert a.shape == b.shape, (what, key)
        if what == "params":
            # the step's update against the reference's update, leaf by
            # leaf: (a - init) - (b - init) is a - b
            upd = float(np.linalg.norm(b.astype(np.float64) - init[key]))
            assert upd > 0, (what, key, "the reference's step left it")
            err = float(np.linalg.norm(a.astype(np.float64) - b)) / upd
            assert err <= UPDATE_TOL, (what, key, err)
        else:
            err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                   1e-30)
            assert err <= LEAF_TOL, (what, key, err)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
class MeshCases:
    """One step of the module's ``ARCH`` (smoke, f32) on each mesh of
    `MESHES`: the port on gloo CPU ranks against the reference's jitted
    step under the same state and batch shardings, and against the
    port's one-device step."""

    ARCH: str

    def test_loss_and_grad_norm_match_reference(self, runs, shape):
        ref, port, _ = runs
        want = ref["meshes"][shape]
        for rank in port[shape]:
            np.testing.assert_allclose(
                [rank["loss"], rank["grad_norm"]],
                [want["loss"], want["grad_norm"]], rtol=LOSS_RTOL)

    def test_params_and_moments_match_reference(self, runs, shape):
        ref, port, _ = runs
        got = port[shape][0]
        for what in ("params", "mu"):
            _close_leaves(got[what], ref["meshes"][shape][what], what,
                          ref["params"])

    def test_shard_shapes_match_reference(self, runs, shape):
        ref, port, _ = runs
        want = ref["meshes"][shape]["shard_shapes"]
        for rank in port[shape]:
            got = {k: v for k, v in rank["shard_shapes"].items()
                   if k != "step"}
            assert got == want
            assert rank["shard_shapes"]["step"] == ()

    def test_state_bytes_match_dry_run(self, runs, shape):
        from repro_torch.configs import InputShape, registry
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import Mesh

        _, port, _ = runs
        cfg = _f32(registry.get_smoke(self.ARCH))
        extra = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}
        cell = dryrun.build_cell(self.ARCH, InputShape("train", S, B,
                                                       "train"),
                                 extra=extra,
                                 mesh=Mesh(("data", "model"), shape))
        want = cell.argument_bytes()["state"]
        assert [r["state_bytes"] for r in port[shape]] == \
            [want] * len(port[shape])

    def test_matches_the_one_device_step(self, runs, shape):
        _, port, one = runs
        got = port[shape][0]
        np.testing.assert_allclose([got["loss"], got["grad_norm"]],
                                   [one["loss"], one["grad_norm"]],
                                   rtol=LOSS_RTOL)
        for what in ("params", "mu"):
            _close_leaves(got[what], one[what], what, runs[0]["params"])

    def test_head_split_gathers_are_counted(self, runs, shape):
        """Every rank counts the model-axis gathers its family's layers
        make (`want_gathers`), in each layer's forward and its remat
        recompute."""
        from repro_torch.configs import registry

        _, port, _ = runs
        want = self.want_gathers(registry.get_smoke(self.ARCH), shape)
        assert [r["gathers"] for r in port[shape]] == [want] * len(
            port[shape])

    @staticmethod
    def want_gathers(cfg, shape) -> dict:
        """The dense family: at ``model`` 4 the smoke's K 2 x hd 32 = 64
        k/v columns are 16 a rank, half a head: every rank gathers wk and
        wv (and the QKV biases) over ``model``, in each layer's forward
        and its remat recompute; at ``model`` 2 each rank holds one whole
        kv head."""
        names = ("wk", "wv") + (("bk", "bv") if cfg.attn_bias else ())
        return ({} if shape[1] == 2 else
                {f"layers/attn/{n}": 2 * cfg.num_layers for n in names})


class MoeMeshCases(MeshCases):
    """`MeshCases` for the moe family, and its load-balancing loss on its
    own: at ``router_aux_loss`` 0.001 it is ~1e-4 of the loss, which the
    loss check cannot see."""

    def test_aux_loss_matches_reference(self, runs, shape):
        ref, port, one = runs
        want = ref["meshes"][shape]["aux_loss"]
        assert want > 0
        np.testing.assert_allclose([r["aux_loss"] for r in port[shape]],
                                   [want] * len(port[shape]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(one["aux_loss"], want, rtol=LOSS_RTOL)


def assert_step_matches(want: dict, ranks: list, init: dict) -> None:
    """Every rank's loss, grad norm and load-balancing loss against
    ``want``'s (the reference's step on a mesh, or the port's one-device
    step) at rtol 1e-5, and rank 0's whole params and first moments
    (`_close_leaves`)."""
    for r in ranks:
        np.testing.assert_allclose(
            [r["loss"], r["grad_norm"], r["aux_loss"]],
            [want["loss"], want["grad_norm"], want["aux_loss"]],
            rtol=LOSS_RTOL)
    for what in ("params", "mu"):
        _close_leaves(ranks[0][what], want[what], what, init)


# ------------------------------------------------------ the driver's ranks

def driver_refusals(archs, moe_rows=None):
    """`train.run` of each smoke config on a (1, world) mesh over gloo on
    the CPU: the SystemExit message each raises (None if it trains).
    With ``moe_rows`` (an arch of the moe family), also its message on a
    (world, 1) mesh at a batch of one row, which the data axes cannot
    split (under ``"moe rows"``)."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.launch.mesh import rank_mesh

    def refusal(arch, batch, mesh):
        try:
            train.run(registry.get_smoke(arch), steps=1, batch=batch,
                      seq=16, device="cpu", mesh=mesh, backend="gloo")
        except SystemExit as e:
            return str(e)
        return None

    out = {arch: refusal(arch, 2, "debug") for arch in archs}
    if moe_rows is not None:
        out["moe rows"] = refusal(moe_rows, 1, rank_mesh(
            ("data", "model"), (dist.get_world_size(), 1), backend="gloo"))
    return out


def driver_checkpoints(restore_objects):
    """llama3-8b smoke on a (1, world) gloo mesh: 2 steps with a
    checkpoint at step 2 (every object rank 0's store holds, and the
    whole state gathered), then a run that resumes from the one-device
    checkpoint ``restore_objects`` (its shards gathered whole again),
    and each step's records."""
    from repro_torch.configs import registry
    from repro_torch.checkpoint.ckpt import _items
    from repro_torch.launch import train
    from repro_torch.parallel.placement import state_from_mesh

    cfg = registry.get_smoke("llama3-8b")
    res = train.run(cfg, steps=2, batch=2, seq=64, ckpt_every=2,
                    device="cpu", mesh="debug", backend="gloo")
    store = res["runtime"][0]
    whole = state_from_mesh(res["state"], res["tp"])
    out = {"records": res["records"], "state_bytes": res["state_bytes"]}
    if res["mesh"].rank == 0:
        out["objects"] = dict(store.list_bucket("ckpts"))
        out["whole"] = dict(_items(whole))
    runtime = train.build_runtime()
    for key, raw in restore_objects.items():
        runtime[0].put("ckpts", key, raw)
    back = train.run(cfg, steps=0, batch=2, seq=64, resume=True,
                     device="cpu", mesh="debug", backend="gloo",
                     runtime=runtime)
    restored = state_from_mesh(back["state"], back["tp"])
    out["start_step"] = back["start_step"]
    if res["mesh"].rank == 0:
        out["restored"] = dict(_items(restored))
    return out


def one_step(arch, overrides, shape=None, plain=False):
    """One f32 step of ``arch``'s smoke config with ``overrides``, seeded
    params and `batch_np`'s batch, through the kernels' plain versions
    with ``plain``: on a (data, model) ``shape`` mesh of this world's
    ranks (rank 0 returns the params gathered whole, every rank its
    model-axis gathers), or on one device without ``shape``."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import rank_mesh
    from repro_torch.models import get_model
    from repro_torch.models.registry import param_structs
    from repro_torch.optim import adamw_init, make_train_step
    from repro_torch.parallel import placement as P

    cfg = _f32(registry.get_smoke(arch)).replace(**overrides)
    model = get_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(SEED))
    batch = {k: torch.from_numpy(v) for k, v in batch_np(
        cfg.vocab_size).items()}
    mesh = (rank_mesh(("data", "model"), shape, backend="gloo")
            if shape else None)
    step = make_train_step(model, plain=plain, tp=SH.placement(
        mesh, param_structs(cfg)) if mesh is not None else None)
    init = {k: v.numpy().copy() for k, v in _flat(params).items()}
    state = adamw_init(params)
    if mesh is not None:
        state = P.state_to_mesh(state, step.tp)
        batch = {k: P.local_shard(v, SH.batch_spec(k, v.shape, mesh), mesh)
                 for k, v in batch.items()}
    state, metrics = step(state, batch)
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "aux_loss": float(metrics["aux_loss"]),
           "gathers": dict(step.tp.gathers) if mesh is not None else {},
           "init": init}
    if mesh is not None:
        state = P.state_from_mesh(state, step.tp)
    out["params"] = {k: v.numpy() for k, v in _flat(state.params).items()}
    out["mu"] = {k: v.numpy() for k, v in _flat(state.mu).items()}
    return out


# ------------------------------------------------------ the serving steps
#
# The reference's jitted prefill and decode step under the dry run's in
# and out shardings (repro/launch/dryrun.py: params and batch by the
# param and batch rules, the prefill cache by ``cache_shardings(kind=
# "prefill")``, the decode cache by ``kind="decode"``, the logits by
# ``logits_sharding``), and the port's ``prefill`` / ``decode_step`` on
# gloo ranks with a serving placement, from the same params and tokens.

#: decode steps after the prefill: the first writes slot S % S = 0 and
#: evicts position 0
SERVE_STEPS = 3
SERVE_SEED = 9


def serve_inputs(cfg, batch=B, lengths=(S, S)) -> dict:
    """The prefill batch and the decode steps' tokens (steps, batch, 1,
    under ``"decode"``), drawn from the seed: a prompt of (batch, S)
    tokens; for the vlm family (batch, S, D) f32 ``inputs_embeds``; for
    an encoder-decoder ``src_embeds`` (batch, Ss, D) and ``tgt_tokens``
    (batch, St), ``lengths`` (St, Ss)."""
    rng = np.random.default_rng(SERVE_SEED)
    St, Ss = lengths
    if cfg.is_encoder_decoder:
        out = {"src_embeds": rng.standard_normal(
                   (batch, Ss, cfg.d_model)).astype(np.float32),
               "tgt_tokens": rng.integers(0, cfg.vocab_size, (batch, St),
                                          dtype=np.int32)}
    elif cfg.embed_input:
        out = {"inputs_embeds": rng.standard_normal(
            (batch, St, cfg.d_model)).astype(np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, St),
                                      dtype=np.int32)}
    out["decode"] = rng.integers(0, cfg.vocab_size, (SERVE_STEPS, batch, 1),
                                 dtype=np.int32)
    return out


def prefill_batch(inputs: dict) -> dict:
    """The prefill's batch of `serve_inputs`: every leaf but the decode
    steps' tokens."""
    return {k: v for k, v in inputs.items() if k != "decode"}


def _with_biases(cfg, params: dict) -> dict:
    """``params`` (flat numpy) with the QKV biases drawn nonzero where the
    config has them (the init leaves them 0)."""
    if not cfg.attn_bias:
        return params
    rng = np.random.default_rng(SERVE_SEED + 1)
    out = dict(params)
    for name in ("bq", "bk", "bv"):
        key = f"layers/attn/{name}"
        out[key] = rng.normal(0.0, 0.5, params[key].shape).astype(np.float32)
    return out


def _reference_serve_main(cases, out) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import registry
    from repro.launch import sharding as SH
    from repro.models import get_model

    def shard_shapes(shardings, values):
        return {k: tuple(shardings[k].shard_shape(v.shape))
                for k, v in values.items()}

    def host(cache):
        """The cache as numpy, a bf16 leaf (the ssm families' conv) in f32,
        which holds it exactly."""
        return {k: np.asarray(v, dtype=np.float32 if v.dtype == jnp.bfloat16
                              else v.dtype) for k, v in cache.items()}

    result = {}
    for case, arch, overrides, meshes, rows, lengths in cases:
        cfg = _f32(registry.get_smoke(arch)).replace(**(overrides or {}))
        model = get_model(cfg)
        flat = _with_biases(cfg, _flat(jax.tree.map(
            np.asarray, model.init_params(jax.random.PRNGKey(SEED)))))
        params = jax.tree.map(jnp.asarray, _unflat(flat))
        inputs = serve_inputs(cfg, rows, lengths)
        batch = {k: jnp.asarray(v) for k, v in prefill_batch(inputs).items()}
        _, cache1 = jax.jit(model.prefill)(params, batch)
        rec = {"params": flat, "inputs": inputs,
               "prefill_cache": host(cache1),
               "meshes": {}}
        pshapes = jax.eval_shape(lambda: params)
        for shape in meshes:
            n = shape[0] * shape[1]
            mesh = jax.make_mesh(shape, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2,
                                 devices=jax.devices()[:n])
            pshard = SH.param_shardings(pshapes, mesh)
            bshard = SH.batch_shardings(jax.eval_shape(lambda: batch), mesh)
            lshape, cshapes = jax.eval_shape(model.prefill, pshapes, batch)
            lshard = SH.logits_sharding(mesh, lshape.shape)
            cpre = SH.cache_shardings(cshapes, mesh, kind="prefill")
            cdec = SH.cache_shardings(cshapes, mesh)
            token = jax.ShapeDtypeStruct((rows, 1), jnp.int32)
            tshard = SH.batch_shardings({"t": token}, mesh)["t"]
            prefill = jax.jit(lambda p, b: model.prefill(p, b),
                              in_shardings=(pshard, bshard),
                              out_shardings=(lshard, cpre))
            step = jax.jit(lambda p, c, t: model.decode_step(p, c, t),
                           in_shardings=(pshard, cdec, tshard),
                           out_shardings=(lshard, cdec))
            with jax.set_mesh(mesh):
                p = jax.device_put(params, pshard)
                logits, cache = prefill(p, jax.device_put(batch, bshard))
                c = jax.device_put(cache1, cdec)
                steps = []
                for t in inputs["decode"]:
                    lg, c = step(p, c, jax.device_put(jnp.asarray(t),
                                                      tshard))
                    steps.append(np.asarray(lg))
            rec["meshes"][shape] = {
                "prefill": {"logits": np.asarray(logits),
                            "cache": host(cache)},
                "prefill_shapes": {
                    "logits": tuple(lshard.shard_shape(logits.shape)),
                    **shard_shapes(cpre, cache)},
                "decode": {"logits": steps,
                           "cache": host(c)},
                "decode_shapes": {
                    "logits": tuple(lshard.shard_shape(lg.shape)),
                    **shard_shapes(cdec, c)}}
        result[case] = rec
    with open(out, "wb") as f:
        pickle.dump(result, f)


def reference_serves(cases, tmp: Path) -> dict:
    """The reference's sharded prefill and decode steps for each of
    ``cases`` ((key, arch, overrides, meshes, batch, (St, Ss))), all in one
    subprocess
    with 4 host devices: {key: record}, with each mesh's logits, caches
    and shard shapes, and the one-device prefill's cache that the decode
    steps start from."""
    out = tmp / "reference_serve.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH", "")])
    code = (f"from tests._torch_mesh import _reference_serve_main; "
            f"_reference_serve_main({list(cases)!r}, {str(out)!r})")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True,
                          timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def port_serve_rank(arch, overrides, ref, meshes, batch=B, lengths=(S, S)):
    """On each mesh of ``meshes`` (all of this world's size) the port's
    sharded prefill and ``SERVE_STEPS`` decode steps of ``arch`` (smoke,
    f32, with ``overrides``, a batch of ``batch``, the prefill's
    ``lengths`` (St, Ss)) from the reference's params and inputs
    (``ref``, a `reference_serves` record): each as
    (this rank's result, its shard of the reference's) pairs of numpy
    arrays, the results' shard shapes, the decode steps' collectives by
    kind and the model-axis gathers of the prefill and of the decode
    steps by path, and whether `kv_cache.to_decode_layout` of the port's
    own prefill cache equals that cache placed by the decode rules."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import rank_mesh
    from repro_torch.models import get_model
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.registry import param_structs
    from repro_torch.parallel import placement as P

    cfg = _f32(registry.get_smoke(arch)).replace(**(overrides or {}))
    model = get_model(cfg, device="cpu")
    params = params_from_numpy(_unflat(ref["params"]))
    inputs = ref["inputs"]
    out = {}
    for shape in meshes:
        mesh = rank_mesh(("data", "model"), shape, backend="gloo")
        tp = SH.serve_placement(mesh, param_structs(cfg), kvc.init_cache(
            cfg, batch, lengths[0], dtype=torch.float32, device="meta",
            src_len=lengths[1]))
        local = P.params_to_mesh(params, tp)
        want = ref["meshes"][shape]

        def rows(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            return P.local_shard(t, SH.batch_spec("t", tuple(t.shape), mesh),
                                 mesh)

        def pairs(got, whole, kind):
            return {k: (v.float().numpy() if v.dtype == torch.bfloat16
                        else v.numpy(), P.local_shard(
                torch.from_numpy(whole[k]), tp.specs[f"cache/{kind}/{k}"],
                mesh).numpy()) for k, v in got.items()}

        def logits_pair(got, whole):
            return (got.numpy(), P.local_shard(torch.from_numpy(whole),
                                               tp.specs["logits"],
                                               mesh).numpy())

        mesh.stats.reset()
        logits, cache = model.prefill(local, {
            k: rows(v) for k, v in prefill_batch(inputs).items()}, tp=tp)
        rec = {"prefill_collectives": mesh.stats.summary(),
               "prefill_gathers": dict(tp.gathers),
               "prefill": {"logits": logits_pair(
                   logits, want["prefill"]["logits"]),
                   "cache": pairs(cache, want["prefill"]["cache"],
                                  "prefill")},
               "prefill_shapes": {"logits": tuple(logits.shape),
                                  **{k: tuple(v.shape)
                                     for k, v in cache.items()}}}
        moved = kvc.to_decode_layout(cache, tp)
        placed = P.cache_to_mesh(P.cache_from_mesh(cache, tp, "prefill"), tp,
                                 "decode")
        rec["layout_equal"] = list(moved) == list(placed) and all(
            moved[k].shape == placed[k].shape and torch.equal(moved[k],
                                                              placed[k])
            for k in moved)
        c = P.cache_to_mesh({k: torch.from_numpy(v).to(cache[k].dtype)
                             for k, v in ref["prefill_cache"].items()}, tp,
                            "decode")
        steps, colls = [], []
        tp.gathers.clear()
        for t, whole in zip(inputs["decode"], want["decode"]["logits"]):
            mesh.stats.reset()
            lg, c = model.decode_step(local, c, rows(t), tp=tp)
            colls.append(mesh.stats.summary())
            steps.append(logits_pair(lg, whole))
        rec["decode"] = {"logits": steps,
                         "cache": pairs(c, want["decode"]["cache"],
                                        "decode")}
        rec["decode_collectives"] = colls
        rec["decode_gathers"] = dict(tp.gathers)
        rec["decode_shapes"] = {"logits": tuple(lg.shape),
                                **{k: tuple(v.shape) for k, v in c.items()}}
        rec["bytes"] = {"params": P.state_bytes(local),
                        "cache": P.state_bytes(c)}
        out[shape] = rec
    return out


def port_serve_ranks(jobs):
    """`port_serve_rank` for each of ``jobs`` in turn, on one spawn's
    ranks."""
    return [port_serve_rank(**job) for job in jobs]


def serve_batch(case: tuple) -> int:
    """A case's batch: its fourth entry where it has one, else B."""
    return case[3] if len(case) > 3 else B


def serve_lengths(case: tuple) -> tuple[int, int]:
    """A case's prefill lengths (St, Ss): its fifth entry where it has
    one, else (S, S); Ss is an encoder-decoder's source."""
    return tuple(case[4]) if len(case) > 4 else (S, S)


def serve_cases(cases: dict, tmp: Path) -> dict:
    """The reference's serving steps for each of ``cases`` ({key: (arch,
    overrides, meshes[, batch[, (St, Ss)]])}, batch B and lengths (S, S)
    where they are left out; one subprocess for all) and the port's on
    the ranks of each world size among them (one spawn a world size):
    {key: (ref, {shape: [rank results]})}."""
    from repro_torch.launch.ranks import spawn

    refs = reference_serves([(key, case[0], case[1], tuple(case[2]),
                              serve_batch(case), serve_lengths(case))
                             for key, case in cases.items()], tmp)
    port = {key: {} for key in cases}
    for world in sorted({m[0] * m[1] for case in cases.values()
                         for m in case[2]}):
        jobs = [(key, {"arch": case[0], "overrides": case[1],
                       "ref": refs[key], "batch": serve_batch(case),
                       "lengths": serve_lengths(case),
                       "meshes": [m for m in case[2]
                                  if m[0] * m[1] == world]})
                for key, case in cases.items()
                if any(m[0] * m[1] == world for m in case[2])]
        res = spawn("tests._torch_mesh:port_serve_ranks", world,
                    {"jobs": [job for _, job in jobs]},
                    timeout_s=RANK_TIMEOUT_S * len(jobs))
        for i, (key, job) in enumerate(jobs):
            for shape in job["meshes"]:
                port[key][shape] = [r[i][shape] for r in res]
    return {key: (refs[key], port[key]) for key in cases}


def serve_one_device_pairs(arch, shape, seq):
    """The port's sharded prefill and ``SERVE_STEPS`` decode steps of
    ``arch`` (smoke, f32, seeded params) on a (data, model) ``shape``
    mesh at a prompt of ``seq`` against its one-device steps: (this
    rank's logits, its shard of the one-device logits) for the prefill
    and each step, and the prefill cache's specs."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import rank_mesh
    from repro_torch.models import get_model
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.registry import param_structs
    from repro_torch.parallel import placement as P

    cfg = _f32(registry.get_smoke(arch))
    model = get_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SERVE_SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, seq),
                                         dtype=np.int32))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (SERVE_STEPS, B, 1),
                                          dtype=np.int32))
    logits, cache = model.prefill(params, {"tokens": toks})
    want = [logits]
    for t in steps:
        logits, cache = model.decode_step(params, cache, t)
        want.append(logits)
    mesh = rank_mesh(("data", "model"), shape, backend="gloo")
    tp = SH.serve_placement(mesh, param_structs(cfg), kvc.init_cache(
        cfg, B, seq, dtype=torch.float32, device="meta"))
    local = P.params_to_mesh(params, tp)

    def rows(t):
        return P.local_shard(t, SH.batch_spec("t", tuple(t.shape), mesh),
                             mesh)

    logits, cache = model.prefill(local, {"tokens": rows(toks)}, tp=tp)
    got = [logits]
    cache = kvc.to_decode_layout(cache, tp)
    for t in steps:
        logits, cache = model.decode_step(local, cache, rows(t), tp=tp)
        got.append(logits)
    return {"pairs": [(g.numpy(), P.local_shard(w, tp.specs["logits"],
                                                 mesh).numpy())
                      for g, w in zip(got, want)],
            "prefill_spec": tp.specs.get("cache/prefill/k")}


def serve_rows(case: tuple, shape) -> int:
    """A data rank's rows of a case's batch on a (data, model) ``shape``:
    the batch split over ``data`` where it divides, else the whole batch
    (replicated)."""
    batch = serve_batch(case)
    return batch // shape[0] if batch % shape[0] == 0 else batch


def embed_sums(cfg, shape) -> int:
    """The sums over ``model`` a token embedding takes on a (data, model)
    ``shape``: one where the embedding's vocab is split over ``model``,
    none where the guard leaves it whole (each rank looks its tokens up
    in its own copy)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import Mesh

    spec = SH.param_spec("embed", (cfg.vocab_size, cfg.d_model),
                         Mesh(("data", "model"), shape))
    return int(spec[0] == "model")


class ServeCases:
    """Serving steps on a mesh: each (key, shape) of the module's
    ``CASES`` ({key: (arch, overrides, meshes[, batch[, (St, Ss)]])}; the
    module's ``serves`` fixture, their `serve_cases`), the port's sharded
    prefill and decode steps against the reference's jitted steps under
    the dry run's shardings, at the f32 tolerance of
    tests/test_torch_model.py: logits, every cache leaf's shards (an
    encoder-decoder's cross_k and cross_v in both layouts) and shard
    shapes, `kv_cache.to_decode_layout` against the decode placement,
    and the bytes against the dry run's. A module adds its family's
    ``test_collectives_by_kind``."""

    CASES: dict
    ATOL = RTOL = 1e-4

    def _close(self, pair, what):
        got, want = pair
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got, want, atol=self.ATOL, rtol=self.RTOL,
                                   err_msg=str(what))

    def cfg(self, key):
        from repro_torch.configs import registry
        arch, overrides = self.CASES[key][:2]
        return _f32(registry.get_smoke(arch)).replace(**overrides)

    def test_prefill_logits_match_reference(self, serves, key, shape):
        for r, rank in enumerate(serves[key][1][shape]):
            self._close(rank["prefill"]["logits"], (key, shape, r))

    def test_prefill_cache_matches_reference(self, serves, key, shape):
        for r, rank in enumerate(serves[key][1][shape]):
            for name, pair in rank["prefill"]["cache"].items():
                self._close(pair, (key, shape, r, name))

    def test_prefill_shard_shapes_match_reference(self, serves, key, shape):
        ref, port = serves[key]
        want = ref["meshes"][shape]["prefill_shapes"]
        for rank in port[shape]:
            assert rank["prefill_shapes"] == want

    def test_decode_logits_match_reference(self, serves, key, shape):
        for r, rank in enumerate(serves[key][1][shape]):
            assert len(rank["decode"]["logits"]) == SERVE_STEPS
            for i, pair in enumerate(rank["decode"]["logits"]):
                self._close(pair, (key, shape, r, "step", i))

    def test_decode_cache_matches_reference(self, serves, key, shape):
        for r, rank in enumerate(serves[key][1][shape]):
            for name, pair in rank["decode"]["cache"].items():
                self._close(pair, (key, shape, r, name))

    def test_decode_shard_shapes_match_reference(self, serves, key, shape):
        ref, port = serves[key]
        want = ref["meshes"][shape]["decode_shapes"]
        for rank in port[shape]:
            assert rank["decode_shapes"] == want

    def test_to_decode_layout_equals_the_decode_placement(self, serves, key,
                                                          shape):
        assert all(rank["layout_equal"] for rank in serves[key][1][shape])

    def test_bytes_match_dry_run(self, serves, key, shape):
        """Each rank's params and decode cache: the dry run's per-device
        argument bytes of the decode step at this mesh (its cache, which
        both packages' dry runs hold in bf16, counted at the model's f32
        under the dry run's specs). Where an encoder-decoder's source is
        not as long as its target, the dry run's one length gives its
        cross leaves the target's: the cache is then counted from the
        reference's own decode shards (shape times the same itemsize)."""
        import torch

        from repro_torch.configs import InputShape
        from repro_torch.launch import dryrun
        from repro_torch.launch import sharding as SH
        from repro_torch.launch.mesh import Mesh

        cfg = self.cfg(key)
        case = self.CASES[key]
        St, Ss = serve_lengths(case)
        extra = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}
        cell = dryrun.build_cell(case[0], InputShape(
            "decode", St, serve_batch(case), "decode"), extra=extra,
            mesh=Mesh(("data", "model"), shape))
        want = cell.argument_bytes()
        cache = {k: v.to(torch.float32) if v.is_floating_point() else v
                 for k, v in cell.args["cache"].items()}
        if Ss == St:
            want["cache"] = SH.tree_bytes(cache, cell.arg_specs["cache"],
                                          cell.mesh)
        else:
            shards = serves[key][0]["meshes"][shape]["decode_shapes"]
            want["cache"] = sum(math.prod(shards[k]) * v.element_size()
                                for k, v in cache.items())
        for rank in serves[key][1][shape]:
            assert rank["bytes"] == {"params": want["params"],
                                     "cache": want["cache"]}


class MoeServeCases(ServeCases):
    """`ServeCases` for the moe family: its cache holds attention's
    leaves alone, and a prefill gathers the data ranks' per-expert counts
    where `moe_sorted` ranks a batch that the data axes split."""

    def test_prefill_cache_matches_reference(self, serves, key, shape):
        for rank in serves[key][1][shape]:
            assert set(rank["prefill"]["cache"]) == {"k", "v", "slot_pos",
                                                     "pos"}
        super().test_prefill_cache_matches_reference(serves, key, shape)

    def test_collectives_by_kind(self, serves, key, shape):
        """A prefill sends each layer's k and v by one ``all_to_all``
        each, and gathers every data rank's per-expert counts
        (``count_all_gather``, (1, E) f32) once a layer only where
        `moe_sorted` ranks the slots in a batch that the data axes split
        ((2, 2) at B 2): "local" ranks them among a rank's own rows,
        "dense" and a replicated batch need none. A decode step gathers
        no counts (its loss is thrown away): it moves q, k, v and the
        outputs by four ``all_to_all`` a layer, sums each layer's f32
        scores (rows, H, W) over ``model``, and the vocab-parallel
        embedding, each layer's row-parallel ``wo`` and its experts'
        partial outputs (rows, D) f32."""
        from repro_torch.models.kv_cache import cache_width

        cfg = self.cfg(key)
        L, D, E = cfg.num_layers, cfg.d_model, cfg.num_experts
        rows = serve_rows(self.CASES[key], shape)
        counts = (shape[0] > 1 and rows < serve_batch(self.CASES[key])
                  and cfg.moe_impl == "sorted")
        W = cache_width(cfg, S)
        for rank in serves[key][1][shape]:
            calls = rank["prefill_collectives"]["calls"]
            assert calls["all_to_all"] == 2 * L
            assert calls.get("count_all_gather", 0) == (L if counts else 0)
            if counts:
                assert rank["prefill_collectives"]["bytes_by"][
                    "count_all_gather"] == L * E * 4
            for c in rank["decode_collectives"]:
                assert "count_all_gather" not in c["calls"]
                assert c["calls"]["all_to_all"] == 4 * L
                assert c["calls"]["score_all_reduce"] == L
                assert c["bytes_by"]["score_all_reduce"] == (
                    L * rows * cfg.num_heads * W * 4)
                assert c["calls"]["all_reduce"] == 2 * L + 1
                assert c["bytes_by"]["all_reduce"] == (
                    (2 * L + 1) * rows * D * 4)
