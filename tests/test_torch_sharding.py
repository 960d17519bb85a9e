"""The port's mesh, sharding rules and input stand-ins against the
reference (`repro.launch.{mesh,sharding,specs}`), in one process.

The reference's rules are evaluated on fake meshes (axis names and sizes
only), as its own sharding tests do, so nothing is compiled. Specs are
compared normalised: one entry per dim, each None or a tuple of axis
names. The reference's dry run reads per-device argument bytes from XLA;
here they are summed on the test side over the reference's
``jax.eval_shape`` structs under the reference's specs, and held equal to
the port's ``memory.argument_B`` on every runnable cell and mesh; its
output bytes likewise, over ``jax.eval_shape`` of the reference's steps
under their out shardings, against the port's ``memory.output_B``.
"""
import functools
import math

import jax
import numpy as np
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import registry as ref_registry
from repro.launch import sharding as ref_SH
from repro.launch import specs as ref_SP
from repro.launch.mesh import data_axes as ref_data_axes
from repro.models import get_model as ref_get_model
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import make_train_step as ref_make_train_step
from repro_torch.configs import (ARCH_IDS, SHAPES, all_cells,
                                 cell_is_runnable, registry)
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.optim import adamw_init
from repro_torch.parallel import placement as P


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RUNNABLE = [(a, s) for a, s in all_cells()
            if cell_is_runnable(registry.get(a), SHAPES[s])[0]]
CELL_MESHES = [(a, s, m) for a, s in RUNNABLE for m in MESHES]


def _norm(spec, ndim):
    """A spec as one entry per dim, each None or a tuple of axis names."""
    entries = list(spec) + [None] * (ndim - len(tuple(spec)))
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in entries)


def _ref_flat(tree):
    """(path, leaf) of a reference tree, paths '/'-joined as its rules
    see them."""
    return [(ref_SH._path_str(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_flat(tree):
    return {P.path_str(p): leaf for p, leaf in P.leaves_with_paths(tree)}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return ref_get_model(ref_registry.get(arch)).param_shapes()


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return jax.eval_shape(ref_adamw_init, _ref_params(arch))


def _ref_state_spec(path, shape, mesh):
    """The reference's `state_shardings` rule, without its NamedSharding."""
    if path.startswith(("params/", "mu/", "nu/", "err/")):
        return ref_SH.param_spec(path.split("/", 1)[1], shape, mesh)
    return ()


def _ref_bytes(flat, rule, mesh):
    """Per-device bytes of a reference tree under ``rule(path, shape)``."""
    total = 0
    for path, leaf in flat:
        spec = _norm(rule(path, leaf.shape), len(leaf.shape))
        shards = math.prod(math.prod(mesh.shape[a] for a in axes)
                           for axes in spec if axes)
        nbytes = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        assert nbytes % shards == 0, (path, leaf.shape, spec)
        total += nbytes // shards
    return total


def _ref_arguments(arch, shape_name, mesh):
    """{argument: per-device bytes} of the reference's step inputs."""
    cfg, shape = ref_registry.get(arch), REF_SHAPES[shape_name]
    batch_rule = functools.partial(_batch_rule, mesh=mesh)
    if shape.kind == "train":
        return {"state": _ref_bytes(_ref_flat(_ref_state(arch)),
                                    lambda p, s: _ref_state_spec(p, s, mesh),
                                    mesh),
                "batch": _ref_bytes(_ref_flat(ref_SP.train_batch_specs(
                    cfg, shape)), batch_rule, mesh)}
    params = _ref_bytes(_ref_flat(_ref_params(arch)),
                        lambda p, s: ref_SH.param_spec(p, s, mesh), mesh)
    if shape.kind == "prefill":
        return {"params": params,
                "batch": _ref_bytes(_ref_flat(ref_SP.prefill_batch_specs(
                    cfg, shape)), batch_rule, mesh)}
    cache = ref_SP.decode_cache_specs(cfg, shape)
    return {"params": params,
            "cache": _ref_bytes(_ref_flat(cache), lambda p, s:
                                ref_SH.cache_spec(p, s, mesh), mesh),
            "token": _ref_bytes(_ref_flat({"t": ref_SP.decode_token_spec(
                cfg, shape)}), batch_rule, mesh)}


def _batch_rule(path, shape, mesh):
    return ref_SH.batch_spec(path, shape, mesh)


@functools.lru_cache(maxsize=4)
def _ref_outputs(arch, shape_name):
    """``jax.eval_shape`` of the reference's step, as its dry run lowers
    it: (state, metrics) for train, (logits, cache) else."""
    cfg, shape = ref_registry.get(arch), REF_SHAPES[shape_name]
    model = ref_get_model(cfg)
    params = _ref_params(arch)
    if shape.kind == "train":
        return jax.eval_shape(ref_make_train_step(model), _ref_state(arch),
                              ref_SP.train_batch_specs(cfg, shape))
    if shape.kind == "prefill":
        return jax.eval_shape(lambda p, b: model.prefill(p, b), params,
                              ref_SP.prefill_batch_specs(cfg, shape))
    return jax.eval_shape(lambda p, c, t: model.decode_step(p, c, t), params,
                          ref_SP.decode_cache_specs(cfg, shape),
                          ref_SP.decode_token_spec(cfg, shape))


def _ref_output_bytes(arch, shape_name, mesh):
    """Per-device bytes of the reference's step outputs under its out
    shardings: the state's specs and replicated metrics (train); the
    guarded logits rule and the cache's rule of the step's kind."""
    first, second = _ref_outputs(arch, shape_name)
    kind = REF_SHAPES[shape_name].kind
    if kind == "train":
        return (_ref_bytes(_ref_flat(first),
                           lambda p, s: _ref_state_spec(p, s, mesh), mesh)
                + _ref_bytes(_ref_flat(second), lambda p, s: (), mesh))
    logits = _ref_bytes([("logits", first)], lambda p, s: ref_SH._guard(
        (ref_data_axes(mesh), None, "model"), s, mesh), mesh)
    return logits + _ref_bytes(_ref_flat(second), lambda p, s:
                               ref_SH.cache_spec(p, s, mesh, kind), mesh)


# ------------------------------------------------------------------- mesh

def test_production_and_debug_meshes():
    single, multi = M.make_production_mesh(), M.make_production_mesh(
        multi_pod=True)
    assert (single.shape, single.axis_names, single.size, single.name) == (
        {"data": 16, "model": 16}, ("data", "model"), 256, "16x16")
    assert (multi.shape, multi.axis_names, multi.size, multi.name) == (
        {"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model"), 512,
        "2x16x16")
    for mesh, fake in ((single, MESHES["16x16"]),
                       (multi, MESHES["2x16x16"])):
        assert M.data_axes(mesh) == ref_data_axes(FakeMesh(fake))
        assert M.model_axis_size(mesh) == 16
    debug = M.make_debug_mesh()
    assert (debug.shape, debug.size, debug.name) == (
        {"data": 1, "model": 1}, 1, "1x1")
    assert M.make_debug_mesh(4).shape == {"data": 1, "model": 4}


# ------------------------------------------------------------------- specs

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_spec_equals_reference(arch, mesh_name):
    """Every leaf of every full config: the port's params tree has the
    reference's paths, shapes and dtypes, and each leaf the reference's
    spec."""
    mesh = FakeMesh(MESHES[mesh_name])
    port = _port_flat(SP.param_specs(registry.get(arch)))
    ref = _ref_flat(_ref_params(arch))
    assert sorted(port) == sorted(p for p, _ in ref)
    specs = SH.param_shardings(SP.param_specs(registry.get(arch)), mesh)
    for path, leaf in ref:
        got = port[path]
        assert tuple(got.shape) == tuple(leaf.shape), path
        assert str(got.dtype).split(".")[-1] == str(leaf.dtype), path
        want = _norm(ref_SH.param_spec(path, leaf.shape, mesh),
                     len(leaf.shape))
        assert _norm(SH.param_spec(path, tuple(leaf.shape), mesh),
                     len(leaf.shape)) == want, path
        assert _norm(specs[path], len(leaf.shape)) == want, path


@pytest.mark.parametrize("arch,shape_name,mesh_name", CELL_MESHES)
def test_cell_specs_equal_reference(arch, shape_name, mesh_name):
    """The state, batch, token, cache (prefill and decode) and logits
    rules, leaf for leaf, on the cell's inputs."""
    mesh = FakeMesh(MESHES[mesh_name])
    cfg, shape = registry.get(arch), SHAPES[shape_name]
    ref_cfg, ref_shape = ref_registry.get(arch), REF_SHAPES[shape_name]

    def same(port_tree, port_rule, ref_tree, ref_rule):
        port = _port_flat(port_tree)
        ref = _ref_flat(ref_tree)
        assert sorted(port) == sorted(p for p, _ in ref)
        for path, leaf in ref:
            assert tuple(port[path].shape) == tuple(leaf.shape), path
            n = len(leaf.shape)
            assert (_norm(port_rule(path, tuple(leaf.shape)), n)
                    == _norm(ref_rule(path, leaf.shape), n)), path

    if shape.kind == "train":
        same(adamw_init(SP.param_specs(cfg)),
             lambda p, s: SH.state_spec(p, s, mesh), _ref_state(arch),
             lambda p, s: _ref_state_spec(p, s, mesh))
        same(SP.train_batch_specs(cfg, shape),
             lambda p, s: SH.batch_spec(p, s, mesh),
             ref_SP.train_batch_specs(ref_cfg, ref_shape),
             lambda p, s: ref_SH.batch_spec(p, s, mesh))
    elif shape.kind == "prefill":
        same(SP.prefill_batch_specs(cfg, shape),
             lambda p, s: SH.batch_spec(p, s, mesh),
             ref_SP.prefill_batch_specs(ref_cfg, ref_shape),
             lambda p, s: ref_SH.batch_spec(p, s, mesh))
    else:
        same({"t": SP.decode_token_spec(cfg, shape)},
             lambda p, s: SH.batch_spec(p, s, mesh),
             {"t": ref_SP.decode_token_spec(ref_cfg, ref_shape)},
             lambda p, s: ref_SH.batch_spec(p, s, mesh))
    cache = SP.decode_cache_specs(cfg, shape)
    ref_cache = ref_SP.decode_cache_specs(ref_cfg, ref_shape)
    for kind in ("prefill", "decode"):
        same(cache, lambda p, s: SH.cache_spec(p, s, mesh, kind), ref_cache,
             lambda p, s: ref_SH.cache_spec(p, s, mesh, kind))
    logits = (shape.global_batch, 1, cfg.vocab_size)
    assert _norm(SH.logits_spec(mesh, logits), 3) == _norm(ref_SH._guard(
        (ref_data_axes(mesh), None, "model"), logits, mesh), 3)
    assert (_norm(SH.logits_spec(mesh), 3)
            == _norm((ref_data_axes(mesh), None, "model"), 3))


@pytest.mark.parametrize("arch,shape_name,mesh_name", CELL_MESHES)
def test_argument_bytes_equal_reference(arch, shape_name, mesh_name):
    """``memory.argument_B`` and each argument's share equal the sum over
    the reference's eval_shape structs under its specs."""
    multi = mesh_name == "2x16x16"
    cell = dryrun.build_cell(arch, shape_name, multi)
    want = _ref_arguments(arch, shape_name, FakeMesh(MESHES[mesh_name]))
    assert cell.mesh.name == mesh_name
    assert cell.argument_bytes() == want


@pytest.mark.parametrize("arch,shape_name,mesh_name", CELL_MESHES)
def test_output_bytes_equal_reference(arch, shape_name, mesh_name):
    """``memory.output_B`` (the meta pass's outputs, depth extrapolated)
    equals the sum over the reference's eval_shape outputs under its out
    shardings: a leaf missing from or extra in the port's train state or
    cache would show here."""
    rec = dryrun.run_cell(arch, shape_name, mesh_name == "2x16x16")
    want = _ref_output_bytes(arch, shape_name, FakeMesh(MESHES[mesh_name]))
    assert rec["mesh"] == mesh_name
    assert rec["memory"]["output_B"] == want


class TestShardingRules:
    def test_param_specs_divisible(self):
        """Every leaf of every full config gets a spec whose axes divide
        the dims — the invariant the 40-cell dry run rests on."""
        fake = FakeMesh(MESHES["2x16x16"])
        for arch in ARCH_IDS:
            structs = SP.param_specs(registry.get(arch))
            for path, leaf in P.leaves_with_paths(structs):
                path = P.path_str(path)
                spec = SH.param_spec(path, tuple(leaf.shape), fake)
                assert len(spec) == leaf.dim()
                for dim, axes in zip(leaf.shape, spec):
                    if axes is None:
                        continue
                    axes = (axes,) if isinstance(axes, str) else axes
                    size = 1
                    for a in axes:
                        size *= fake.shape[a]
                    assert dim % size == 0, (arch, path, leaf.shape, spec)

    def test_fsdp_actually_shards_big_leaves(self):
        """The embed and attention weights must NOT be replicated."""
        fake = FakeMesh(MESHES["16x16"])
        cfg = registry.get("llama3-8b")
        spec = SH.param_spec("embed", (cfg.vocab_size, cfg.d_model), fake)
        assert spec != (None, None)
        spec = SH.param_spec("layers/attn/wq",
                             (cfg.num_layers, cfg.d_model,
                              cfg.num_heads * cfg.head_dim), fake)
        assert spec == (None, "data", "model")


def test_leaf_bytes():
    mesh = M.make_production_mesh(multi_pod=True)
    assert SH.leaf_bytes((64, 32), 2, (("pod", "data"), "model"), mesh) \
        == 64 * 32 * 2 // 512
    assert SH.leaf_bytes((64, 32), 4, (None, None), mesh) == 64 * 32 * 4
    assert SH.leaf_bytes((), 4, (), mesh) == 4
    for shape, spec in (((3, 32), ("data", None)), ((32,), (None, None))):
        with pytest.raises(ValueError):
            SH.leaf_bytes(shape, 2, spec, mesh)
