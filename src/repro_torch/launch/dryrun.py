"""Dry run of every (arch x shape) cell on a production mesh, on the meta
device: what one device of the mesh holds, and the FLOPs of the step.

The counterpart of ``repro.launch.dryrun``. The reference lowers and
compiles each cell's jitted step against its 256- or 512-device mesh and
reads XLA's memory and cost analyses. The port has no compiler to ask,
so per cell this module:

  1. builds the step's inputs as meta tensors (`specs`): the
     `TrainState` of `adamw_init` and the batch (train), the params and
     the batch (prefill), the params, the decode cache and the token
     (decode), and places each leaf on the mesh by the reference's rules
     (`sharding`): ``memory.argument_B`` is the exact per-device bytes;
  2. runs the step once on the meta device on the plain path
     (``plain=True``, as ``serving._structs_for`` does: the kernels'
     wrappers refuse meta tensors) under
     ``torch.utils.flop_counter.FlopCounterMode``: ``memory.output_B``
     is the per-device bytes of its outputs under the out shardings (the
     state's and replicated metrics; the logits' and the cache's), and
     ``flops_per_device`` its FLOP count over the mesh's devices;
  3. adds the analytic ``model_flops_per_device`` and
     ``hbm_bytes_ideal_per_device`` (`repro_torch.models.flops`).

Layers have identical shapes, so by default the pass runs at depth 1 and
2 and the FLOPs and output bytes, both affine in the depth, are
extrapolated to L (``"flops_by": "one layer x L"``: the layer's share is
the difference of the two passes); `run_cell`'s ``full_depth=True`` runs
all L layers (``"flops_by": "full pass"``), which the tests hold the
extrapolation to. The plain attention
takes its queries in row blocks and the plain scan its steps in chunks
to bound a device's memory; meta tensors hold none, so the pass takes
one block of each, and FlopCounterMode counts the same products (the
tests hold both to the blocked pass on CPU tensors).

XLA's own figures have no counterpart: ``compile_s``,
``bytes_accessed_per_device``, ``collective_bytes_per_device`` (the
reference's scan of the optimized HLO), ``temp_B``, ``code_B``,
``hlo_analysis`` and the ``--hlo-out`` / ``--analyze`` options.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.jsonl
(--all runs every runnable cell on both meshes in this process, skips the
cells ``--out`` already holds, and writes an ``error`` record for a cell
whose pass raises.)
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time
import traceback
from dataclasses import dataclass

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (SHAPES, InputShape, ModelConfig, all_cells,
                                 cell_is_runnable, registry)
from repro_torch.kernels.flash_attention import ref as attention_ref
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import flops as FL
from repro_torch.models import get_model
from repro_torch.models import mamba
from repro_torch.optim import adamw_init, make_train_step
from repro_torch.parallel.placement import leaves_with_paths

STEPS = {"train": "train_step", "prefill": "prefill_step",
         "decode": "serve_step"}
FULL_PASS, ONE_LAYER = "full pass", "one layer x L"
DEFAULT_OUT = "results/dryrun_torch.jsonl"


@dataclass
class Cell:
    """One cell's config, shape, mesh and step inputs (meta tensors)
    with their specs ({path: spec} per argument)."""

    arch: str
    cfg: ModelConfig
    shape: InputShape
    mesh: Mesh
    step: str
    args: dict
    arg_specs: dict

    def argument_bytes(self) -> dict[str, int]:
        """Per-device bytes of each argument of the step."""
        return {name: SH.tree_bytes(tree, self.arg_specs[name], self.mesh)
                for name, tree in self.args.items()}


def step_args(cfg: ModelConfig, shape: InputShape) -> dict:
    """The step's inputs as meta tensors, in its argument order."""
    params = SP.param_specs(cfg)
    if shape.kind == "train":
        return {"state": adamw_init(params),
                "batch": SP.train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params, "batch": SP.prefill_batch_specs(cfg, shape)}
    return {"params": params, "cache": SP.decode_cache_specs(cfg, shape),
            "token": SP.decode_token_spec(cfg, shape)}


#: argument name -> the rule that places its leaves (the token is a batch)
ARG_RULES = {"state": SH.state_shardings, "batch": SH.batch_shardings,
             "params": SH.param_shardings, "cache": SH.cache_shardings,
             "token": SH.batch_shardings}


def build_cell(arch: str, shape_name, multi_pod: bool = False,
               extra: dict | None = None, *, mesh: Mesh | None = None
               ) -> Cell:
    """The cell's inputs on its mesh: the production mesh (``multi_pod``)
    unless ``mesh`` is given. ``shape_name`` names a shape of ``SHAPES``
    or is an `InputShape`; ``extra`` overrides config fields (a cut
    depth, say). Raises SystemExit for a cell that does not run."""
    cfg = registry.get(arch)
    if extra:
        cfg = cfg.replace(**extra)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        raise SystemExit(f"SKIP {arch} x {shape.name}: {why}")
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    args = step_args(cfg, shape)
    return Cell(arch, cfg, shape, mesh, STEPS[shape.kind], args,
                {name: ARG_RULES[name](tree, mesh)
                 for name, tree in args.items()})


# ------------------------------------------------------------ the meta pass

@contextlib.contextmanager
def one_block():
    """The plain attention's query rows and the plain scan's steps in one
    block each: the blocks bound a device's memory, which meta tensors do
    not use, and each block costs Python time.

    It sets two module globals for the whole process while it is open, so
    a meta pass runs only where nothing else runs the plain path: this
    module's command line, or a host phase with no model on a device. A
    check beside a device run reads the bytes without a pass
    (`build_cell` and `Cell.argument_bytes`)."""
    saved = attention_ref.SCORE_ELEMS, mamba.SCAN_CHUNK
    attention_ref.SCORE_ELEMS = mamba.SCAN_CHUNK = 1 << 62
    try:
        yield
    finally:
        attention_ref.SCORE_ELEMS, mamba.SCAN_CHUNK = saved


def run_step(cfg: ModelConfig, shape: InputShape, args: dict):
    """The step on ``args`` on the plain path; returns its outputs:
    (state, metrics) for train, (logits, cache) else."""
    device = next(leaf for _, leaf in leaves_with_paths(args)).device
    model = get_model(cfg, device=device)
    if shape.kind == "train":
        step = make_train_step(model, plain=True)
        return step(args["state"], args["batch"])
    if shape.kind == "prefill":
        return model.prefill(args["params"], args["batch"], plain=True)
    return model.decode_step(args["params"], args["cache"], args["token"],
                             plain=True)


def output_bytes(shape: InputShape, outputs, mesh) -> int:
    """Per-device bytes of the step's outputs under its out shardings: the
    state's specs and replicated metrics (train); the logits' and the
    cache's (prefill, decode)."""
    first, second = outputs
    if shape.kind == "train":
        return (SH.tree_bytes(first, SH.state_shardings(first, mesh), mesh)
                + SH.tree_bytes(second, {p: SH.replicated(v.shape)
                                         for p, v in second.items()}, mesh))
    logits = {"logits": first}
    return (SH.tree_bytes(logits, {"logits": SH.logits_spec(
                mesh, tuple(first.shape))}, mesh)
            + SH.tree_bytes(second, SH.cache_shardings(second, mesh,
                                                       shape.kind), mesh))


def at_depth(cfg: ModelConfig, depth: int) -> ModelConfig:
    """``cfg`` with ``depth`` layers (an encoder-decoder's encoder too)."""
    if cfg.is_encoder_decoder:
        return cfg.replace(num_layers=depth, num_encoder_layers=depth)
    return cfg.replace(num_layers=depth)


def extrapolates(cfg: ModelConfig) -> bool:
    """Whether the depth-1 and depth-2 passes give this config's: more
    than 2 layers, and an encoder as deep as the decoder."""
    return cfg.num_layers > 2 and (not cfg.is_encoder_decoder
                                   or cfg.num_encoder_layers
                                   == cfg.num_layers)


@functools.lru_cache(maxsize=4)
def meta_passes(cfg: ModelConfig, shape: InputShape, full_depth: bool
                ) -> dict:
    """The step's meta-device passes: {"by", "depths": [(depth, outputs,
    flops)], "seconds"}. The outputs do not depend on the mesh, so one
    set serves both meshes of a cell (cached)."""
    depths = ([cfg.num_layers] if full_depth or not extrapolates(cfg)
              else [1, 2])
    t0 = time.monotonic()
    runs = []
    for d in depths:
        c = cfg if d == cfg.num_layers else at_depth(cfg, d)
        args = step_args(c, shape)
        with one_block(), FlopCounterMode(display=False) as counter:
            outputs = run_step(c, shape, args)
        runs.append((d, outputs, counter.get_total_flops()))
    return {"by": ONE_LAYER if len(runs) == 2 else FULL_PASS,
            "depths": runs, "seconds": time.monotonic() - t0}


def _at_L(values: list, L: int):
    """A quantity affine in depth, from its values at depths 1 and 2 (or
    the one value of a full pass) to depth L."""
    if len(values) == 1:
        return values[0]
    v1, v2 = values
    return v1 + (L - 1) * (v2 - v1)


def pass_figures(cfg: ModelConfig, shape: InputShape, mesh,
                 full_depth: bool = False) -> dict:
    """The step's FLOPs and per-device output bytes on ``mesh`` at
    ``cfg``'s depth, from `meta_passes`, with how they were had and the
    passes' host seconds."""
    passes = meta_passes(cfg, shape, full_depth)
    runs = passes["depths"]
    return {"by": passes["by"], "seconds": passes["seconds"],
            "flops": _at_L([f for _, _, f in runs], cfg.num_layers),
            "output_B": _at_L([output_bytes(shape, o, mesh)
                               for _, o, _ in runs], cfg.num_layers)}


def run_cell(arch: str, shape_name, multi_pod: bool = False,
             extra: dict | None = None, *, mesh: Mesh | None = None,
             full_depth: bool = False) -> dict:
    """The dry-run record of one cell (see the module docstring)."""
    cell = build_cell(arch, shape_name, multi_pod, extra, mesh=mesh)
    cfg, shape, mesh = cell.cfg, cell.shape, cell.mesh
    figures = pass_figures(cfg, shape, mesh, full_depth)
    devices = mesh.size
    args_b = cell.argument_bytes()
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh.name,
        "step": cell.step, "devices": devices,
        "pass_s": round(figures["seconds"], 3),
        "flops_by": figures["by"],
        "flops_per_device": figures["flops"] / devices,
        "model_flops_per_device": FL.model_flops(cfg, shape)["total"]
        / devices,
        "hbm_bytes_ideal_per_device": FL.hbm_bytes_ideal(cfg, shape,
                                                         devices=devices),
        "memory": {
            "argument_B": sum(args_b.values()),
            "output_B": figures["output_B"],
            "arguments_B": args_b,
        },
    }
    if extra:
        rec["extra"] = extra
    return rec


# --------------------------------------------------------------------- main

def cells_to_run() -> list[tuple[str, str, bool]]:
    cells = []
    for arch, shape_name in all_cells():
        cfg = registry.get(arch)
        ok, _ = cell_is_runnable(cfg, SHAPES[shape_name])
        if not ok:
            continue
        for multi_pod in (False, True):
            cells.append((arch, shape_name, multi_pod))
    return cells


def _append(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def run_all(out: str, extra: dict | None = None,
            single_pod_only: bool = False) -> list[dict]:
    """Every runnable cell on both meshes, appended to ``out`` as JSONL;
    cells ``out`` holds without an error are skipped. With
    ``single_pod_only`` the 2x16x16 cells are left out, silently, after
    the skip of a done cell, in the reference's order."""
    done = set()
    if os.path.exists(out):
        with open(out) as f:
            for line in f:
                r = json.loads(line)
                if "error" not in r:
                    done.add((r["arch"], r["shape"], r["mesh"]))
    cells = cells_to_run()
    records = []
    for i, (arch, shape_name, multi_pod) in enumerate(cells):
        mesh_name = make_production_mesh(multi_pod=multi_pod).name
        tag = f"[{i + 1}/{len(cells)}] {arch} {shape_name} {mesh_name}"
        if (arch, shape_name, mesh_name) in done:
            print(f"{tag} skip (done)", flush=True)
            continue
        if multi_pod and single_pod_only:
            continue
        t0 = time.monotonic()
        try:
            rec = run_cell(arch, shape_name, multi_pod, extra)
        except Exception as e:              # noqa: BLE001 — recorded
            err = traceback.format_exception_only(type(e), e)
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                   "error": [line.strip() for line in err][-3:]}
            print(f"{tag} FAILED: {rec['error'][-1]}", flush=True)
        else:
            print(f"{tag} {time.monotonic() - t0:.2f}s", flush=True)
        _append(out, rec)
        records.append(rec)
    return records


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every runnable cell x both meshes, appending "
                         "JSONL to --out")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--extra", default=None,
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--single-pod-only", action="store_true",
                    help="--all: skip the 2x16x16 mesh (roofline table "
                         "is single-pod)")
    args = ap.parse_args(argv)
    extra = json.loads(args.extra) if args.extra else None
    if args.all:
        return run_all(args.out, extra, args.single_pod_only)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all, are required")
    rec = run_cell(args.arch, args.shape, args.multi_pod, extra)
    print(json.dumps(rec))
    if args.out:
        _append(args.out, rec)
    return [rec]


if __name__ == "__main__":
    main()
