"""End-to-end training driver: Nexus-fed pipeline + fault tolerance.

The counterpart of ``repro.launch.train``, with the port's model on a
CUDA card (or the CPU when asked). It wires the substrates together:
a synthetic corpus in remote storage -> Nexus backend prefetch
(overlapped with compute) -> the train step (`make_train_step`: the loss
through the kernels, their backward kernels, AdamW in place) -> async
checkpointing through the backend's writeback path -> restore on start
(``--resume``, elastic restart at step boundaries).

``--mesh {debug,prod,multipod}`` trains on the reference's mesh, one
process a rank: ``debug`` is (1, n) over every rank there is, ``prod``
16x16 and ``multipod`` 2x16x16 (which need 256 and 512 ranks). Each rank
holds its shards of the train state under the reference's rules
(``launch/sharding.py``, which `run` turns into the placement that the
step, the pipeline and the checkpoints take) and its slice of the global
batch; the step is tensor-parallel over ``model`` (the moe family's
experts too) and FSDP over the data axes (every token-LM family:
``lm.check_mesh``). Without
``--mesh`` (or on a world of one) the step is the one-device step. `run` takes a config directly, so a
caller can train a config cut in depth without a flag for it, as
`serve.run` serves one.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --smoke --steps 4 --batch 2 --seq 64 --device cpu
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch llama3-8b --smoke --mesh debug
  (rank r on cuda:r over NCCL; add --device cpu for gloo on the CPU)
"""
from __future__ import annotations

import argparse
import contextlib
import math
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
from repro_torch.checkpoint.ckpt import restore_to_mesh
from repro_torch.configs import registry
from repro_torch.core import metrics as M
from repro_torch.core.backend import NexusBackend
from repro_torch.core.storage import ObjectStore, RemoteStorage
from repro_torch.data import DataPipeline, SyntheticCorpus
from repro_torch.data.pipeline import CorpusSpec
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import MESHES, RankMesh, join_mesh
from repro_torch.models import get_model
from repro_torch.models.registry import param_structs
from repro_torch.optim import adamw_init, make_train_step
from repro_torch.optim.adamw import TrainState, state_fields
from repro_torch.parallel import collectives as C
from repro_torch.parallel import placement as P


def build_runtime(transport: str = "tcp"):
    store = ObjectStore()
    acct = M.CycleAccount()
    remote = RemoteStorage(store, transport, acct)
    backend = NexusBackend(remote, acct, transport_name=transport)
    return store, backend, acct


def unflatten_into(state: TrainState, flat: dict) -> TrainState:
    """Restore a flat {path: tensor} dict into a state of ``state``'s
    structure, each leaf in the dtype and on the device of ``state``'s
    (the paths are the checkpoint's: ``step``, ``params/embed``, ...)."""
    def fill(tree, path):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: fill(v, f"{path}/{k}") for k, v in tree.items()}
        return flat[path].to(device=tree.device, dtype=tree.dtype)
    return TrainState(**{name: fill(tree, name)
                         for name, tree in state_fields(state)})


def run(cfg, *, steps: int = 20, batch: int = 8, seq: int = 256,
        ckpt_every: int = 10, transport: str = "tcp", resume: bool = False,
        device=None, runtime=None, step_context=None, mesh=None,
        backend=None) -> dict:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens.

    ``runtime`` is a (store, backend, acct) triple from `build_runtime`
    (a new one by default), so a second run can resume from the first's
    checkpoints; ``step_context(step)``, if given, returns a context
    manager the step runs inside (a profiler, say). Returns the final
    state, per-step records (loss, grad norm, host wall seconds and, on
    the card, device seconds between CUDA events), the pipeline, the
    checkpointer, the runtime and the step training started from.

    ``mesh``: a ``--mesh`` name (`join_mesh`, with ``device`` and
    ``backend``) or a `RankMesh`. On more than one rank the state is this
    rank's shards (``state_bytes`` has every rank's bytes), each record
    adds the step's collectives (calls, bytes, host seconds, device
    seconds under NCCL), ``tp`` is the step's `Sharded` placement (its
    ``gathers`` count the model-axis gathers of weights whose rank's
    range is not its own shard), and rank 0 prints; checkpoints gather
    to rank 0 and restore from it.
    """
    if cfg.is_encoder_decoder or cfg.embed_input:
        raise SystemExit("train driver covers token-LM archs; "
                         "use smoke tests for enc-dec/vlm")
    if mesh is not None and not isinstance(mesh, RankMesh):
        mesh = join_mesh(mesh, device=device, backend=backend)
    if mesh is not None and mesh.size == 1:
        device, mesh = mesh.device, None
    dev = resolve_device(device) if mesh is None else mesh.device
    rank0 = mesh is None or mesh.rank == 0
    model = get_model(cfg, dev)
    store, backend_, acct = runtime or build_runtime(transport)
    corpus = SyntheticCorpus(store, CorpusSpec(
        name="corpus", vocab_size=cfg.vocab_size,
        shard_tokens=batch * (seq + 1) * 2, num_shards=8))
    corpus.materialize()
    pipeline = DataPipeline(corpus, backend_, batch=batch, seq_len=seq)
    ckpt = AsyncCheckpointer(backend_, bucket="ckpts")

    tp = (SH.placement(mesh, param_structs(cfg))
          if mesh is not None else None)
    step_fn = make_train_step(model, tp=tp)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    if tp is not None:                   # every rank draws the same params
        params = P.params_to_mesh(params, tp)
    state = adamw_init(params)
    del params
    state_bytes = [P.state_bytes(state)]
    if tp is not None:
        state_bytes = [None] * mesh.size
        dist.all_gather_object(state_bytes, P.state_bytes(state))
        if rank0:
            print(f"mesh {mesh.name} {mesh.axis_names} over {mesh.size} "
                  f"ranks, collectives {C.backend_note(mesh)}; rank 0 on "
                  f"{dev}; train state bytes by rank {state_bytes}",
                  flush=True)

    start_step = 0
    if resume:
        try:
            if tp is None:
                start_step, flat = restore_checkpoint(store, "ckpts",
                                                      backend=backend_)
                state = unflatten_into(state, flat)
            else:
                start_step, state = restore_to_mesh(store, "ckpts", state,
                                                    tp, backend=backend_)
            if rank0:
                print(f"resumed from checkpoint at step {start_step}")
        except KeyError:
            if rank0:
                print("no checkpoint found; starting fresh")

    # the mesh axes the batch dim is split over (the reference's batch
    # rule), whose rows each rank keeps
    rows = (SH.batch_spec("tokens", (batch, seq), mesh)[0]
            if mesh is not None else None)
    if (tp is not None and cfg.family == "moe" and rows is None
            and mesh.group(tp.data) is not None):
        raise SystemExit(f"{cfg.name}: a batch of {batch} does not split "
                         f"over the data axes {tp.data}; the moe family's "
                         f"capacity slots are the whole batch's, counted "
                         f"from each data rank's own rows")
    records = []
    for step in range(start_step, start_step + steps):
        batch_np = pipeline.next_batch(mesh, rows)
        tensors = {k: torch.from_numpy(v).to(dev)
                   for k, v in batch_np.items()}
        ctx = step_context(step) if step_context else contextlib.nullcontext()
        if mesh is not None:
            mesh.stats.reset()
        with ctx:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                events[0].record()
            t0 = time.monotonic()
            state, metrics = step_fn(state, tensors)
            if dev.type == "cuda":
                events[1].record()
                torch.cuda.synchronize(dev)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
        record = {"step": step, "loss": loss,
                  "grad_norm": float(metrics["grad_norm"]),
                  "aux_loss": float(metrics["aux_loss"]), "wall_s": dt,
                  "device_s": (events[0].elapsed_time(events[1]) / 1e3
                               if dev.type == "cuda" else None)}
        note = ""
        if tp is not None:
            c = record["collectives"] = mesh.stats.summary()
            note = (f"; collectives {sum(c['calls'].values())} calls, "
                    f"{c['bytes'] / 1e9:.3f} GB, {c['host_s'] * 1e3:.0f} ms "
                    f"host" + ("" if c["device_s"] is None else
                               f", {c['device_s'] * 1e3:.0f} ms device"))
        records.append(record)
        if rank0:
            print(f"step {step:4d} loss={loss:.4f} "
                  f"({dt*1e3:.0f} ms, overlap="
                  f"{pipeline.overlap_efficiency():.0%}{note})", flush=True)
        if not math.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step}: {loss}")
        if (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, state, tp)

    ckpt.wait()
    if rank0:
        print(f"done; {ckpt.saves} async checkpoints committed, "
              f"pipeline overlap {pipeline.overlap_efficiency():.0%}")
        if tp is not None:
            print(f"model-axis gathers of weights whose rank's range is "
                  f"not its shard: {tp.gathers or 'none'}", flush=True)
    return {"state": state, "records": records, "pipeline": pipeline,
            "checkpointer": ckpt, "runtime": (store, backend_, acct),
            "start_step": start_step, "model": model, "mesh": mesh,
            "tp": tp, "state_bytes": state_bytes}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--transport", default="tcp", choices=("tcp", "rdma"))
    ap.add_argument("--mesh", default=None, choices=MESHES,
                    help="train on the reference's mesh, one process a "
                         "rank (torch.distributed.run); one device without")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (registry.get_smoke(args.arch) if args.smoke
           else registry.get(args.arch))
    try:
        return run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                   ckpt_every=args.ckpt_every, transport=args.transport,
                   resume=args.resume, device=args.device, mesh=args.mesh)
    finally:
        if args.mesh is not None and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
