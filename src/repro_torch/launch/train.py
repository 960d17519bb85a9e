"""End-to-end training driver: Nexus-fed pipeline + fault tolerance.

The counterpart of ``repro.launch.train``, with the port's model on a
CUDA card (or the CPU when asked). It wires the substrates together:
a synthetic corpus in remote storage -> Nexus backend prefetch
(overlapped with compute) -> the train step (`make_train_step`: the loss
through the kernels, their backward kernels, AdamW in place) -> async
checkpointing through the backend's writeback path -> restore on start
(``--resume``, elastic restart at step boundaries).

The mesh and sharding of the reference's driver are not here (one
device); `run` takes a config directly, so a caller can train a config
cut in depth without a flag for it, as `serve.run` serves one.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --smoke --steps 4 --batch 2 --seq 64 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import math
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
from repro_torch.configs import registry
from repro_torch.core import metrics as M
from repro_torch.core.backend import NexusBackend
from repro_torch.core.storage import ObjectStore, RemoteStorage
from repro_torch.data import DataPipeline, SyntheticCorpus
from repro_torch.data.pipeline import CorpusSpec
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.optim import adamw_init, make_train_step
from repro_torch.optim.adamw import TrainState, state_fields


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
        device=None, runtime=None, step_context=None) -> dict:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens.

    ``runtime`` is a (store, backend, acct) triple from `build_runtime`
    (a new one by default), so a second run can resume from the first's
    checkpoints; ``step_context(step)``, if given, returns a context
    manager the step runs inside (a profiler, say). Returns the final
    state, per-step records (loss, grad norm, host wall seconds and, on
    the card, device seconds between CUDA events), the pipeline, the
    checkpointer, the runtime and the step training started from.
    """
    if cfg.is_encoder_decoder or cfg.embed_input:
        raise SystemExit("train driver covers token-LM archs; "
                         "use smoke tests for enc-dec/vlm")
    dev = resolve_device(device)
    model = get_model(cfg, dev)
    store, backend, acct = runtime or build_runtime(transport)
    corpus = SyntheticCorpus(store, CorpusSpec(
        name="corpus", vocab_size=cfg.vocab_size,
        shard_tokens=batch * (seq + 1) * 2, num_shards=8))
    corpus.materialize()
    pipeline = DataPipeline(corpus, backend, batch=batch, seq_len=seq)
    ckpt = AsyncCheckpointer(backend, bucket="ckpts")

    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    state = adamw_init(params)

    start_step = 0
    if resume:
        try:
            start_step, flat = restore_checkpoint(store, "ckpts",
                                                  backend=backend)
            state = unflatten_into(state, flat)
            print(f"resumed from checkpoint at step {start_step}")
        except KeyError:
            print("no checkpoint found; starting fresh")

    step_fn = make_train_step(model)
    records = []
    for step in range(start_step, start_step + steps):
        batch_np = pipeline.next_batch()
        tensors = {k: torch.from_numpy(v).to(dev)
                   for k, v in batch_np.items()}
        ctx = step_context(step) if step_context else contextlib.nullcontext()
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
        records.append(record)
        print(f"step {step:4d} loss={loss:.4f} "
              f"({dt*1e3:.0f} ms, overlap="
              f"{pipeline.overlap_efficiency():.0%})", flush=True)
        if not math.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step}: {loss}")
        if (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, state)

    ckpt.wait()
    print(f"done; {ckpt.saves} async checkpoints committed, "
          f"pipeline overlap {pipeline.overlap_efficiency():.0%}")
    return {"state": state, "records": records, "pipeline": pipeline,
            "checkpointer": ckpt, "runtime": (store, backend, acct),
            "start_step": start_step, "model": model}


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
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (registry.get_smoke(args.arch) if args.smoke
           else registry.get(args.arch))
    return run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               ckpt_every=args.ckpt_every, transport=args.transport,
               resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
