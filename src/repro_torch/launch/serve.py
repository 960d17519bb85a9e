"""Model-serving driver: LM instances under the Nexus runtime, in PyTorch.

The counterpart of ``repro.launch.serve``, with the port's model on a
CUDA card (or the CPU when asked):

* a request's prompt payload lives in remote storage; the ingress layer
  promotes (bucket, key, size) hints;
* the Nexus backend prefetches the prompt into the tenant arena
  OVERLAPPED with instance acquisition (the serving analogue of
  snapshot restore, paper §4.2.2);
* the guest step (prefill + greedy decode loop) reads the prompt from
  the arena slot, generates, and hands the completion to the backend;
* the backend writes the completion back asynchronously; the request
  future resolves only after the PUT is acked (at-least-once, §4.2.5).

As in the reference, prefill without ``cache_len`` builds a cache exactly
as wide as the prompt, so every decode step attends to the last
``prompt_len`` positions (the first step overwrites position 0).

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --requests 4 --gen 4
"""
from __future__ import annotations

import argparse
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import metrics as M
from repro_torch.core.backend import NexusBackend
from repro_torch.core.hints import extract_hints, make_event
from repro_torch.core.storage import ObjectStore, RemoteStorage
from repro_torch.device import resolve_device
from repro_torch.models import get_model


class ModelInstance:
    """One warm model replica: shared params + prefill/decode."""

    def __init__(self, cfg, model, params):
        self.cfg = cfg
        self.model = model
        self.params = params
        self.device = model.device
        self._busy = threading.Lock()

    def warmup(self, seq_len: int, batch: int = 1) -> None:
        toks = torch.zeros((batch, seq_len), dtype=torch.int32,
                           device=self.device)
        _, cache = self.model.prefill(self.params, {"tokens": toks})
        tok = torch.zeros((batch, 1), dtype=torch.int32, device=self.device)
        self.model.decode_step(self.params, cache, tok)

    def generate(self, prompt: np.ndarray, gen_tokens: int) -> np.ndarray:
        toks = torch.from_numpy(prompt.astype(np.int32)[None, :]).to(
            self.device)
        logits, cache = self.model.prefill(self.params, {"tokens": toks})
        out = []
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        for _ in range(gen_tokens):
            out.append(int(tok[0, 0]))
            logits, cache = self.model.decode_step(self.params, cache, tok)
            tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        return np.asarray(out, np.int32)


class NexusModelServer:
    """Batched request serving through the Nexus fast path.

    ``device`` defaults to ``"cuda"`` and raises without a card.
    ``params`` injects a params tree (for example the reference's,
    through `repro_torch.models.convert`); by default the replicas share
    one seeded init on the device.
    """

    def __init__(self, cfg, *, transport: str = "tcp", replicas: int = 1,
                 prompt_len: int = 128, device=None, params=None):
        model = get_model(cfg, resolve_device(device))
        self.cfg = cfg
        self.device = model.device
        self.acct = M.CycleAccount()
        self.store = ObjectStore()
        remote = RemoteStorage(self.store, transport, self.acct)
        self.backend = NexusBackend(remote, self.acct,
                                    transport_name=transport)
        self.cred = self.backend.register_function("lm", {"prompts", "out"})
        self.prompt_len = prompt_len

        if params is None:
            params = model.init_params()
        self.instances = [ModelInstance(cfg, model, params)
                          for _ in range(replicas)]
        self._pool = ThreadPoolExecutor(max_workers=max(replicas, 2))
        self.latency = M.LatencyTrace()

    def seed_prompt(self, key: str, rng: np.random.Generator) -> None:
        prompt = rng.integers(0, self.cfg.vocab_size, self.prompt_len,
                              dtype=np.int32)
        self.store.put("prompts", key, prompt.tobytes())

    def submit(self, key: str, gen_tokens: int) -> "Future[np.ndarray]":
        event = make_event(
            [("prompts", key, self.store.head("prompts", key).size)],
            [("out", f"{key}-completion")])
        return self._pool.submit(self._serve_one, event, gen_tokens)

    def _serve_one(self, event: dict, gen_tokens: int) -> np.ndarray:
        t0 = time.monotonic()
        self.backend.terminate_rpc()
        inputs, outputs = extract_hints(event)
        inp, out = inputs[0], outputs[0]

        # prefetch the prompt OVERLAPPED with instance acquisition
        handle = self.backend.prefetch("lm", self.cred, inp)
        inst = self._acquire_instance()
        try:
            slot = handle.wait()
            prompt = np.frombuffer(bytes(slot.view()), np.int32)
            slot.release()
            completion = inst.generate(prompt, gen_tokens)
        finally:
            inst._busy.release()          # early release: PUT is backend's

        wslot = self.backend.arenas.get("lm").alloc(completion.nbytes)
        wslot.write(completion.tobytes())
        ticket = self.backend.submit_put(
            "lm", self.cred, out, wslot,
            invocation_id=f"{out.key}")
        ticket.future.result(timeout=30)  # response gated on durability
        self.latency.record("serve", time.monotonic() - t0)
        return completion

    def _acquire_instance(self) -> ModelInstance:
        while True:
            for inst in self.instances:
                if inst._busy.acquire(blocking=False):
                    return inst
            time.sleep(0.001)


def main(argv=None) -> dict:
    """Serve ``--requests`` prompts; returns the server, the completions
    and the wall time of the request phase."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--transport", default="tcp", choices=("tcp", "rdma"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (registry.get_smoke(args.arch) if args.smoke
           else registry.get(args.arch))
    server = NexusModelServer(cfg, transport=args.transport,
                              replicas=args.replicas,
                              prompt_len=args.prompt_len, device=args.device)
    rng = np.random.default_rng(0)
    keys = [f"req-{i}" for i in range(args.requests)]
    for k in keys:
        server.seed_prompt(k, rng)
    for inst in server.instances:
        inst.warmup(args.prompt_len)

    t0 = time.monotonic()
    futs = [server.submit(k, args.gen) for k in keys]
    outs = [f.result(timeout=600) for f in futs]
    wall = time.monotonic() - t0

    if not all(o.size == args.gen for o in outs):
        raise RuntimeError("a completion has the wrong length")
    if server.store.gets < args.requests:
        raise RuntimeError("prompts were not fetched from the store")
    p50 = server.latency.percentile("serve", 50)
    p99 = server.latency.percentile("serve", 99)
    print(f"{args.requests} requests x {args.gen} tokens in {wall:.2f}s "
          f"(p50={p50*1e3:.0f}ms p99={p99*1e3:.0f}ms, "
          f"{args.requests * args.gen / wall:.1f} tok/s) on {server.device}")
    return {"server": server, "outputs": outs, "wall_s": wall,
            "p50_s": p50, "p99_s": p99}


if __name__ == "__main__":
    main()
