"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which fails the run (exit 1) if it fails:

1. print the card's name and power limit; build the CUDA kernels from
   the sources in this checkout (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card at
   Llama-3-8B widths, bf16 (atol = rtol = 2e-2) and fp32 (2e-5);
3. the whole model at full llama3-8b width, 2 layers: kernel path
   against plain path, prefill and one decode step (atol 0.3, rtol 0.05);
4. the serve driver (``repro_torch.launch.serve.main``) at full
   llama3-8b, 32 layers, prompt 2048, 8 requests x 16 tokens, 2 replicas:
   durable completions, prefetches, exact kernel launch counts, and the
   first request replayed through the plain path;
5. one replica traced with torch.profiler: host wall time of prefill
   and of a decode step, device time, device idle share, top device ops;
6. each kernel timed with CUDA events at the serve shapes, beside its
   bound, its plain version and one PyTorch library call (a yardstick
   only; the port never calls it).

Prints a JSON line of the kernels, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside a checkout of the repository, it exits 2 and prints
no result. Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
ARCH = "llama3-8b"
SERVE_ARGS = ["--arch", ARCH, "--prompt-len", "2048", "--requests", "8",
              "--gen", "16", "--replicas", "2"]
PROMPT, REQUESTS, GEN, REPLICAS = 2048, 8, 16, 2
TOL = {"bfloat16": 2e-2, "float32": 2e-5}

FLASH = {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:92"}
DECODE = {"name": "flash_decode", "route": "cuda",
          "source": "src/repro_torch/kernels/decode_attention/csrc/"
                    "decode_attention.cu",
          "replaces": "src/repro/kernels/decode_attention/kernel.py:72"}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.err = {FLASH["name"]: 0.0, DECODE["name"]: 0.0}
        self.launches = {}
        self.timing = {}
        self.server = None

    # ------------------------------------------------------------ helpers
    def gen(self, seed):
        return self.torch.Generator(device=self.dev).manual_seed(seed)

    def randn(self, g, shape, dtype):
        return self.torch.randn(shape, generator=g, device=self.dev).to(dtype)

    def ring_slot_pos(self, W, fill, B):
        slots = self.torch.arange(W, device=self.dev)
        if fill <= W:
            sp = self.torch.where(slots < fill, slots, -1)
        else:
            sp = (fill - 1) - ((fill - 1 - slots) % W)
        return sp.to(self.torch.int32).expand(B, W).contiguous()

    def compare(self, kernel, label, out, ref, tol):
        self.torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        bad = (diff > tol + tol * ref.float().abs()).sum().item()
        self.err[kernel] = max(self.err[kernel], err)
        print(f"  {kernel:15s} {label:48s} max_abs_err={err:.3e} "
              f"tol={tol:g} {'ok' if bad == 0 else f'FAIL ({bad} elems)'}")
        if bad:
            raise AssertionError(f"{kernel} {label} disagrees with its plain "
                                 f"version")

    def time_ms(self, fn, sets, iters):
        """Mean device time of one call, cycling over input sets larger
        than the L2 cache, after a warmup."""
        torch = self.torch
        for s in sets:
            fn(s)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(sets[i % len(sets)])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # ------------------------------------------------------------- phases
    def phase_build(self):
        from repro_torch.kernels import _build
        t0 = time.monotonic()
        libs = _build.build()
        print(f"built {', '.join(p.name for p in libs.values())} with "
              f"{_build.nvcc()} {' '.join(_build.NVCC_FLAGS)} in "
              f"{time.monotonic() - t0:.1f}s")

    def phase_kernels(self):
        torch = self.torch
        from repro_torch.kernels.decode_attention import (decode_mha,
                                                          decode_mha_ref)
        from repro_torch.kernels.flash_attention import mha, mha_ref
        H, K, hd = 32, 8, 128
        for dname, tol in TOL.items():
            dtype = getattr(torch, dname)
            g = self.gen(1)
            for B, S, causal, window, what in [
                    (1, 2048, True, 0, "causal S=2048"),
                    (1, 1000, True, 0, "ragged causal S=1000"),
                    (1, 2048, True, 96, "causal window=96 S=2048"),
                    (1, 1024, False, 0, "bidirectional S=1024")]:
                q = self.randn(g, (B, S, H, hd), dtype)
                k, v = (self.randn(g, (B, S, K, hd), dtype) for _ in "kv")
                out = mha(q, k, v, causal=causal, window=window)
                ref = mha_ref(q, k, v, causal=causal, window=window)
                self.compare(FLASH["name"], f"{dname} B={B} {what}", out,
                             ref, tol)
            for B, W, fill, pos, window, what in [
                    (8, 2048, 2048, 2048, 0, "full W=2048"),
                    (8, 2048, 700, 700, 0, "partial fill 700/2048"),
                    (8, 2048, 5000, 5000, 1024, "wrapped ring window=1024"),
                    (1, 2048, 2049, 2048, 0, "serve first wrap W=2048")]:
                q = self.randn(g, (B, 1, H, hd), dtype)
                kc, vc = (self.randn(g, (B, W, K, hd), dtype) for _ in "kv")
                sp = self.ring_slot_pos(W, fill, B)
                p = torch.full((B,), pos, dtype=torch.int32, device=self.dev)
                out = decode_mha(q, kc, vc, sp, p, window=window)
                ref = decode_mha_ref(q, kc, vc, sp, p, window=window)
                self.compare(DECODE["name"], f"{dname} B={B} {what}", out,
                             ref, tol)

    def phase_model(self):
        torch = self.torch
        from repro_torch.configs import registry
        from repro_torch.models import Model
        cfg = registry.get(ARCH).replace(num_layers=2)
        model = Model(cfg)
        params = model.init_params(self.gen(0))
        toks = torch.randint(0, cfg.vocab_size, (1, PROMPT), dtype=torch.int32,
                             device=self.dev, generator=self.gen(2))
        out = {}
        for plain in (False, True):
            logits, cache = model.prefill(params, {"tokens": toks},
                                          plain=plain)
            step, _ = model.decode_step(params, cache, toks[:, :1],
                                        plain=plain)
            out[plain] = (logits, step)
        for what, a, b in zip(("prefill logits", "decode logits"),
                              out[False], out[True]):
            err = (a - b).abs().max().item()
            ok = torch.allclose(a, b, atol=0.3, rtol=0.05)
            print(f"  {cfg.name} x2 layers {what}: kernel vs plain "
                  f"max_abs_err={err:.3e} (atol 0.3, rtol 0.05) "
                  f"{'ok' if ok else 'FAIL'}")
            if not (ok and torch.isfinite(a).all()):
                raise AssertionError(f"{what}: kernel path disagrees")

    def phase_serve(self):
        torch = self.torch
        from repro_torch.kernels.decode_attention import ops as decode_ops
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.launch import serve
        torch.cuda.reset_peak_memory_stats()
        flash_ops.launches = 0
        decode_ops.launches = 0
        result = serve.main(SERVE_ARGS)
        self.launches = {FLASH["name"]: flash_ops.launches,
                         DECODE["name"]: decode_ops.launches}
        peak = torch.cuda.max_memory_allocated()
        server, outs = result["server"], result["outputs"]
        cfg = server.cfg
        print(f"  serve p50={result['p50_s'] * 1e3:.1f}ms "
              f"p99={result['p99_s'] * 1e3:.1f}ms "
              f"tok/s={REQUESTS * GEN / result['wall_s']:.2f} "
              f"wall={result['wall_s']:.3f}s "
              f"max_memory_allocated={peak / 2**30:.2f}GiB "
              f"launches={self.launches}")
        want = {FLASH["name"]: cfg.num_layers * (REQUESTS + REPLICAS),
                DECODE["name"]: cfg.num_layers * (REQUESTS * GEN + REPLICAS)}
        if self.launches != want:
            raise AssertionError(f"launch counts {self.launches} != {want}")
        if cfg.num_layers != 32 or cfg.d_model != 4096:
            raise AssertionError("the serve run was not full llama3-8b")
        for i, o in enumerate(outs):
            body = server.store.get("out", f"req-{i}-completion")
            if len(body) != 4 * GEN or body != o.tobytes():
                raise AssertionError(f"req-{i}: completion not durable")
            if not ((o >= 0) & (o < cfg.vocab_size)).all():
                raise AssertionError(f"req-{i}: token out of range")
        if server.backend.stats["prefetches"] < REQUESTS:
            raise AssertionError("prompts were not prefetched")
        self.replay_plain(server, outs[0])
        self.server = server

    def replay_plain(self, server, completion):
        """Request 0 through the plain path: its greedy tokens agree with
        the kernel path's wherever the top-2 margin exceeds 0.3."""
        torch = self.torch
        import numpy as np
        inst = server.instances[0]
        prompt = np.frombuffer(server.store.get("prompts", "req-0"), np.int32)
        toks = torch.from_numpy(prompt.copy())[None].to(self.dev)
        logits, cache = inst.model.prefill(inst.params, {"tokens": toks},
                                           plain=True)
        compared = 0
        for i, tok in enumerate(completion):
            row = logits[0, -1]
            top2 = row.topk(2).values
            if not torch.isfinite(row).all():
                raise AssertionError("non-finite logits on the plain path")
            if float(top2[0] - top2[1]) > 0.3:
                compared += 1
                if int(row.argmax()) != int(tok):
                    raise AssertionError(f"req-0 token {i}: kernel path "
                                         f"{int(tok)}, plain path "
                                         f"{int(row.argmax())}")
            step = torch.tensor([[int(tok)]], dtype=torch.int32,
                                device=self.dev)
            logits, cache = inst.model.decode_step(inst.params, cache, step,
                                                   plain=True)
        print(f"  req-0 replayed on the plain path: {compared}/{len(completion)}"
              f" tokens past the 0.3 margin, all equal")

    def phase_trace(self):
        """Where a request's time goes on one replica: host wall time of
        prefill and of a decode step (synchronised), and the kernel time
        torch.profiler sees in each; the rest of the wall time the
        device sits idle, waiting on the host."""
        torch = self.torch
        import numpy as np
        server, self.server = self.server, None
        inst = server.instances[0]
        prompt = np.frombuffer(server.store.get("prompts", "req-0"), np.int32)
        toks = torch.from_numpy(prompt.copy())[None].to(self.dev)
        steps = 8
        state = {}

        def prefill():
            state["logits"], state["cache"] = inst.model.prefill(
                inst.params, {"tokens": toks})

        def decode():
            for _ in range(steps):
                tok = state["logits"][:, -1:].argmax(dim=-1).to(torch.int32)
                state["logits"], state["cache"] = inst.model.decode_step(
                    inst.params, state["cache"], tok)

        for what, fn, n in (("prefill", prefill, 1), ("decode step", decode,
                                                       steps)):
            prefill()
            fn()                                     # warm
            prefill()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
            prefill()
            dev_ms, launches, top = self.profile(fn)
            dev_ms, launches = dev_ms / n, launches / n
            print(f"  one replica, prompt {PROMPT}, {what}: wall "
                  f"{wall_ms:.2f} ms, kernel time {dev_ms:.2f} ms in "
                  f"{launches:.0f} kernels, device idle share "
                  f"{1 - dev_ms / wall_ms:.3f}")
            for e in top[:8]:
                print(f"    {e.self_device_time_total / 1e3 / n:8.3f} ms "
                      f"{e.count / n:6.0f}x  {e.key[:80]}")

    def profile(self, fn):
        """Total kernel time (ms) and kernel count of fn() under
        torch.profiler, and the kernel rows by time."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device-side rows only (CPU operators also carry the time of the
        # kernels they launch); "Command Buffer Full" is a launch-queue
        # stall marker, not a kernel
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.key != "Command Buffer Full"]
        rows.sort(key=lambda e: -e.self_device_time_total)
        return (sum(e.self_device_time_total for e in rows) / 1e3,
                sum(e.count for e in rows), rows)

    def phase_timing(self):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.decode_attention import (decode_mha,
                                                          decode_mha_ref)
        from repro_torch.kernels.flash_attention import mha, mha_ref
        dt, H, K, hd = torch.bfloat16, 32, 8, 128
        g = self.gen(3)

        def bound(nbytes, flops):
            tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
            return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")

        # prefill at the serve shape: B=1, S=2048, causal
        B, S = 1, PROMPT
        sets = []
        for _ in range(4):
            q = self.randn(g, (B, S, H, hd), dt)
            sets.append((q, *(self.randn(g, (B, S, K, hd), dt) for _ in "kv")))
        lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                    for s in sets]
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * K * hd)
        flops = 4 * B * H * hd * S * (S + 1) // 2
        bms, by = bound(nbytes, flops)
        row = {
            "ms": self.time_ms(lambda s: mha(*s, causal=True), sets, 20),
            "plain_ms": self.time_ms(lambda s: mha_ref(*s, causal=True),
                                     sets, 5),
            "library_ms": self.time_ms(
                lambda s: F.scaled_dot_product_attention(
                    *s, is_causal=True, enable_gqa=True), lib_sets, 20),
            "bound_ms": bms, "bound_by": by}
        self.timing[FLASH["name"]] = row
        self.report("flash_attention bf16 B=1 S=2048 causal", row)

        # decode at the serve shape (B=1) and the calibrated one (B=8)
        for B, n in ((1, 16), (8, 3)):
            W, pos = PROMPT, PROMPT
            sets, lib_sets = [], []
            sp = self.ring_slot_pos(W, W + 1, B)
            p = torch.full((B,), pos, dtype=torch.int32, device=self.dev)
            valid = (sp >= 0) & (sp <= p[:, None])
            for _ in range(n):
                q = self.randn(g, (B, 1, H, hd), dt)
                kc, vc = (self.randn(g, (B, W, K, hd), dt) for _ in "kv")
                sets.append((q, kc, vc, sp, p))
                lib_sets.append((q.transpose(1, 2).contiguous(),
                                 kc.transpose(1, 2).contiguous(),
                                 vc.transpose(1, 2).contiguous(),
                                 valid[:, None, None, :]))
            nbytes = (2 * (2 * B * H * hd + 2 * B * W * K * hd)
                      + 4 * (B * W + B))
            flops = 4 * H * hd * int(valid.sum())
            bms, by = bound(nbytes, flops)
            row = {
                "ms": self.time_ms(lambda s: decode_mha(*s), sets, 200),
                "plain_ms": self.time_ms(lambda s: decode_mha_ref(*s),
                                         sets, 50),
                "library_ms": self.time_ms(
                    lambda s: F.scaled_dot_product_attention(
                        s[0], s[1], s[2], attn_mask=s[3], enable_gqa=True),
                    lib_sets, 200),
                "bound_ms": bms, "bound_by": by}
            if B == 1:
                self.timing[DECODE["name"]] = row
            self.report(f"flash_decode bf16 B={B} W=2048", row)

    def report(self, label, row):
        print(f"  {label}: kernel {row['ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), share of bound "
              f"{row['bound_ms'] / row['ms']:.3f}, plain {row['plain_ms']:.4f}"
              f" ms, library {row['library_ms']:.4f} ms")

    def kernels_line(self):
        rows = []
        for meta in (FLASH, DECODE):
            name = meta["name"]
            rows.append({**meta, "launches": self.launches[name],
                         "max_abs_err": self.err[name], **self.timing[name]})
        return json.dumps({"kernels": rows})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    smoke = Smoke(torch)
    failed = []
    for name, fn in (("build", smoke.phase_build),
                     ("kernels vs plain", smoke.phase_kernels),
                     ("model kernel vs plain", smoke.phase_model),
                     ("serve llama3-8b", smoke.phase_serve),
                     ("trace one replica", smoke.phase_trace),
                     ("timing", smoke.phase_timing)):
        print(f"== {name}", flush=True)
        t0 = time.monotonic()
        try:
            fn()
        except Exception:                   # noqa: BLE001 — reported below
            traceback.print_exc()
            failed.append(name)
            if name == "build":
                break
        torch.cuda.empty_cache()
        print(f"   {name}: {time.monotonic() - t0:.1f}s", flush=True)
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(smoke.kernels_line())
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
