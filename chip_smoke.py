"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which fails the run (exit 1) if it fails:

1. print the card's name and power limit; build the CUDA kernels from
   the sources in this checkout (one nvcc per source, in parallel) and
   print the build time;
2. hold each kernel against its plain PyTorch version on the card:
   the attention kernels at Llama-3-8B, Hymba-1.5B and Qwen3-30B-A3B
   widths (qwen3: 32 q heads over 4 kv heads, G 8, hd 128; prefill B 1
   S 2048 causal, decode B 1 and 8 after the ring's first wrap and at a
   partial fill; prefill also at the MLServe shapes, llama's heads at B 8
   x S 2048 and B 32 x S 512), bf16 (atol = rtol = 2e-2) and fp32 (2e-5), each check
   naming the body that ran (prefill: wgmma or SIMT; decode: mma or
   SIMT, and its cluster size), q/k/v as views of a fused projection, and
   a misaligned view that must raise; the selective scan at
   Falcon-Mamba-7B and Hymba-1.5B widths, fp32 (1e-4), with the model's
   long-memory dt and A, every states-per-thread R forced, N = 8, layouts
   that are not 16-byte aligned and S = 0, 1 and 5, each check naming the
   R that ran (``[R r]``);
3. each served model at full width, 2 layers: kernel path against plain
   path, prefill and one decode step (atol 0.3, rtol 0.05);
4. the serve driver (``repro_torch.launch.serve.main``) for each ported
   arch at full published width (llama3-8b 32 layers, falcon-mamba-7b
   64, hymba-1.5b 32, qwen3-moe-30b-a3b 48 with 128 experts top-8,
   30.53e9 parameters), prompt 2048, 8 requests x 16 tokens, 2 replicas
   sharing one params copy: durable completions, prefetches, exact
   kernel launch counts (every count set to 0 just before the path and
   read just after), the first request replayed through the plain path,
   peak device memory under 1.5x the params (one copy); for the MoE, one
   decode token through ``moe_dense`` allocating less than an eighth of
   one (E, D, F) expert weight leaf (the weights are read in place,
   never copied); each server is freed before the next path starts;
5. one replica of each served arch traced with torch.profiler: host
   wall time of prefill and of a decode step, device time, device idle
   share, top device ops;
   then the MLServe serving cores (``repro_torch.models.serving``): the
   scenarios LLM-COLD, LLM-PREFILL and LLM-DECODE (llama3-8b) and EMB
   (granite-8b), from seed payloads built once per role,
   through the kernels and then ``plain=True`` on the same bytes: at tiny
   scale (the SMOKE configs, hd 32) with every payload and output length
   equal to ``calibration.json``, and at full published width (llama3-8b
   32 layers, 16.06 GB of params in one payload or 4 shards, a 2.15 GB
   decode state of 8 x 2048 slots; granite-8b 36 layers, tied head, B 32
   x S 512) with every length equal to ``role_sizes(cfg, 1)``; kernel
   against plain (logits and float cache leaves atol 0.3, rtol 0.05,
   integer leaves exactly, greedy tokens wherever the top-2 margin
   exceeds 0.3), exact launch counts, and per scenario the payload bytes,
   the wall time of decoding the payloads onto the card, of the forward
   and of encoding the output, peak device memory and peak host RSS;
6. each kernel timed at the serve shapes (the attention kernels at
   llama3-8b's, hymba-1.5b's and qwen3-moe-30b-a3b's, prefill also at
   the MLServe shapes B 8 x S 2048 and granite-8b's B 32 x S 512),
   beside its bound,
   its plain version and, where there is one, one PyTorch library call (a
   yardstick only; the port never calls it). Kernel and library times
   are device times: CUDA events around the replay of a CUDA graph of
   many calls, so the host's launch overhead (tens of microseconds per
   call from Python, more than a decode kernel takes) does not stand in
   for the kernel's time; the eager times are printed beside them. The
   plain versions are timed eagerly. The scan is also timed at every R
   of ``SCAN_SWEEP`` beside the R its rule picks.

Prints a JSON line of the kernels, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside a checkout of the repository, it exits 2 and prints
no result. Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import gc
import json
import resource
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
ARCHS = ("llama3-8b", "falcon-mamba-7b", "hymba-1.5b", "qwen3-moe-30b-a3b")
PROMPT, REQUESTS, GEN, REPLICAS = 2048, 8, 16, 2
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
SCAN_TOL = 1e-4                 # f32, as tests/test_kernels.py::TestSsmScan
SCAN_SWEEP = (2, 4, 8)          # states per thread timed in phase 6
#: the MLServe scenarios driven on the card, by role
MLSERVE = {"llm": ("LLM-COLD", "LLM-PREFILL", "LLM-DECODE"), "emb": ("EMB",)}
MLSERVE_SCALES = ("tiny", "full")
#: a scenario's durable output, as its key in role_sizes / calibration
MLSERVE_OUT = {"LLM-COLD": "cold_out_bytes", "LLM-PREFILL": "kv_prefill_bytes",
               "LLM-DECODE": "kv_out_bytes", "EMB": "emb_bytes"}

FLASH = {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:92"}
DECODE = {"name": "flash_decode", "route": "cuda",
          "source": "src/repro_torch/kernels/decode_attention/csrc/"
                    "decode_attention.cu",
          "replaces": "src/repro/kernels/decode_attention/kernel.py:72"}
SCAN = {"name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:67"}
KERNELS = (FLASH, DECODE, SCAN)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.err = {meta["name"]: 0.0 for meta in KERNELS}
        self.launches = {}              # arch -> kernel -> launches
        self.timing = {}
        self.also = {}                  # kernel -> timings at other shapes

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
        err = diff.max().item() if diff.numel() else 0.0
        bad = (diff > tol + tol * ref.float().abs()).sum().item()
        self.err[kernel] = max(self.err[kernel], err)
        print(f"  {kernel:15s} {label:48s} max_abs_err={err:.3e} "
              f"tol={tol:g} {'ok' if bad == 0 else f'FAIL ({bad} elems)'}")
        if bad:
            raise AssertionError(f"{kernel} {label} disagrees with its plain "
                                 f"version")

    def time_ms(self, fn, sets, iters, graph=False):
        """Mean time of one call, cycling over input sets larger than the
        L2 cache, after a warmup: between CUDA events around eager calls,
        or with ``graph`` around the replay of a CUDA graph of the calls
        (device time, without the host's launch gaps)."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for s in sets:
                fn(s)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for i in range(iters):
                    fn(sets[i % len(sets)])
            g.replay()
            torch.cuda.synchronize()
            start.record()
            g.replay()
            end.record()
        else:
            start.record()
            for i in range(iters):
                fn(sets[i % len(sets)])
            end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def time_row(self, kernel, plain, library, sets, lib_sets, iters,
                 plain_iters):
        """The kernel's and the library call's device times (graph
        replay) and eager times, and the plain version's eager time."""
        row = {"ms": self.time_ms(kernel, sets, iters, graph=True),
               "plain_ms": self.time_ms(plain, sets, plain_iters),
               "library_ms": None,
               "eager_ms": self.time_ms(kernel, sets, iters)}
        if library is not None:
            row["library_ms"] = self.time_ms(library, lib_sets, iters,
                                             graph=True)
            row["library_eager_ms"] = self.time_ms(library, lib_sets, iters)
        return row

    # ------------------------------------------------------------- phases
    def phase_build(self):
        from repro_torch.kernels import _build
        t0 = time.monotonic()
        libs = _build.build()
        print(f"built {', '.join(p.name for p in libs.values())} with "
              f"{_build.nvcc()} {' '.join(_build.NVCC_FLAGS)}; kernel build "
              f"time {time.monotonic() - t0:.1f}s")

    def phase_kernels(self):
        self.check_attention()
        self.check_scan()

    def check_attention(self):
        torch = self.torch
        from repro_torch.kernels.decode_attention import (decode_mha,
                                                          decode_mha_ref)
        from repro_torch.kernels.decode_attention import ops as decode_ops
        from repro_torch.kernels.flash_attention import mha, mha_ref
        from repro_torch.kernels.flash_attention import ops as flash_ops
        llama, hymba = (32, 8, 128, ""), (25, 5, 64, " hymba H25/K5/hd64")
        qwen3 = (32, 4, 128, " qwen3 H32/K4/hd128")
        small = (8, 4, 32, " H8/K4/hd32")
        for dname, tol in TOL.items():
            dtype = getattr(torch, dname)
            g = self.gen(1)
            for (H, K, hd, arch), B, S, causal, window, what in [
                    (llama, 1, 2048, True, 0, "causal S=2048"),
                    (llama, 1, 1000, True, 0, "ragged causal S=1000"),
                    (llama, 1, 2048, True, 96, "causal window=96 S=2048"),
                    (llama, 1, 1024, False, 0, "bidirectional S=1024"),
                    (hymba, 1, 2048, True, 2048, "window=2048 S=2048"),
                    (hymba, 1, 3000, True, 2048, "window=2048 S=3000"),
                    (qwen3, 1, 2048, True, 0, "causal S=2048"),
                    (small, 2, 512, True, 0, "causal S=512"),
                    # the MLServe prefills: the LLM-DECODE seed (B 8), and
                    # EMB (granite-8b has llama's heads)
                    (llama, 8, 2048, True, 0, "causal S=2048 (decode seed)"),
                    (llama, 32, 512, True, 0, "causal S=512 (granite EMB)")]:
                q = self.randn(g, (B, S, H, hd), dtype)
                k, v = (self.randn(g, (B, S, K, hd), dtype) for _ in "kv")
                out = mha(q, k, v, causal=causal, window=window)
                ref = mha_ref(q, k, v, causal=causal, window=window)
                self.compare(FLASH["name"], f"{dname} B={B} {what}{arch} "
                             f"[{flash_ops.body(dtype, hd)}]", out, ref, tol)
            # q, k, v as head slices of one fused (B, S, H + 2K, hd) tensor
            H, K, hd, _ = llama
            qkv = self.randn(g, (1, 1000, H + 2 * K, hd), dtype)
            q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
            self.compare(FLASH["name"], f"{dname} B=1 views of a fused qkv "
                         f"S=1000 [{flash_ops.body(dtype, hd)}]",
                         mha(q, k, v), mha_ref(q, k, v), tol)
            for (H, K, hd, arch), B, W, fill, pos, window, what in [
                    (llama, 8, 2048, 2048, 2048, 0, "full W=2048"),
                    (llama, 8, 2048, 700, 700, 0, "partial fill 700/2048"),
                    (llama, 1, 2048, 100, 100, 0,
                     "fill 100/2048, whole splits empty"),
                    (llama, 8, 2048, 5000, 5000, 1024,
                     "wrapped ring window=1024"),
                    (llama, 1, 2048, 2049, 2048, 0, "serve first wrap W=2048"),
                    (llama, 2, 2048, 0, 0, 0, "no valid slot: mean of V"),
                    (hymba, 1, 2048, 2049, 2048, 2048,
                     "serve first wrap W=2048"),
                    (hymba, 8, 2048, 900, 900, 2048, "partial fill 900/2048"),
                    (hymba, 1, 1000, 1000, 1000, 0,
                     "W=1000, not a multiple of C"),
                    (qwen3, 1, 2048, 2049, 2048, 0, "serve first wrap W=2048"),
                    (qwen3, 8, 2048, 2049, 2048, 0, "serve first wrap W=2048"),
                    (qwen3, 8, 2048, 900, 900, 0, "partial fill 900/2048")]:
                q = self.randn(g, (B, 1, H, hd), dtype)
                kc, vc = (self.randn(g, (B, W, K, hd), dtype) for _ in "kv")
                sp = self.ring_slot_pos(W, fill, B)
                p = torch.full((B,), pos, dtype=torch.int32, device=self.dev)
                out = decode_mha(q, kc, vc, sp, p, window=window)
                ref = decode_mha_ref(q, kc, vc, sp, p, window=window)
                self.compare(DECODE["name"], f"{dname} B={B} {what}{arch} "
                             f"[{decode_ops.body(dtype)}, cluster "
                             f"{decode_ops.cluster_size(W, B, K)}]", out,
                             ref, tol)
        # what TMA cannot describe raises, and nothing is launched
        wide = self.randn(self.gen(7), (1, 256, 4, 72), torch.bfloat16)
        before = flash_ops.launches
        try:
            mha(wide[..., 1:65], wide[..., 1:65], wide[..., 1:65])
        except ValueError as e:
            print(f"  {FLASH['name']:15s} misaligned bf16 view raises: {e}")
        else:
            raise AssertionError("a misaligned view did not raise")
        if flash_ops.launches != before:
            raise AssertionError("a refused call counted a launch")

    def scan_inputs(self, g, B, S, di, N=16, xdtype=None, h0_scale=0.0,
                    proj_rank=0, long_memory=False):
        """dt, xr, B, C, A, h0 as the model path gives them: dt from a
        softplus, A negative; with ``long_memory`` the model's own ranges,
        dt = softplus(z - 4.6) ~ 0.01 and A = -(1..N) (`init_mamba`), so
        the state carries over hundreds of steps; with ``proj_rank`` B and
        C are column slices of one (B, S, R + 2N) projection, as in
        `mamba_layer`."""
        torch = self.torch
        f32 = torch.float32
        z = self.randn(g, (B, S, di), f32)
        if long_memory:
            dt = torch.nn.functional.softplus(z - 4.6)
        else:
            dt = torch.nn.functional.softplus(z) * 0.1
        xr = self.randn(g, (B, S, di), xdtype or f32)
        proj = self.randn(g, (B, S, proj_rank + 2 * N), f32)
        Bm, Cm = proj[..., proj_rank:proj_rank + N], proj[..., proj_rank + N:]
        if long_memory:
            A = -torch.arange(1, N + 1, device=self.dev, dtype=f32).expand(
                di, N).contiguous()
        else:
            A = -torch.exp(self.randn(g, (di, N), f32) * 0.5)
        h0 = self.randn(g, (B, di, N), f32) * h0_scale
        return dt, xr, Bm, Cm, A, h0

    def check_scan(self):
        """Each check names the states per thread R that ran: "[R r]" for
        the kernel's own choice, "[R r forced]" where the check sets it."""
        torch = self.torch
        from repro_torch.kernels.ssm_scan import ops as scan_ops
        from repro_torch.kernels.ssm_scan import ssm_scan_ref
        name = SCAN["name"]
        g = self.gen(4)

        def check(what, ins, R=0):
            B, _, di = ins[0].shape
            tag = (f"[R {R} forced]" if R else
                   f"[R {scan_ops.states_per_thread(B, di, ins[4].shape[1])}]")
            y, h = scan_ops.selective_scan_at(*ins, R=R)
            y_ref, h_ref = ssm_scan_ref(*ins)
            self.compare(name, f"y {what} {tag}", y, y_ref, SCAN_TOL)
            self.compare(name, f"h_final {what} {tag}", h, h_ref, SCAN_TOL)
            return y, h

        for B, S, di, xdtype, h0_scale, rank, what in [
                (1, 2048, 8192, None, 0.0, 0, "falcon-mamba B=1 S=2048 di=8192"),
                (1, 1000, 8192, None, 0.0, 0, "ragged S=1000 di=8192"),
                (2, 512, 8192, None, 0.5, 0, "B=2 nonzero h0 di=8192"),
                (1, 2048, 8192, torch.bfloat16, 0.0, 256,
                 "xr bf16, B/C slices of proj di=8192"),
                (1, 2048, 3200, None, 0.0, 0, "hymba B=1 S=2048 di=3200"),
                (1, 2048, 3200, torch.bfloat16, 0.1, 200,
                 "hymba xr bf16, B/C slices di=3200")]:
            check(what, self.scan_inputs(g, B, S, di, xdtype=xdtype,
                                         h0_scale=h0_scale, proj_rank=rank))
        # the model's long memory (dt ~ 0.01, A = -(1..16)) at both serve
        # widths, and with every R forced at Hymba's
        for di, rank, arch in ((8192, 256, "falcon-mamba"), (3200, 100, "hymba")):
            ins = self.scan_inputs(g, 1, 2048, di, xdtype=torch.bfloat16,
                                   h0_scale=1.0, proj_rank=rank,
                                   long_memory=True)
            check(f"{arch} long memory di={di}", ins)
        for R in scan_ops.PER_THREAD:
            check("hymba long memory di=3200", ins, R=R)
        check("N=8 B=2 S=1000 di=512", self.scan_inputs(
            g, 2, 1000, 512, N=8, xdtype=torch.bfloat16, h0_scale=1.0,
            proj_rank=8, long_memory=True))
        # layouts that are not 16-byte aligned take plain loads: an odd di,
        # and xr a view at an odd offset
        check("odd di=3201 xr bf16", self.scan_inputs(
            g, 1, 2048, 3201, xdtype=torch.bfloat16, h0_scale=1.0,
            long_memory=True))
        dt, _, Bm, Cm, A, h0 = self.scan_inputs(g, 1, 2048, 3200, h0_scale=1.0,
                                                long_memory=True)
        for xdtype in (torch.float32, torch.bfloat16):
            xr = self.randn(g, (1, 2048, 3201), xdtype)[..., 1:]
            check(f"xr {str(xdtype)[6:]} view at offset 1 di=3200",
                  (dt, xr, Bm, Cm, A, h0))
        for S in (0, 1, 5):
            check(f"S={S} di=3200", self.scan_inputs(
                g, 1, S, 3200, xdtype=torch.bfloat16, h0_scale=1.0,
                long_memory=True))
        # state continuation: two halves with the carried state = the whole
        ins = self.scan_inputs(g, 1, 2048, 8192, h0_scale=0.1)
        y, h = scan_ops.selective_scan(*ins)
        dt, xr, Bm, Cm, A, h0 = ins
        y1, h1 = scan_ops.selective_scan(dt[:, :1000], xr[:, :1000],
                                         Bm[:, :1000], Cm[:, :1000], A, h0)
        y2, h2 = scan_ops.selective_scan(dt[:, 1000:], xr[:, 1000:],
                                         Bm[:, 1000:], Cm[:, 1000:], A, h1)
        self.compare(name, "y halves 1000 + 1048 vs whole",
                     torch.cat([y1, y2], dim=1), y, SCAN_TOL)
        self.compare(name, "h_final halves vs whole", h2, h, SCAN_TOL)

    def phase_model(self):
        for arch in ARCHS:
            self.check_model(arch)

    def check_model(self, arch):
        torch = self.torch
        from repro_torch.configs import registry
        from repro_torch.models import Model
        cfg = registry.get(arch).replace(num_layers=2)
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
                raise AssertionError(f"{arch} {what}: kernel path disagrees")

    def counters(self):
        from repro_torch.kernels.decode_attention import ops as decode_ops
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.ssm_scan import ops as scan_ops
        return {FLASH["name"]: flash_ops, DECODE["name"]: decode_ops,
                SCAN["name"]: scan_ops}

    def serve_path(self, arch):
        """Serve ``arch`` at full width, check the run, trace one replica,
        and free the server before the next path."""
        torch = self.torch
        from repro_torch.configs import registry
        from repro_torch.launch import serve
        from repro_torch.models import serialize
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  before {arch}: {torch.cuda.memory_allocated() / 2**30:.2f}"
              f" GiB allocated on the card")
        torch.cuda.reset_peak_memory_stats()
        counters = self.counters()
        for mod in counters.values():
            mod.launches = 0
        result = serve.main(["--arch", arch, "--prompt-len", str(PROMPT),
                             "--requests", str(REQUESTS), "--gen", str(GEN),
                             "--replicas", str(REPLICAS)])
        launches = {name: mod.launches for name, mod in counters.items()}
        self.launches[arch] = launches
        peak = torch.cuda.max_memory_allocated()
        server, outs = result["server"], result["outputs"]
        cfg = server.cfg
        print(f"  {arch} serve p50={result['p50_s'] * 1e3:.1f}ms "
              f"p99={result['p99_s'] * 1e3:.1f}ms "
              f"tok/s={REQUESTS * GEN / result['wall_s']:.2f} "
              f"wall={result['wall_s']:.3f}s "
              f"max_memory_allocated={peak / 2**30:.2f}GiB "
              f"launches={launches}")
        if cfg != registry.get(arch):
            raise AssertionError(f"the serve run was not full {arch}")
        params = server.instances[0].params
        if any(inst.params is not params for inst in server.instances):
            raise AssertionError("the replicas do not share one params copy")
        leaves = serialize.leaves(params)
        n_params = sum(x.numel() for x in leaves)
        param_bytes = serialize.tree_nbytes(params)
        print(f"  {arch}: {cfg.num_layers} layers, {n_params} parameters "
              f"({param_bytes / 1e9:.2f} GB) on {leaves[0].device}; peak "
              f"{peak / 1e9:.2f} GB ({nvidia_smi()})")
        if n_params != cfg.param_count() or leaves[0].device.type != "cuda":
            raise AssertionError(f"{arch}: the params on the card are not "
                                 f"the full model")
        if peak > 1.5 * param_bytes:
            raise AssertionError(f"{arch}: peak {peak} bytes for "
                                 f"{param_bytes} bytes of params: more than "
                                 f"one params copy?")
        del params, leaves
        L = cfg.num_layers
        attn = cfg.family in ("dense", "moe", "hybrid")
        ssm = cfg.family in ("ssm", "hybrid")
        want = {FLASH["name"]: L * (REQUESTS + REPLICAS) if attn else 0,
                DECODE["name"]: (L * (REQUESTS * GEN + REPLICAS) if attn
                                 else 0),
                SCAN["name"]: L * (REQUESTS + REPLICAS) if ssm else 0}
        if launches != want:
            raise AssertionError(f"{arch} launch counts {launches} != {want}")
        for i, o in enumerate(outs):
            body = server.store.get("out", f"req-{i}-completion")
            if len(body) != 4 * GEN or body != o.tobytes():
                raise AssertionError(f"req-{i}: completion not durable")
            if not ((o >= 0) & (o < cfg.vocab_size)).all():
                raise AssertionError(f"req-{i}: token out of range")
        if server.backend.stats["prefetches"] < REQUESTS:
            raise AssertionError("prompts were not prefetched")
        self.replay_plain(server, outs[0])
        if cfg.family == "moe":
            self.check_moe_decode_in_place(server)
        self.trace(server)
        del server, outs, result
        gc.collect()
        torch.cuda.empty_cache()

    def check_moe_decode_in_place(self, server):
        """One decode token through layer 0's `moe_dense` allocates far
        less than one (E, D, F) expert weight leaf: the expert products
        read the weights in place, no copy per step."""
        torch = self.torch
        from repro_torch.models import lm, moe
        cfg = server.cfg
        p = lm.layer_params(server.instances[0].params["layers"], 0)["moe"]
        x = torch.randn((1, 1, cfg.d_model), generator=self.gen(8),
                        device=self.dev).to(p["w_gate"].dtype)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        moe.moe_dense(p, cfg, x)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        weight = p["w_gate"].numel() * p["w_gate"].element_size()
        print(f"  moe_dense, one token, layer 0: {extra / 1e6:.3f} MB "
              f"allocated at its peak; its (E, D, F) w_gate is "
              f"{weight / 1e6:.1f} MB")
        if extra >= weight / 8:
            raise AssertionError("moe_dense copies the expert weights")

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

    def trace(self, server):
        """Where a request's time goes on one replica: host wall time of
        prefill and of a decode step (synchronised), and the kernel time
        torch.profiler sees in each; the rest of the wall time the
        device sits idle, waiting on the host."""
        torch = self.torch
        import numpy as np
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
            print(f"  {server.cfg.name}, one replica, prompt {PROMPT}, "
                  f"{what}: wall {wall_ms:.2f} ms, kernel time {dev_ms:.2f} ms in "
                  f"{launches:.0f} kernels, device idle share "
                  f"{1 - dev_ms / wall_ms:.3f}")
            for e in top[:12]:
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

    def phase_mlserve(self):
        """The MLServe cores at tiny scale, then at full width: each role's
        scenarios from their seed payloads, kernel path against plain path
        on the same bytes."""
        torch = self.torch
        from repro_torch.core import calibrate
        from repro_torch.models import serving
        for scale in MLSERVE_SCALES:
            for role, scenarios in MLSERVE.items():
                serving._bundle.cache_clear()
                gc.collect()
                torch.cuda.empty_cache()
                cfg = serving._bundle(role, scale)["cfg"]
                sizes = serving.role_sizes(cfg, devices=1)
                if scale == "tiny":
                    entry = calibrate.model_entry("tiny", role)
                    if sizes != {k: entry[k] for k in sizes}:
                        raise AssertionError(f"tiny {role}: role_sizes is not "
                                             f"calibration.json's entry")
                print(f"  before {scale} {role} ({cfg.name}, {cfg.num_layers} "
                      f"layers): {torch.cuda.memory_allocated() / 2**30:.2f} "
                      f"GiB allocated on the card")
                counters = self.counters()
                for mod in counters.values():
                    mod.launches = 0
                t0 = time.perf_counter()
                seeded = serving.seed_role(role, scenarios, scale=scale)
                print(f"  {scale} {role}: seed payloads of "
                      f"{', '.join(scenarios)} built in "
                      f"{time.perf_counter() - t0:.1f}s")
                if "LLM-DECODE" in scenarios:    # the decode state's prefill
                    self.launches[f"mlserve {scale} LLM-DECODE seed"] = {
                        name: mod.launches for name, mod in counters.items()}
                for scenario in scenarios:
                    self.mlserve_scenario(scenario, scale, cfg, sizes,
                                          seeded.pop(scenario))
                    gc.collect()
        serving._bundle.cache_clear()

    def mlserve_scenario(self, scenario, scale, cfg, sizes, payloads):
        """Run one scenario's core through the kernels and through the
        plain path on the same seed payloads, check the lengths, the
        launches and the agreement, and print where the time went."""
        from repro_torch.core.calibrate import SERVING_SHAPES, shard_bytes
        from repro_torch.models import serving
        kinds = serving.SCENARIO_INPUTS[scenario][1]
        path = f"mlserve {scale} {scenario}"
        shards = iter(shard_bytes(sizes["params_bytes"],
                                  kinds.count("weights") or 1))
        want = {"params": sizes["params_bytes"],
                "prompt": sizes["prompt_bytes"], "kv": sizes["kv_in_bytes"],
                "enc_tokens": sizes["enc_tokens_bytes"]}
        got = [len(p) for p in payloads]
        need = [next(shards) if k == "weights" else want[k] for k in kinds]
        if got != need:
            raise AssertionError(f"{path}: payloads of {got} bytes, "
                                 f"{need} expected")
        runs = {plain: self.run_core(scenario, payloads, scale, plain)
                for plain in (False, True)}
        L = cfg.num_layers
        expect = {FLASH["name"]: L if scenario != "LLM-DECODE" else 0,
                  DECODE["name"]: L if scenario in ("LLM-COLD", "LLM-DECODE")
                  else 0, SCAN["name"]: 0}
        self.launches[path] = runs[False]["launches"]
        if runs[False]["launches"] != expect:
            raise AssertionError(f"{path}: launches {runs[False]['launches']}"
                                 f" != {expect}")
        if any(runs[True]["launches"].values()):
            raise AssertionError(f"{path}: the plain path launched a kernel")
        for plain, run in runs.items():
            if len(run["body"]) != sizes[MLSERVE_OUT[scenario]]:
                raise AssertionError(f"{path}: output of {len(run['body'])} "
                                     f"bytes, {sizes[MLSERVE_OUT[scenario]]} "
                                     f"expected")
            t = run["timings"]
            total = sum(t.values())
            print(f"  {path} {'plain ' if plain else 'kernel'}: "
                  f"{sum(got)} B in, {len(run['body'])} B out; decode "
                  f"{t['decode'] * 1e3:.1f} ms, forward "
                  f"{t['forward'] * 1e3:.1f} ms, encode "
                  f"{t['encode'] * 1e3:.1f} ms (payload handling "
                  f"{(t['decode'] + t['encode']) / total:.3f} of "
                  f"{total * 1e3:.1f} ms); launches {run['launches']}; peak "
                  f"device {run['peak'] / 2**30:.2f} GiB, peak host RSS "
                  f"{run['rss'] / 2**30:.2f} GiB")
        # LLM-COLD steps its own prefill's cache, LLM-DECODE the seed's
        step = SERVING_SHAPES[scale]["prefill" if scenario == "LLM-COLD"
                                     else "decode"]
        bodies = ([f"prefill body [{self.flash_body(cfg)}]"]
                  if expect[FLASH["name"]] else []) + (
            [f"decode body [{self.decode_body(cfg, *step)}]"]
            if expect[DECODE["name"]] else [])
        print(f"  {path}: {', '.join(bodies)}")
        self.compare_core(path, scenario, scale, runs)
        if scenario == "LLM-DECODE" and scale == "full":
            self.codec_split(payloads[1], serving._bundle("llm", scale))

    def codec_split(self, kv, bundle):
        """Where the codec's time goes, on the 2.15 GB decode state: decode
        = the host copy of each leaf (``loads`` onto the CPU) + the copy
        onto the card; encode = the copy back + the host's bytes
        (``dumps`` of the tree on the CPU)."""
        torch = self.torch
        from repro_torch.models import serialize
        st = bundle["structs"]
        shapes = (st["decode_cache"], st["step_token"])

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        host, t_copy = timed(lambda: serialize.loads(shapes, kv, "cpu"))
        leaves = serialize.leaves(host)
        card, t_h2d = timed(lambda: [x.to(self.dev) for x in leaves])
        back, t_d2h = timed(lambda: [x.to("cpu") for x in card])
        body, t_bytes = timed(lambda: serialize.dumps(back))
        if body != kv:
            raise AssertionError("the decode state does not round-trip")
        gb = len(kv) / 1e9
        print(f"  codec on the {gb:.2f} GB decode state: decode = host copy "
              f"{t_copy * 1e3:.1f} ms ({gb / t_copy:.2f} GB/s) + onto the "
              f"card {t_h2d * 1e3:.1f} ms ({gb / t_h2d:.2f} GB/s); encode = "
              f"off the card {t_d2h * 1e3:.1f} ms ({gb / t_d2h:.2f} GB/s) + "
              f"host bytes {t_bytes * 1e3:.1f} ms ({gb / t_bytes:.2f} GB/s)")

    def flash_body(self, cfg):
        from repro_torch.kernels.flash_attention import ops as flash_ops
        return flash_ops.body(getattr(self.torch, cfg.dtype), cfg.head_dim)

    def decode_body(self, cfg, B, S):
        """The decode body and cluster split of a step at batch B over the
        cache a prefill of S tokens built."""
        from repro_torch.kernels.decode_attention import ops as decode_ops
        from repro_torch.models.kv_cache import cache_width
        W = cache_width(cfg, S)
        return (f"{decode_ops.body(getattr(self.torch, cfg.dtype))}, cluster "
                f"{decode_ops.cluster_size(W, B, cfg.num_kv_heads)} at "
                f"B {B}, W {W}")

    def run_core(self, scenario, payloads, scale, plain):
        """One core call: its output bytes (and token), the logits and
        token of each `_next_token` it took, its step times, launches and
        peaks."""
        torch = self.torch
        from repro_torch.models import serving
        counters = self.counters()
        for mod in counters.values():
            mod.launches = 0
        seen, timings = [], {}
        orig = serving._next_token

        def spy(logits):
            tok = orig(logits)
            seen.append((logits[:, -1].float(), tok))
            return tok

        serving._next_token = spy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            out = serving.run_scenario(scenario, payloads, scale=scale,
                                       plain=plain, timings=timings)
        finally:
            serving._next_token = orig
        token = None
        if scenario == "LLM-DECODE":
            out, token = out
        return {"body": out, "token": token, "seen": seen,
                "timings": timings,
                "launches": {n: m.launches for n, m in counters.items()},
                "peak": torch.cuda.max_memory_allocated(),
                "rss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                * 1024}

    def compare_core(self, path, scenario, scale, runs):
        """Kernel output against plain output, decoded onto the card:
        logits and float cache leaves at atol 0.3 / rtol 0.05, integer
        leaves exactly; greedy tokens equal wherever the plain path's top-2
        margin exceeds 0.3 (a flip under it excuses what it reaches)."""
        torch = self.torch
        from repro_torch.models import serving
        flipped = False
        for (kl, kt), (pl, pt) in zip(runs[False]["seen"],
                                      runs[True]["seen"]):
            top2 = pl.topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            for b in torch.nonzero((kt != pt).ravel()).ravel().tolist():
                if float(margin[b]) > 0.3:
                    raise AssertionError(f"{path}: row {b} token {int(kt[b])} "
                                         f"(kernel) vs {int(pt[b])} (plain) at "
                                         f"a top-2 margin of {float(margin[b])}")
                flipped = True
            print(f"  {path}: greedy tokens kernel {kt.ravel().tolist()}, "
                  f"plain {pt.ravel().tolist()}, plain top-2 margins "
                  f"{[round(float(m), 4) for m in margin]}")
            self.close(path, "next-token logits", kl, pl)
        kernel, plain = (serving.load_output(scenario, runs[p]["body"],
                                             scale=scale, device=self.dev)
                         for p in (False, True))
        if isinstance(kernel, dict):
            for key in sorted(kernel):
                if kernel[key].dtype == torch.int32:
                    if not torch.equal(kernel[key], plain[key]):
                        raise AssertionError(f"{path}: {key} differs")
                    print(f"  {path}: {key} equal")
                else:
                    self.close(path, key, kernel[key], plain[key])
        elif flipped and not torch.allclose(kernel, plain, atol=0.3,
                                            rtol=0.05):
            print(f"  {path}: output logits excused, the step took another "
                  f"token")
        else:
            self.close(path, "output logits", kernel, plain)

    def close(self, path, what, a, b):
        torch = self.torch
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        ok = bool(torch.allclose(a, b, atol=0.3, rtol=0.05)
                  and torch.isfinite(a).all())
        print(f"  {path}: {what} kernel vs plain max_abs_err={err:.3e} "
              f"(atol 0.3, rtol 0.05) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{path}: {what}: kernel path disagrees")

    def phase_timing(self):
        """Each kernel at its serve shape (the row of the kernels line),
        and the attention kernels and the scan at Hymba's shapes too."""
        llama, hymba, qwen3 = (32, 8, 128), (25, 5, 64), (32, 4, 128)
        self.timing[FLASH["name"]] = self.time_flash(*llama, 0, "llama3-8b")
        self.also[FLASH["name"]] = {
            "hymba-1.5b": self.time_flash(*hymba, 2048, "hymba-1.5b"),
            "qwen3-moe-30b-a3b": self.time_flash(*qwen3, 0,
                                                 "qwen3-moe-30b-a3b"),
            # the MLServe prefills: the LLM-DECODE seed, and EMB (granite-8b
            # has llama's heads)
            "llama3-8b B=8": self.time_flash(*llama, 0, "llama3-8b MLServe "
                                             "decode seed", B=8),
            "granite-8b B=32 S=512": self.time_flash(
                *llama, 0, "granite-8b MLServe EMB", B=32, S=512)}
        self.timing[DECODE["name"]] = self.time_decode(1, *llama, 0,
                                                       "llama3-8b")
        self.also[DECODE["name"]] = {
            "llama3-8b B=8": self.time_decode(8, *llama, 0, "llama3-8b"),
            "hymba-1.5b": self.time_decode(1, *hymba, 2048, "hymba-1.5b"),
            "qwen3-moe-30b-a3b": self.time_decode(1, *qwen3, 0,
                                                  "qwen3-moe-30b-a3b"),
            "qwen3-moe-30b-a3b B=8": self.time_decode(8, *qwen3, 0,
                                                      "qwen3-moe-30b-a3b")}
        self.timing[SCAN["name"]] = self.time_scan(8192, 256, "falcon-mamba-7b")
        self.also[SCAN["name"]] = {
            "hymba-1.5b": self.time_scan(3200, 100, "hymba-1.5b")}

    @staticmethod
    def bound(nbytes, flops, peak=BF16_FLOPS_PER_S):
        """The least time (ms) for the work, and what sets it."""
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
        return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")

    def time_flash(self, H, K, hd, window, arch, B=1, S=PROMPT):
        """Prefill at the serve shape (B=1, S=2048 unless given), causal,
        bf16."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.flash_attention import mha, mha_ref
        dt = torch.bfloat16
        g = self.gen(3)
        sets = []
        for _ in range(4 if B * S <= PROMPT else 2):
            q = self.randn(g, (B, S, H, hd), dt)
            sets.append((q, *(self.randn(g, (B, S, K, hd), dt) for _ in "kv")))
        lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                    for s in sets]
        # visited (query, key) pairs: causal, within the window
        pairs = sum(min(i + 1, window or S) for i in range(S))
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * K * hd)
        bms, by = self.bound(nbytes, 4 * B * H * hd * pairs)
        lib_mask = None
        if window and window < S:
            i = torch.arange(S, device=self.dev)
            lib_mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :]
                                                     < window)
        row = self.time_row(
            lambda s: mha(*s, causal=True, window=window),
            lambda s: mha_ref(*s, causal=True, window=window),
            lambda s: F.scaled_dot_product_attention(
                *s, attn_mask=lib_mask, is_causal=lib_mask is None,
                enable_gqa=True), sets, lib_sets, 20, 5)
        row.update(bound_ms=bms, bound_by=by)
        self.report(f"flash_attention bf16 B={B} S={S} causal H={H} K={K} "
                    f"hd={hd} window={window} ({arch})", row)
        return row

    def time_decode(self, B, H, K, hd, window, arch):
        """Decode at the serve shape: W=2048 after the ring's first wrap,
        bf16."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.decode_attention import (decode_mha,
                                                          decode_mha_ref)
        dt, W, pos = torch.bfloat16, PROMPT, PROMPT
        n = max(3, 16 // B)
        g = self.gen(5)
        sets, lib_sets = [], []
        sp = self.ring_slot_pos(W, W + 1, B)
        p = torch.full((B,), pos, dtype=torch.int32, device=self.dev)
        valid = (sp >= 0) & (sp <= p[:, None])
        if window:
            valid &= (p[:, None] - sp) < window
        for _ in range(n):
            q = self.randn(g, (B, 1, H, hd), dt)
            kc, vc = (self.randn(g, (B, W, K, hd), dt) for _ in "kv")
            sets.append((q, kc, vc, sp, p))
            lib_sets.append((q.transpose(1, 2).contiguous(),
                             kc.transpose(1, 2).contiguous(),
                             vc.transpose(1, 2).contiguous(),
                             valid[:, None, None, :]))
        nbytes = 2 * (2 * B * H * hd + 2 * B * W * K * hd) + 4 * (B * W + B)
        bms, by = self.bound(nbytes, 4 * H * hd * int(valid.sum()))
        row = self.time_row(
            lambda s: decode_mha(*s, window=window),
            lambda s: decode_mha_ref(*s, window=window),
            lambda s: F.scaled_dot_product_attention(
                s[0], s[1], s[2], attn_mask=s[3], enable_gqa=True),
            sets, lib_sets, 200, 50)
        row.update(bound_ms=bms, bound_by=by)
        self.report(f"flash_decode bf16 B={B} W=2048 H={H} K={K} hd={hd} "
                    f"window={window} ({arch})", row)
        return row

    def time_scan(self, di, rank, arch):
        """The scan at the serve shape: B=1, S=2048, N=16, xr in bf16,
        B and C column slices of the projection, as `mamba_layer` calls
        it, with the kernel's own states per thread R; then every R of the
        sweep by graph replay, beside the rule's pick. No PyTorch call
        computes a selective scan: library none."""
        torch = self.torch
        from repro_torch.kernels.ssm_scan import ops as scan_ops
        from repro_torch.kernels.ssm_scan import selective_scan, ssm_scan_ref
        from repro_torch.models.mamba import ssm_scan_chunked
        B, S, N = 1, PROMPT, 16
        g = self.gen(6)
        sets = [self.scan_inputs(g, B, S, di, N, xdtype=torch.bfloat16,
                                 proj_rank=rank) for _ in range(3)]
        # each input read once, each output written once
        nbytes = (B * S * di * (4 + 2 + 4) + 2 * 4 * B * S * N
                  + 4 * di * N + 2 * 4 * B * di * N)
        # per state and step: dt*A, exp, *B, fma (2), *C, the sum over n
        bms, by = self.bound(nbytes, 7 * B * S * di * N, F32_FLOPS_PER_S)
        row = self.time_row(lambda s: selective_scan(*s),
                            lambda s: ssm_scan_ref(*s), None, sets, None, 40,
                            3)
        R = scan_ops.states_per_thread(B, di, N)
        row.update(bound_ms=bms, bound_by=by, states_per_thread=R,
                   chunked_ms=self.time_ms(lambda s: ssm_scan_chunked(*s),
                                           sets, 3))
        self.report(f"ssm_scan B=1 S=2048 di={di} N=16 xr bf16 [R {R}] "
                    f"({arch}; {nbytes / 1e6:.1f} MB, "
                    f"{7 * B * S * di * N / 1e9:.2f} GFLOP)", row)
        print(f"    model plain path ssm_scan_chunked "
              f"{row['chunked_ms']:.4f} ms")
        row["ms_by_states_per_thread"] = {
            r: self.time_ms(lambda s, r=r: scan_ops.selective_scan_at(*s, R=r),
                            sets, 40, graph=True) for r in SCAN_SWEEP}
        fastest = min(row["ms_by_states_per_thread"].items(),
                      key=lambda kv: kv[1])[0]
        print("    sweep (graph replay): " + ", ".join(
            f"R {r} {ms:.4f} ms" for r, ms in
            row["ms_by_states_per_thread"].items())
              + f"; the rule picks R {R}, the fastest is R {fastest}")
        return row

    def report(self, label, row):
        lib = row["library_ms"]
        print(f"  {label}: kernel {row['ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), share of bound "
              f"{row['bound_ms'] / row['ms']:.3f}, plain {row['plain_ms']:.4f}"
              f" ms, library {'none' if lib is None else f'{lib:.4f} ms'}")
        print(f"    eager (host launch gaps included): kernel "
              f"{row['eager_ms']:.4f} ms"
              + ("" if lib is None
                 else f", library {row['library_eager_ms']:.4f} ms"))

    def kernels_line(self):
        """One row per kernel: launches summed over the serve paths (each
        path's count beside it), the largest error of phase 2, and the
        times at the serve shape (other shapes under ``also``)."""
        rows = []
        for meta in KERNELS:
            name = meta["name"]
            by_path = {arch: counts[name]
                       for arch, counts in self.launches.items()}
            rows.append({**meta, "launches": sum(by_path.values()),
                         "launches_by_path": by_path,
                         "max_abs_err": self.err[name], **self.timing[name],
                         "also": self.also[name]})
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
    phases = [("build", smoke.phase_build),
              ("kernels vs plain", smoke.phase_kernels),
              ("model kernel vs plain", smoke.phase_model)]
    for arch in ARCHS:
        phases.append((f"serve and trace {arch}",
                       lambda arch=arch: smoke.serve_path(arch)))
    phases.append(("mlserve cores", smoke.phase_mlserve))
    phases.append(("timing", smoke.phase_timing))
    for name, fn in phases:
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
