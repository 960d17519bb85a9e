"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which fails the run (exit 1) if it fails:

1. print the card's name and power limit; build the CUDA kernels from
   the sources in this checkout (one nvcc per source, in parallel) and
   print the build time and, from ``-Xptxas -v``, every kernel's
   registers and spill bytes (the scan backward's must not spill);
2. hold each kernel against its plain PyTorch version on the card:
   the attention kernels at Llama-3-8B, Hymba-1.5B and Qwen3-30B-A3B
   widths (qwen3: 32 q heads over 4 kv heads, G 8, hd 128; prefill B 1
   S 2048 causal, decode B 1 and 8 after the ring's first wrap and at a
   partial fill; prefill also at the MLServe shapes, llama's heads at B 8
   x S 2048 and B 32 x S 512; both also at head_dim 16, the moe role's
   tiny heads H 4 over K 2; at qwen2-72b's 64 q heads over 8 (G 8,
   prefill S 2048, decode B 1 and 8 after the first wrap); and at the
   group sizes 6 and 7: yi-34b's 56
   q heads over 8 (prefill S 2048, decode B 1 and 8, a wrapped ring with
   a window), mixtral-8x22b's 48 over 8 with its 4096 window (prefill S
   8192; decode on its served W 4096 ring and on a wrapped W 8192 ring),
   yi-34b's smoke heads H 7 over K 1 and H 6 over K 1 at hd 16; at
   internvl2-2b's heads H 16 over K 8 (G 2, hd 128: prefill causal S
   2048, decode B 1 and 8 after the first wrap) and at
   seamless-m4t-large-v2's H 16 over K 16 (G 1, hd 64: prefill
   bidirectional S 2048 (its encoder), causal S 2048 (its decoder), and
   cross-attention of 2048 queries against 2048 and against a ragged
   1500 keys; decode on the self ring after its first wrap and on the
   cross cache with every slot valid, W 2048 and 1500, B 1 and 8)), bf16
   (atol = rtol = 2e-2) and fp32 (2e-5), each check naming the body that
   ran (prefill: wgmma or SIMT; decode: mma or SIMT, and its cluster
   size), q/k/v as views of a fused projection, and misaligned bf16
   views (prefill at hd 64, decode at hd 16) and a group size outside
   the decode kernel's (G 3) that must raise; the attention backward
   (``flash_attention_bwd``), on the out and lse of ``mha_with_lse``,
   against ``mha_ref_bwd`` (autograd of the plain attention), dq, dk and
   dv each within 2e-2 (bf16) or 1e-4 (f32) of its largest |value|, each
   check naming the body that ran (bf16 hd 64/128: wgmma; else SIMT), and
   the forward's lse against the plain row lse (``LSE_TOL``), at llama's
   training shape (B 2 x S 4096 and B
   1 x S 2048, causal) and a mesh rank's local heads of it (H 16 K 4
   and H 8 K 2, and H 16 K 4 at B 1 for a (2, 2) rank, which the
   forward checks hold too), hymba's heads at
   S 4096 with its 2048 window and a mesh rank's of them at model 4 (H 6
   and H 7 at G 1, B 2, which the forward checks hold too),
   qwen3-moe-30b-a3b's mesh rank's heads at model 2 (H 16 over K 2, G 8,
   hd 128, B 2 x S 4096 and B 1 on (2, 2), which the forward checks hold
   too),
   seamless's cross shape (2048 queries against 1500 keys,
   bidirectional), the group sizes 1, 2, 5, 6, 7 and 8, hd 16 and 32, a
   dout that is a transposed view, and two runs bit for bit; the
   selective scan at
   Falcon-Mamba-7B and Hymba-1.5B widths, fp32 (1e-4), with the model's
   long-memory dt and A, every states-per-thread R forced, N = 8, layouts
   that are not 16-byte aligned and S = 0, 1 and 5, each check naming the
   R that ran (``[R r]``); the scan's backward (``ssm_scan_bwd``) on the
   forward's boundary states against ``ssm_scan_ref_bwd``, each gradient
   (d(dt), dx, dB, dC, dA, dh0) within 1e-4 of its largest |value| (dx
   2e-2 with xr bf16): Falcon-Mamba-7B's and Hymba-1.5B's widths with the
   long-memory inputs at B 1 x S 2048 and B 2 x S 4096 (the training
   shape), and a mesh rank's channels of them at B 2 x S 4096 (d_inner
   4096 and 800, which the forward checks hold too), xr bf16 and f32,
   hymba's width at both R forced, N = 8, a
   ragged S, S = 0, 1 and 5, nonzero h0 and dh_final (and none), B and C
   views of one projection, layouts that are not 16-byte aligned, block
   counts that are not a multiple of the cluster (masked CTAs in the last
   cluster), each check naming the design that ran (``[R r, cluster
   k]``), two runs bit for bit, and the forward with its states bit for
   bit the forward without; the head_dim-slice decode pair
   (``decode_scores_hd``, ``decode_values_hd``) against its plain
   versions at the serving ranks' shapes (llama's G 4 at hd slices 64, 32
   and 8, qwen2's G 8, yi's G 7, B 1 and 8, W 2048 after the ring's first
   wrap and at a partial fill, a window; bf16 and f32; the moe family's
   ranks: qwen3's G 8 over K 4 at its decode_32k rank (B 8, W 32768,
   slice 8) and its serving runs' ranks (slice 64, B 2 and 1),
   mixtral's G 6 with its window of 4096 on its wrapped ring of 4096 at
   its decode_32k and long_500k ranks (slice 8, B 8 and 1) and its
   serving run's rank (slice 64)), the pair composed over every slice of
   hd 128 (mixtral's heads with a window too) against
   ``decode_mha_ref`` on the whole heads, two runs bit for bit, and a
   slice it does not take raising;
3. each served model at full width, 2 layers: kernel path against plain
   path, prefill and one decode step (atol 0.3, rtol 0.05), prompt 2048
   (mixtral-8x22b 8192, past its window; internvl2-2b from random bf16
   embeddings; seamless-m4t-large-v2 at 2 encoder and 2 decoder layers,
   2048 source frames and a 2048-token target prefix), qwen2-72b's QKV
   biases set to
   nonzero random values; for mixtral-8x22b (top-2 of 8 experts) the
   MoE routing of the plain path held to the kernel path's where a
   token's 2nd and 3rd router probabilities lie within 2e-2
   (``RoutePin``; a flip at a larger margin fails);
4. the serve driver (``repro_torch.launch.serve.main``) for llama3-8b,
   falcon-mamba-7b and hymba-1.5b at full published width and depth (32,
   64 and 32 layers), and (``repro_torch.launch.serve.run``) at full
   width cut in depth: qwen3-moe-30b-a3b to 24 of its 48 layers (128
   experts top-8), yi-34b to 30 of 60, qwen2-72b to 32 of 80 and
   mixtral-8x22b to 12 of 56 with prompt 8192 (each cut named on its
   phase line);
   prompt 2048, 8 requests x 16 tokens, 2 replicas
   sharing one params copy: durable completions, prefetches, exact
   kernel launch counts (every count set to 0 just before the path and
   read just after), the first request replayed through the plain path,
   peak device memory under 1.5x the params (one copy), the params' bytes
   equal to the dry run's at a mesh of one device; for the MoE, one
   decode token through ``moe_dense`` allocating less than an eighth of
   one (E, D, F) expert weight leaf (the weights are read in place,
   never copied); each server is freed before the next path starts;
   then ("embeds and enc-dec") internvl2-2b (24 layers, 1.89e9
   parameters) and seamless-m4t-large-v2 (24 encoder and 24 decoder
   layers, 2.03e9), which take precomputed embeddings and which the
   serve driver refuses as the reference's does, at full width and depth
   through the `Model` facade with seed-0 params on the card: at B 1 and
   at B 8 a prefill of 2048 positions from random bf16 embeddings and 16
   greedy decode steps, with exact launch counts (internvl2: 24
   ``flash_attention`` per prefill, 24 ``flash_decode`` per step;
   seamless: 72 and 48, its cross-attention through the decode kernel
   with every slot valid), prefill and decode-step wall, tok/s and peak
   device memory; the B 1 run replayed through the plain path on its
   tokens, logits at every step within atol 0.3, rtol 0.05; one replica
   of each traced as in phase 5;
   then ("train") 4 AdamW steps each of llama3-8b at full width cut to 8
   of its 32 layers, hymba-1.5b at full width and depth (32 layers,
   1.52e9 parameters) and falcon-mamba-7b at full width cut to 8 of its
   64 layers (12 B a parameter on the card), bf16, seed-0 init, B 2 x S
   4096, through ``repro_torch.launch.train.run`` (a SyntheticCorpus in
   the port's object store, the DataPipeline's prefetch through its
   NexusBackend): loss and grad norm per step, step wall and device time,
   tokens/s, mfu against 989 TFLOP/s, beside it the mfu by
   ``repro_torch.models.flops.model_flops`` (the reference's convention)
   and the ratio of the two FLOP counts, the train state that
   ``train.run`` returns against the dry run's state bytes
   (``repro_torch.launch.dryrun`` at a mesh of one device: the
   allocator's requested bytes equal exactly, its allocated bytes the
   state's blocks), peak device memory and host RSS,
   exact launches of the attention and scan kernels (each forward, its
   recompute under the remat policy and each backward, per layer and
   step), a torch.profiler trace of step 2 with the port's kernels'
   rows; a 2-layer full-width model of each, its loss and every gradient
   leaf on the kernel path against the plain path (B 1 x S 4096; the
   scan's plain side under ``inner_remat``); and at llama3-8b smoke a
   checkpoint through the port's AsyncCheckpointer restored with
   ``--resume`` semantics, equal bit for bit; then ("train (mesh)")
   at full width, B 2 x S 4096, 3 AdamW steps through ``train.run`` on
   (data, model) meshes of ranks that it spawns itself
   (``repro_torch.launch.ranks.spawn``: a card each over NCCL where the
   machine has that many, else every rank on card 0 over gloo, passed
   explicitly; a line names the backend and the cards; ``mesh="debug"``
   for (1, n), a ``launch.mesh.rank_mesh`` for (2, 2)): llama3-8b cut to
   4 of its 32 layers on (1, 2), (1, 4) and (2, 2) (FSDP over data, one
   row a data rank), falcon-mamba-7b cut to 2 of 64 on (1, 2),
   hymba-1.5b cut to 4 of 32 on (1, 4) and qwen3-moe-30b-a3b
   cut to 2 of 48 on (1, 2) and (2, 2) (64 of its 128 experts a rank),
   each against the same 3 steps on one rank (every one-rank run first,
   then one spawn a count of ranks, which trains its runs in turn and
   then makes a sharded checkpoint's round trip at llama3-8b smoke on
   (1, 2) or (2, 2): saved through ``AsyncCheckpointer.save(step,
   state, tp)``, restored through ``restore_to_mesh``, every shard bit
   for bit): each step's loss within 2e-2 and grad
   norm (and the moe family's load-balancing loss) within 5e-2 of it,
   leaf by leaf over every rank's shard: each
   first-moment leaf within 5e-2 of its largest |value|, each params
   leaf's update from init within 5e-1 of one rank's in norm; each
   rank's train state against the dry run's state bytes on that
   mesh exactly in requested bytes, exact launches of the attention and
   scan kernels on each rank's local heads and channels (llama H 16 K 4
   and H 8 K 2; falcon d_inner 4096; hymba d_inner 800 and
   6 or 7 q heads at G 1; qwen3 H 16 K 2; on (2, 2) at B 1), the
   model-axis gathers by path, step wall and device time and the
   collectives by kind, bytes, host and (NCCL) device seconds, with a
   reduce-scatter (``reduce_scatter_tensor`` on either backend, the
   backward of every gather) in every step of a run whose placement
   gathers; for the moe runs each layer's assignments kept and dropped
   (on (2, 2) from both data ranks' counts), equal to one rank's, and
   those whose expert differs from one rank's with the largest router
   margin among them (at most 2e-2; the ranks then take one rank's
   experts there, as phase 3's ``RoutePin``); then, in the same spawns,
   the dense family served under the reference's serving shardings
   (``launch.sharding.serve_placement``: params and batch as in
   training, the prefill cache W over ``model``, the decode cache
   head_dim over ``model``, the logits vocab over ``model``): llama3-8b
   at full width cut to 4 of its 32 layers on (1, 2), (1, 4) and (2, 2)
   and qwen2-72b cut to 2 of its 80 layers (G 8, QKV biases nonzero) on
   (1, 4), B 2 x prompt 2048, a prefill, ``kv_cache.to_decode_layout``
   and 16 decode steps (4 on (2, 2), where FSDP gathers every weight's
   data shards in each step through host memory) on one rank's greedy
   tokens (teacher-forced),
   against the same run on one rank: the gathered logits of every step
   within atol 0.3, rtol 0.05, the greedy tokens where one rank's top-2
   margin exceeds that, exact launches a rank (``flash_attention`` the
   layers a prefill, ``decode_scores_hd`` and ``decode_values_hd`` the
   layers a decode step, ``flash_decode`` none), each step's collectives
   by kind (4 ``all_to_all`` a layer; the all-reduce of the f32 scores
   (B / data, H, W) a layer, counted as ``score_all_reduce``, and those
   of the embedding and the row-parallel products, exactly in bytes;
   the score all-reduce's share of a decode step's wall), each rank's params and decode cache
   on the card equal to the dry run's decode-step argument bytes at that
   mesh, prefill and decode-step walls and peak memory beside one
   rank's; and the moe family so: qwen3-moe-30b-a3b cut to
   2 of its 48 layers on (1, 2) and (2, 2) (64 experts a rank; on (2, 2)
   the prefill's capacity slots from both data ranks' counts, one
   ``count_all_gather`` a layer, and 4 decode steps) and mixtral-8x22b
   cut to 2 of its 56 on (1, 2) at prompt 8192 (4 of its 8 experts a
   rank, its ring of 4096 wrapped), each prefill through ``moe_sorted``
   and each decode step through the dropless ``moe_dense`` on the
   rank's experts, with no count gather in a decode step and the
   experts' f32 partial outputs in the all-reduce bytes; the ranks
   pinned to one rank's experts where a bf16 near-tie routes a token
   otherwise (``RouteLog``; the pinned assignments and their largest
   router margin printed, at most 2e-2); the one-rank training runs'
   references (params and first moments) copied to the host on the
   phase's path and written to their files by a thread beside it, the
   ranks waiting for a run's file only when they check against it;
5. one replica of each served arch traced with torch.profiler: host
   wall time of prefill and of a decode step, device time, device idle
   share, top device ops;
   then the MLServe serving cores (``repro_torch.models.serving``): the
   scenarios LLM-COLD, LLM-PREFILL and LLM-DECODE (llama3-8b) and EMB
   (granite-8b), from seed payloads built once per role,
   through the kernels and then ``plain=True`` on the inputs the kernel
   run decoded (the payloads are not decoded twice): at tiny
   scale (the SMOKE configs, hd 32) with every payload and output length
   equal to ``calibration.json``, and at full published width cut to
   half depth (llama3-8b 16 of 32 layers, 9.08 GB of params in one
   payload or 4 shards, a 1.07 GB decode state of 8 x 2048 slots;
   granite-8b 18 of 36 layers, tied head, B 32 x S 512) with every
   length equal to ``role_sizes(cfg, 1)`` of the cut config; kernel
   against plain (logits and float cache leaves atol 0.3, rtol 0.05,
   integer leaves exactly, greedy tokens wherever the top-2 margin
   exceeds 0.3), exact launch counts, and per scenario the payload bytes,
   the wall time of decoding the payloads onto the card, of the forward
   and of encoding the output, peak device memory and peak host RSS;
   then the worker node (``repro_torch.core.runtime.WorkerNode``) running
   the MLServe handlers: LLM-COLD, LLM-PREFILL, LLM-DECODE, EMB and MOE
   at tiny scale under all 7 system variants, a cold then a warm
   invocation each, every durable output byte-identical across variants
   and invocations and equal to the kernel-path core called directly on
   the same bytes, with exact launch counts per invocation; then the
   FaultInjector (``repro_torch.core.faults``): LLM-PREFILL and
   LLM-DECODE under ``nexus`` and ``baseline`` with one backend crash
   inside the params GET and one storage-slow window, the caller
   re-driving under the same invocation id, exactly one success per
   invocation and durable bytes equal to the fault-free run; then the
   paper suite and the multi-I/O scenarios (no device work) under all 7
   variants, byte-identical across variants; then llama3-8b LLM-PREFILL
   at full width cut to 4 of its 32 layers under ``nexus`` with the
   SharedCache on: two invocations of the full-scale workload on 3.85 GB
   of params, the first a miss that fills the cache, the second served
   from it, both durable KV caches byte-equal to the kernel-path core's
   on the same bytes, with each breakdown, the modeled sleeps (transfer, SDK,
   token bucket, cache hit) beside the measured host work (the fill's
   hash and copy, the hit's copies, the handler's decode / forward /
   encode), the cache's counters, ``MemTotal`` and ``MemAvailable``
   before the phase, and peak device memory and peak host RSS;
   then the density simulator (``repro_torch.core.des``) on this
   machine's host, no kernel launching: one run of the paper suite
   (baseline, 160 functions) and one of the full-scale MLServe suite
   (nexus, 20 functions) under each of the four engines, with one
   sha256 digest of each run's latency streams and ``completed`` that
   must agree across the engines; ``find_density(system, seed=1,
   fast=True)`` at its defaults for the five systems of Fig 6, one
   process each, each density a passing probe below every failing one,
   printed with its probes, its gain over baseline and its host wall
   time (modeled virtual-time densities, not a measurement of the card);
   and the DES's zero-contention LLM-PREFILL under ``nexus``, cold and
   warm, per breakdown group (fetch[0], compute[0], write[0]) beside the
   full-width node run above, the DES pricing compute from
   ``calibration.json``'s ``hbm-accel-8x`` profile;
   then the fleet model (``repro_torch.core.cluster``) on this machine's
   host, no kernel launching: ``benchmarks/cluster.py``'s headline fleet
   (48 boxes: 30 ``nexus``, 12 ``nexus-async``, 6 ``baseline``; 480
   functions, azure arrivals, seed 5, 30 s after 6 s warmup) under its
   five dispatch policies, one process each, printing offered,
   completed, goodput, p50/p99, shed and mean utilisation (modeled
   virtual time), at least 3 policies with distinct (goodput, p99); and
   PlanCheck (``repro_torch.core.analysis``): ``run_matrix()`` clean, and
   every seeded corruption of ``mutate`` caught with its own code; then
   the dry run (``repro_torch.launch.dryrun``) on this machine's host, no
   kernel launching: every runnable (arch x shape) cell on both
   production meshes (16x16 and 2x16x16), its per-device argument and
   output bytes against the card's memory and its analytic and counted
   FLOPs per device, and ``repro_torch.core.calibrate --check`` true;
6. each kernel timed at the serve shapes (the attention kernels at
   llama3-8b's, hymba-1.5b's, qwen3-moe-30b-a3b's, yi-34b's and
   qwen2-72b's (decode B 1 and 8) and mixtral-8x22b's (prefill S 8192 with its window, decode on
   its W 4096 ring and on a W 8192 ring with the 4096 window),
   internvl2-2b's (decode B 1 and 8) and seamless-m4t-large-v2's
   (prefill bidirectional, causal, and cross against 1500 keys; decode
   B 1 and 8 with every slot valid, and on a W 1500 cross cache), and at
   head_dim 16 with the moe smoke heads, prefill also at the MLServe
   shapes B 8 x S 2048 and granite-8b's B 32 x S 512),
   beside its bound,
   its plain version and, where there is one, one PyTorch library call (a
   yardstick only; the port never calls it). Kernel and library times
   are device times: CUDA events around the replay of a CUDA graph of
   many calls, so the host's launch overhead (tens of microseconds per
   call from Python, more than a decode kernel takes) does not stand in
   for the kernel's time; the eager times are printed beside them. The
   plain versions are timed eagerly. The attention backward is timed on
   the forward's lse at llama's training shape (B 2 x S 4096), at B 1 x
   S 2048, at hymba's heads (hd 64, window 2048, S 4096) and at a mesh
   rank's llama heads (H 16 K 4 and H 8 K 2, B 2 x S 4096, and H 16 K 4
   at B 1 for (2, 2); the forward too), hymba heads (H 6 and 7 at G 1,
   window 2048; the forward too) and qwen3-moe-30b-a3b heads (H 16 K 2
   at G 8, B 2 and B 1; the forward too)
   beside its
   bound by operations (2.5x the forward's FLOPs), the plain backward and
   the library's (autograd of ``F.scaled_dot_product_attention``,
   eager). The scan is also timed at every R of ``SCAN_SWEEP`` beside
   the R its rule picks, and at the training shapes without and with its
   boundary states, also at a mesh rank's channels (d_inner 4096 and
   800; the plain scan timed at the two training shapes only). The
   scan's backward is timed at falcon-mamba-7b's and
   hymba-1.5b's training shapes (B 2 x S 4096), at a mesh rank's
   channels of them, and at B 1 x S 2048
   beside its bound (bytes, f32 operations and exponentials, the
   largest; one saved state counted every ``BOUND_CHUNK`` steps) and,
   at falcon-mamba-7b's training shape only, the plain backward (~1-3 s
   a call: the plain scans' shapes are the cut that, with the mesh
   ranks' start-up, pays for the moe mesh run), then at every R it
   takes, each line naming R,
   sub-chunk, cluster, warps an SM and shared memory a CTA; no library
   call computes it. The head_dim-slice pair is timed at a decode_32k
   rank's shape on the 16x16 mesh (B 8, W 32768, H 32, K 8, hd slice 8),
   at qwen3-moe-30b-a3b's (K 4) and mixtral-8x22b's (H 48, W 4096 with
   its window; and its long_500k rank, B 1), and at the serving runs'
   ranks, beside its bound (bytes), its plain
   versions, one ``torch.einsum`` for the scores (the library call) and
   the nearest expression for the values (``torch.where``,
   ``torch.softmax``, ``torch.matmul``; no one call computes them); the
   prefill kernel also at the serving ranks' heads (mixtral-8x22b's H 24
   over K 4 at S 8192 with its window).

Prints a JSON line of the kernels, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside a checkout of the repository, it exits 2 and prints
no result. Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import json
import math
import os
import resource
import shutil
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
SM_CLOCK_HZ = 1.98e9            # H100 SXM boost; 16 MUFU.EX2 a clock an SM
#: the scan backward's bound counts one saved state read every this many
#: steps, the interval its first design read, whatever interval it saves
#: (``scan_ops.CHUNK``): a design that saves more states pays for them
#: inside its measured time
BOUND_CHUNK = 32
ARCHS = ("llama3-8b", "falcon-mamba-7b", "hymba-1.5b")
PROMPT, REQUESTS, GEN, REPLICAS = 2048, 8, 16, 2
#: the archs served at full width with their depth cut: (layers, prompt).
#: qwen3-moe-30b-a3b keeps 24 of its 48 layers and yi-34b 30 of its 60 (both
#: fit the card whole; the cuts pay for the "train (mesh)" phase's ssm and
#: hybrid runs within the script's time); qwen2-72b (80 layers, ~145 GB in
#: bf16) keeps 32 and mixtral-8x22b (56 layers, 140.6e9 params) 12, to
#: fit one card, and mixtral's prompt of 8192 is twice its 4096 window, so
#: the window masks in prefill and its ring cache evicts in every decode
#: step
CUT = {"qwen3-moe-30b-a3b": (24, PROMPT), "yi-34b": (30, PROMPT),
       "qwen2-72b": (32, PROMPT), "mixtral-8x22b": (12, 8192)}
#: the archs that take precomputed embeddings, which the serve driver
#: refuses as the reference's does: driven through the `Model` facade at
#: full width and depth, at these batch sizes
EMBEDS = ("internvl2-2b", "seamless-m4t-large-v2")
EMBEDS_BATCHES = (1, 8)
#: the largest gap between the k-th and (k+1)-th router probability at
#: which the kernel and plain paths may route a token to other experts
#: (the bf16 kernel tolerance, as tests/test_torch_model.py's ROUTE_TOL)
ROUTE_TOL = 2e-2
#: the archs whose phase-3 plain path replays the kernel path's routing at
#: near-ties: one flipped expert of mixtral's top-2 moves half of that
#: token's FFN, past the model tolerance; qwen3's top-8 is compared as is
PINNED = ("mixtral-8x22b",)
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
#: the attention backward: each gradient's largest error over its largest
#: |value| (as tests/test_torch_cuda.py's BWD_TOL)
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: the forward's row lse against the plain one, over its largest |value|
#: (f32 sums in another order; the tensor-core body's exp2 and ln 2)
LSE_TOL = 1e-4
SCAN_TOL = 1e-4                 # f32, as tests/test_kernels.py::TestSsmScan
SCAN_SWEEP = (2, 4, 8)          # states per thread timed in phase 6
#: the MLServe scenarios driven on the card, by role
MLSERVE = {"llm": ("LLM-COLD", "LLM-PREFILL", "LLM-DECODE"), "emb": ("EMB",)}
#: the MLServe scenarios the worker node runs at tiny scale, by role
NODE_TINY = {**MLSERVE, "moe": ("MOE",)}
#: the scenarios and variants the FaultInjector runs on the card
FAULTED = ("LLM-PREFILL", "LLM-DECODE")
FAULTED_SYSTEMS = ("nexus", "baseline")
MLSERVE_SCALES = ("tiny", "full")
#: the layers each role's full-width config keeps in the "mlserve cores"
#: phase (half of llama3-8b's 32 and of granite-8b's 36)
MLSERVE_FULL_LAYERS = {"llm": 16, "emb": 18}
#: the five systems of the paper's Fig 6 (``SYSTEMS_ORDER`` of
#: benchmarks/density.py), each searched by the density phase
DENSITY_SYSTEMS = ("baseline", "nexus-tcp", "nexus-prefetch-only",
                   "nexus-async", "nexus")
#: the fleet phase: `benchmarks/cluster.py`'s headline fleet size and its
#: five dispatch policies (``POLICIES``), one process each
FLEET_N = 48
FLEET_POLICIES = ("round_robin", "random", "least_loaded", "jbsq",
                  "affinity")
#: the train phase: each arch at full width with the layers it keeps
#: (None: all), at 12 B a parameter on the card: llama3-8b 8 of 32 (33.5
#: GB), hymba-1.5b all 32 (1.52e9 params, 18.3 GB) and falcon-mamba-7b 8
#: of 64 (1.37e9, 16.5 GB; all 64 would need 87 GB); the reference's
#: ``train_4k`` sequence length, TRAIN_STEPS steps, step TRAIN_TRACED traced
TRAIN_RUNS = (("llama3-8b", 8), ("hymba-1.5b", None), ("falcon-mamba-7b", 8))
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_STEPS, TRAIN_TRACED = 4, 2
#: the "train (mesh)" phase: each arch at full width cut to its layers,
#: B TRAIN_BATCH x S TRAIN_SEQ, MESH_STEPS AdamW steps on each of its
#: (data, model) meshes: ``train.run(mesh="debug")`` for (1, n), a
#: ``rank_mesh`` passed to ``train.run`` for (2, 2) (FSDP over data, one
#: row a data rank); a card a rank over NCCL where the machine has that
#: many, else all on card 0 over gloo; the ranks of one spawn train every
#: run of their count within MESH_TIMEOUT_S seconds: llama3-8b 4 of 32
#: layers on (1, 2), (1, 4) and (2, 2) (the dense family: 16, 8 and 16 q
#: heads a rank); falcon-mamba-7b 2 of 64 on (1, 2) (the scan at d_inner
#: 4096 a rank); hymba-1.5b 4 of 32 on (1, 4) (d_inner 800 a rank, 6 or 7
#: of its 25 heads at G 1, its odd vocab of 32001 replicated over
#: ``model``); qwen3-moe-30b-a3b 2 of 48 on (1, 2) and (2, 2) (64 of its
#: 128 experts a rank, H 16 over K 2 at G 8 and the q/k norms; on (2, 2)
#: the whole batch's capacity slots from both data ranks' counts)
MESH_RUNS = (("llama3-8b", 4, ((1, 2), (1, 4), (2, 2))),
             ("falcon-mamba-7b", 2, ((1, 2),)),
             ("hymba-1.5b", 4, ((1, 4),)),
             ("qwen3-moe-30b-a3b", 2, ((1, 2), (2, 2))))
MESH_STEPS, MESH_TIMEOUT_S = 3, 420
#: the serving runs of the same spawns, after their training runs: each
#: arch at full width cut to its layers, B MESH_SERVE_BATCH x prompt
#: PROMPT, a prefill, ``kv_cache.to_decode_layout`` and MESH_SERVE_STEPS
#: decode steps (one rank's greedy tokens, teacher-forced) on each of its
#: (data, model) meshes under the reference's serving shardings: llama3-8b
#: 4 of 32 layers on (1, 2), (1, 4) and (2, 2) (hd slices 64, 32, 64;
#: FSDP over data on (2, 2)); qwen2-72b 2 of 80 on (1, 4) (G 8, QKV
#: biases nonzero, hd slice 32); falcon-mamba-7b 2 of 64 on (1, 2)
#: (d_inner 4096 a rank); hymba-1.5b 4 of 32 on (1, 4) (d_inner 800 a
#: rank, 6 or 7 of its 25 q heads, hd slice 16 at G 5, its window of 2048,
#: its odd vocab of 32001 replicated); qwen3-moe-30b-a3b 2 of 48 on (1, 2)
#: and (2, 2) (64 of its 128 experts a rank, hd slice 64 at G 8; on (2, 2)
#: the prefill's capacity slots from both data ranks' counts);
#: mixtral-8x22b 2 of 56 on (1, 2) at its ``CUT`` prompt of 8192 (4 of its
#: 8 experts a rank, a ring of 4096 that the prompt wraps, hd slice 64 at
#: G 6 with its window); internvl2-2b 4 of 24 on (1, 2) from a prompt of
#: bf16 embeddings (8 q heads and 4 kv heads a rank, hd slice 64 at G 2,
#: its odd vocab of 92553 replicated over ``model``); seamless-m4t-large-v2
#: 4 of its 24 encoder and 4 of its 24 decoder layers on (1, 4) from
#: PROMPT source frames and a target prefix of PROMPT tokens (4 heads a
#: rank at G 1, the self and cross caches' hd slice 16, its vocab of
#: 256206 replicated over ``model`` 4). The moe runs' ranks are pinned to
#: one rank's experts where a bf16 near-tie routes a token otherwise
#: (`RouteLog`). A fourth entry {shape: steps} cuts a run's decode steps
#: below `serve_steps`' default, named on the phase line: qwen3-moe's
#: (2, 2) steps (6.9 s each on one H100 80GB HBM3 at 700 W) pay for the
#: internvl2-2b and seamless-m4t-large-v2 runs
MESH_SERVE_RUNS = (("llama3-8b", 4, ((1, 2), (1, 4), (2, 2))),
                   ("qwen2-72b", 2, ((1, 4),)),
                   ("falcon-mamba-7b", 2, ((1, 2),)),
                   ("hymba-1.5b", 4, ((1, 4),)),
                   ("qwen3-moe-30b-a3b", 2, ((1, 2), (2, 2)), {(2, 2): 2}),
                   ("mixtral-8x22b", 2, ((1, 2),)),
                   ("internvl2-2b", 4, ((1, 2),)),
                   ("seamless-m4t-large-v2", 4, ((1, 4),)))
MESH_SERVE_BATCH, MESH_SERVE_STEPS = 2, 16
#: the decode steps of a run whose data axis is split (2, 2): FSDP
#: gathers every weight's data shards in each step, 0.96 GB a rank
#: through host memory over gloo on one card, ~6.1 s a step (16 steps
#: took 100.4 s on one H100 80GB HBM3 at 700 W); the cut that keeps the
#: script inside its limit, named on the phase line
MESH_SERVE_FSDP_STEPS = 4
#: the logits of a rank against one rank's, as phase 3's kernel against
#: plain; a token is compared where one rank's top-2 margin exceeds it
MESH_SERVE_ATOL, MESH_SERVE_RTOL = 0.3, 0.05
#: the bf16 tolerances of tests/test_torch_train.py: the loss within 2e-2,
#: each gradient leaf (here each first-moment leaf, 0.1 x the clipped
#: gradient of step 3 plus 0.09 and 0.081 x steps 2 and 1) within 5e-2 of
#: its largest |value| (2.1-2.2e-2 on an H100); each params leaf's
#: update (params - init) within MESH_UPDATE_TOL of one rank's update in
#: norm: a bf16 param moves only where it is small, by a few ulps, so
#: its rounding follows the last bits of the gradient (0.14-0.15 on an
#: H100, ``embed``); a skipped update reads 1, an unrelated one ~1.4
MESH_LOSS_TOL, MESH_LEAF_TOL, MESH_UPDATE_TOL = 2e-2, 5e-2, 5e-1
#: the kernels of the train paths, as they appear in a trace
TRAIN_KERNELS = ("attn_tc_kernel", "attn_kernel", "dkdv_kernel", "dq_kernel",
                 "prep_kernel", "ssm_scan_kernel", "ssm_scan_bwd_kernel",
                 "ssm_scan_bwd_sum_kernel")
#: the deadline of one worker-node invocation's future (phase 5)
NODE_TIMEOUT_S = 900
#: the full-width worker-node run's llama3-8b keeps this many of its 32
#: layers: a 3.85 GB params GET, under the 4.72 GB that the token bucket's
#: 60 s debt clamp covers at 600 Mbps, so every modeled sleep shrinks
#: with the bytes (at 8 layers, 5.59 GB, the bucket would still sleep 60 s)
NODE_LAYERS = 4
#: a scenario's durable output, as its key in role_sizes / calibration
MLSERVE_OUT = {"LLM-COLD": "cold_out_bytes", "LLM-PREFILL": "kv_prefill_bytes",
               "LLM-DECODE": "kv_out_bytes", "EMB": "emb_bytes"}

FLASH = {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:92"}
FLASH_BWD = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention_bwd.cu",
             "replaces": "XLA autodiff of src/repro/models/layers.py:212 "
                         "full_attention / :124 blocked_causal_attention "
                         "(no Pallas backward)"}
DECODE = {"name": "flash_decode", "route": "cuda",
          "source": "src/repro_torch/kernels/decode_attention/csrc/"
                    "decode_attention.cu",
          "replaces": "src/repro/kernels/decode_attention/kernel.py:72"}
SCAN = {"name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:67"}
SCAN_BWD = {"name": "ssm_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_bwd.cu",
            "replaces": "XLA autodiff of src/repro/models/mamba.py:53 "
                        "ssm_scan_chunked (no Pallas backward)"}
SCORES_HD = {"name": "decode_scores_hd", "route": "cuda",
             "source": "src/repro_torch/kernels/decode_attention/csrc/"
                       "decode_attention_hd.cu",
             "replaces": "GSPMD's partition of src/repro/models/layers.py:228"
                         " decode_attention and :359 cross_attention_layer "
                         "over head_dim (the decode cache_spec, "
                         "src/repro/launch/sharding.py:166); no Pallas "
                         "kernel"}
VALUES_HD = {**SCORES_HD, "name": "decode_values_hd"}
KERNELS = (FLASH, FLASH_BWD, DECODE, SCORES_HD, VALUES_HD, SCAN, SCAN_BWD)


def every_kernel(counts):
    """A launch count for each kernel of ``KERNELS``: those given, 0 for
    the others."""
    return {meta["name"]: counts.get(meta["name"], 0) for meta in KERNELS}


def _paths(tree, prefix=""):
    """(path, leaf) of a params tree in its leaves' order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


class Counter:
    """A kernel's launch count kept under another attribute name of its
    wrapper module (the attention backward's ``bwd_launches`` beside the
    forward's ``launches``), read and set as ``launches``."""

    def __init__(self, mod, attr):
        self.mod, self.attr = mod, attr

    @property
    def launches(self):
        return getattr(self.mod, self.attr)

    @launches.setter
    def launches(self, n):
        setattr(self.mod, self.attr, n)


class RssSampler:
    """The resident set of this process when the block starts and its
    peak while the block runs, sampled from /proc every 50 ms
    (``ru_maxrss`` keeps the peak of the whole run, which earlier phases
    set)."""

    def __enter__(self):
        import threading
        self.start = self.peak = self.now()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def now():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * resource.getpagesize()

    def _poll(self):
        while not self._stop.wait(0.05):
            self.peak = max(self.peak, self.now())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def kernel_name(mangled: str) -> str:
    """A readable name of a kernel's mangled symbol: its namespace in
    the source (tc or simt), name and template arguments (dtype, head
    dim). Itanium names are length-prefixed; the prefix is the tail of a
    run of digits that may follow a hash's digits."""
    import re
    for m in re.finditer(r"\d+", mangled):
        run = m.group()
        for i in range(len(run)):
            n, at = int(run[i:]), m.end()
            ident = mangled[at:at + n]
            if not (n and ident.endswith("_kernel")
                    and re.fullmatch(r"[A-Za-z_]\w*", ident)):
                continue
            ns = re.search(r"(?:2(tc)|4(simt))$", mangled[:m.start() + i])
            args = mangled[at + n:].split("EE", 1)[0]
            dtype = ("bf16" if "__nv_bfloat16" in args
                     else "f32" if args.startswith("If") else "")
            vals = [v if k == "i" else ("true" if v == "1" else "false")
                    for k, v in re.findall(r"L([ib])(\d+)E", args + "E")]
            parts = [t for t in (dtype, *vals) if t]
            return ((f"{ns.group(1) or ns.group(2)}::" if ns else "") + ident
                    + (f"<{', '.join(parts)}>" if parts else ""))
    return mangled[:36]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def latency_digest(result, sim) -> str:
    """sha256 over a density-simulator run's latency streams (each
    function's name and its latencies as float hex, in deployment order)
    and its ``completed`` count."""
    import hashlib
    h = hashlib.sha256()
    for fn in sim.functions:
        h.update(fn.encode())
        h.update(",".join(x.hex() for x in result.latencies.get(fn, []))
                 .encode())
    h.update(str(result.completed).encode())
    return h.hexdigest()


def density_search(system):
    """``find_density(system, seed=1, fast=True)`` at its defaults, in a
    process of its own: the density, each probe's (n, meets the SLO),
    and the search's wall seconds."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.core.des import find_density
    t0 = time.perf_counter()
    best, results = find_density(system, seed=1, fast=True)
    return (best, [(r.n_functions, r.meets_slo()) for r in results],
            time.perf_counter() - t0)


def fleet_run(policy):
    """`benchmarks/cluster.py`'s headline cell under one dispatch policy,
    in a process of its own: the port's `ClusterSimulator` on the fleet
    of ``FLEET_N`` boxes (~1/8 fat ``baseline``, ~1/4 ``nexus-async``,
    the rest ``nexus``), 10 functions a box, azure arrivals at mean rate
    1.0, seed 5, 30 s after 6 s of warmup. Returns the cell's numbers
    and the run's host wall seconds."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.core.cluster import (ClusterSimulator, ClusterSpec,
                                          NodeSpec)
    n = FLEET_N
    n_base, n_async = max(1, n // 8), max(1, n // 4)
    slim = dict(nodes=1, cores=8, mem_gb=16.0, backend_workers=16,
                max_vms_per_node=70)
    nodes = (NodeSpec("nexus", count=n - n_base - n_async, **slim),
             NodeSpec("nexus-async", count=n_async, **slim),
             NodeSpec("baseline", count=n_base, nodes=1, cores=16,
                      mem_gb=24.0, backend_workers=16, max_vms_per_node=100))
    spec = ClusterSpec(nodes=nodes, n_functions=10 * n, policy=policy,
                       mean_rate=1.0, duration_s=30.0, warmup_s=6.0,
                       arrival_pattern="azure")
    t0 = time.perf_counter()
    r = ClusterSimulator(spec, seed=5).run()
    util = r.node_utilization()
    return ({"members": [(ns.system, ns.count) for ns in nodes],
             "offered": r.offered, "completed": r.completed,
             "goodput": r.goodput, "p50_s": r.p50, "p99_s": r.p99,
             "shed": r.shed_total, "util_mean": sum(util) / len(util),
             "conserved": r.offered == sum(r.dispatched) + r.shed["frontend"]},
            time.perf_counter() - t0)


class RoutePin:
    """Records the kernel path's MoE routing, (gates, idx) per router call
    (`run(replay=False)`), and replays it on the plain path
    (`run(replay=True)`) for every token whose expert set differs there;
    a flip at a router margin (k-th less (k+1)-th probability) past
    ``ROUTE_TOL`` raises. The tolerance is that of
    tests/test_torch_model.py's `RoutingSpy`, which drops the rows a flip
    reaches where this replays them."""

    def __init__(self, torch, moe):
        self.torch, self.moe = torch, moe
        self.calls, self.flips, self.margins = [], 0, []

    @contextlib.contextmanager
    def run(self, replay):
        torch, route, calls = self.torch, self.moe._route, iter(self.calls)

        def spy(p, cfg, xf):
            gates, idx, aux = route(p, cfg, xf)
            if not replay:
                self.calls.append((gates, idx))
                return gates, idx, aux
            rec_gates, rec_idx = next(calls)
            flip = (idx.sort(-1).values != rec_idx.sort(-1).values).any(-1)
            if flip.any():
                k = cfg.num_experts_per_tok
                top = torch.softmax(xf.float() @ p["router"], -1).topk(k + 1)
                margin = float((top.values[:, k - 1]
                                - top.values[:, k])[flip].max())
                self.margins.append(margin)
                if margin > ROUTE_TOL:
                    raise AssertionError(f"a token routed to other experts "
                                         f"at margin {margin}")
                self.flips += int(flip.sum())
                gates = torch.where(flip[:, None], rec_gates, gates)
                idx = torch.where(flip[:, None], rec_idx, idx)
            return gates, idx, aux

        self.moe._route = spy
        try:
            yield
        finally:
            self.moe._route = route


def kept_dropped(counts, assignments, cfg) -> dict:
    """The assignments the MoE capacity keeps and drops, from the batch's
    per-expert ``counts`` of its ``assignments``."""
    cap = max(int(assignments / cfg.num_experts * cfg.capacity_factor), 8)
    kept = int(counts.clamp_max(cap).sum())
    return {"kept": kept, "dropped": assignments - kept}


def whole_batch_routing(ranks, model, cfg):
    """Each rank's router calls (`RouteLog`'s) with kept and dropped
    reckoned from the whole batch: the counts of the data ranks (those at
    model coordinate 0 of a mesh with ``model`` ranks on that axis; on
    (1, n) rank 0, which routes the whole batch) summed call by call."""
    firsts = [res["routing"] for r, res in enumerate(ranks) if r % model == 0]
    whole = [kept_dropped(sum(c[i]["counts"] for c in firsts),
                          sum(c[i]["assignments"] for c in firsts), cfg)
             for i in range(len(firsts[0]))]
    return [[{**c, **w} for c, w in zip(res["routing"], whole)]
            for res in ranks]


class RouteLog:
    """The MoE router's choices call by call, through `moe._top_k` (which
    the one-device `_route` and the mesh's `_route_on_mesh` both call):
    each call's per-expert counts, the assignments it keeps and drops
    under the capacity (reckoned from the counts: on a (1, n) mesh every
    rank routes the whole batch; where the batch is split over data,
    `whole_batch_routing` reckons them from every data rank's counts)
    and, against another run's experts call by call (``want``, of the
    whole batch; this run routes ``part`` (d, n) of each call's tokens,
    the d-th of n equal parts: a data rank's rows of a batch split over n
    data ranks), the assignments whose expert differs and the
    largest router margin (k-th less (k+1)-th probability) among their
    tokens; it then pins those tokens to ``want``'s experts, with this
    run's own probabilities of them as gates (so the router's gradient
    stays this run's), as `RoutePin` and tests/test_torch_train.py's
    `PinnedRouting` do: the same experts make the same slots, so both
    runs keep and drop the same assignments. ``experts`` keeps each
    call's (T, k) experts as uint8 on the host, for a later run's
    ``want``."""

    def __init__(self, torch, moe, want=None, part=(0, 1)):
        self.torch, self.moe, self.want, self.part = torch, moe, want, part
        self.calls, self.experts = [], []

    @contextlib.contextmanager
    def run(self):
        torch, top_k = self.torch, self.moe._top_k

        def spy(router, cfg, xf):
            probs, gates, idx = top_k(router, cfg, xf)
            E, k = cfg.num_experts, cfg.num_experts_per_tok
            call = {"moved": 0, "margin": 0.0}
            if self.want is not None:
                ref = self.want[len(self.calls)]
                d, n = self.part
                ref = ref[d * len(ref) // n:(d + 1) * len(ref) // n]
                ref = ref.to(idx.device, torch.long)
                moved = ~(idx[:, :, None] == ref[:, None, :]).any(-1)
                call["moved"] = int(moved.sum())
                if call["moved"]:
                    flip = moved.any(-1)[:, None]
                    top = probs.detach().topk(k + 1, dim=-1).values
                    call["margin"] = float((top[:, k - 1] - top[:, k])[
                        flip[:, 0]].max())
                    pinned = probs.gather(-1, ref)
                    pinned = pinned / pinned.sum(-1, keepdim=True).clamp_min(
                        1e-9)
                    idx = torch.where(flip, ref, idx)
                    gates = torch.where(flip, pinned, gates)
            else:
                self.experts.append(idx.to(torch.uint8).cpu())
            call["counts"] = torch.bincount(idx.reshape(-1),
                                            minlength=E).cpu()
            call["assignments"] = idx.numel()
            call.update(kept_dropped(call["counts"], idx.numel(), cfg))
            self.calls.append(call)
            return probs, gates, idx

        self.moe._top_k = spy
        try:
            yield self
        finally:
            self.moe._top_k = top_k


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.err = {meta["name"]: 0.0 for meta in KERNELS}
        self.rel_err = {}               # kernel -> largest relative error
        self.launches = {}              # arch -> kernel -> launches
        self.timing = {}
        self.also = {}                  # kernel -> timings at other shapes
        self.node_full_runs = None      # the full-width node's two results

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
        for name in libs:
            if name not in _build.LOGS:
                print(f"  {name}: built before this run (no ptxas report)")
                continue
            report = _build.ptxas_report(_build.LOGS[name])
            if name.startswith("flash_attention") or name == SCAN_BWD["name"]:
                for kernel, regs, st, ld in report:   # every kernel
                    print(f"  {name:19s} {kernel_name(kernel):34s} {regs:3d} "
                          f"registers, spill stores {st} B, loads {ld} B")
                if name == SCAN_BWD["name"] and any(st or ld for _, _, st, ld
                                                    in report):
                    raise AssertionError(f"{name} spills registers")
                continue
            spilled = [f"{kernel_name(k)} {st}/{ld} B" for k, _, st, ld
                       in report if st or ld]
            print(f"  {name:19s} {len(report)} kernels, at most "
                  f"{max((r for _, r, _, _ in report), default=0)} registers; "
                  f"spill stores/loads: {', '.join(spilled) or 'none'}")

    def phase_kernels(self):
        self.check_attention()
        self.check_decode_hd()
        self.check_attention_bwd()
        self.check_scan()
        self.check_scan_bwd()

    def check_attention_bwd(self):
        """The attention backward kernel against `mha_ref_bwd` (autograd of
        the plain attention), dq, dk and dv each within ``BWD_TOL`` of its
        largest |value|: llama's training shape (B 2 x S 4096, H 32 over K
        8, hd 128, causal) and B 1 x S 2048, hymba's heads at S 4096 with
        its 2048 window, seamless's cross-attention (2048 queries against
        1500 keys, bidirectional), the group sizes 1, 2, 5, 6, 7 and 8, hd
        16 and 32, in bf16 and f32, through the body ``bwd_body`` picks
        and on the out and lse of ``mha_with_lse`` (whose lse is held to
        the plain row lse within ``LSE_TOL``); then a dout that is not
        contiguous, and two runs of one backward bit for bit."""
        torch = self.torch
        from repro_torch.kernels.flash_attention import (mha_bwd,
                                                         mha_ref_bwd,
                                                         mha_ref_with_lse,
                                                         mha_with_lse)
        from repro_torch.kernels.flash_attention import ops as flash_ops
        name = FLASH_BWD["name"]
        cases = [
            ((2, 4096, 4096, 32, 8, 128), True, 0, "llama train B=2 S=4096"),
            ((1, 2048, 2048, 32, 8, 128), True, 0, "llama train B=1 S=2048"),
            ((1, 4096, 4096, 25, 5, 64), True, 2048,
             "hymba H25/K5/hd64 G5 window=2048 S=4096"),
            ((1, 2048, 1500, 16, 16, 64), False, 0,
             "seamless cross Sq=2048 Sk=1500 G1"),
            ((1, 2048, 2048, 16, 8, 128), True, 0, "internvl2 H16/K8 G2"),
            ((1, 1024, 1024, 48, 8, 128), True, 512,
             "mixtral H48/K8 G6 window=512"),
            ((1, 1024, 1024, 56, 8, 128), True, 0, "yi H56/K8 G7"),
            ((1, 1024, 1024, 64, 8, 128), True, 0, "qwen2 H64/K8 G8"),
            ((2, 300, 300, 4, 2, 16), True, 48, "hd 16 H4/K2 window=48"),
            ((2, 512, 512, 8, 4, 32), False, 0, "hd 32 H8/K4 bidirectional"),
            # a rank's local heads of llama3-8b on the mesh: model 2, 4
            ((2, 4096, 4096, 16, 4, 128), True, 0,
             "llama mesh rank H16/K4 (model 2) B=2 S=4096"),
            ((2, 4096, 4096, 8, 2, 128), True, 0,
             "llama mesh rank H8/K2 (model 4) B=2 S=4096"),
            # a rank's local heads of hymba-1.5b on the mesh (model 4)
            ((2, 4096, 4096, 6, 6, 64), True, 2048,
             "hymba mesh rank H6/K6 G1 (model 4) window=2048 B=2 S=4096"),
            ((2, 4096, 4096, 7, 7, 64), True, 2048,
             "hymba mesh rank H7/K7 G1 (model 4) window=2048 B=2 S=4096"),
            # a rank's local heads of qwen3-moe-30b-a3b on the mesh
            ((2, 4096, 4096, 16, 2, 128), True, 0,
             "qwen3 mesh rank H16/K2 G8 (model 2) B=2 S=4096"),
            # a (2, 2) rank's: one row of the batch a data rank
            ((1, 4096, 4096, 16, 4, 128), True, 0,
             "llama mesh rank H16/K4 (2, 2) B=1 S=4096"),
            ((1, 4096, 4096, 16, 2, 128), True, 0,
             "qwen3 mesh rank H16/K2 G8 (2, 2) B=1 S=4096"),
        ]
        for dname, tol in BWD_TOL.items():
            dtype = getattr(torch, dname)
            g = self.gen(11)
            for (B, Sq, Sk, H, K, hd), causal, window, what in cases:
                q = self.randn(g, (B, Sq, H, hd), dtype)
                k, v = (self.randn(g, (B, Sk, K, hd), dtype) for _ in "kv")
                dout = self.randn(g, (B, Sq, H, hd), dtype)
                out, lse = mha_with_lse(q, k, v, causal=causal,
                                        window=window)
                body = flash_ops.bwd_body(dtype, hd)
                self.compare_rel(FLASH["name"], f"{dname} lse [{body}] "
                                 f"{what}", lse, mha_ref_with_lse(
                                     q, k, v, causal=causal,
                                     window=window)[1], LSE_TOL)
                got = mha_bwd(q, k, v, out, dout, lse=lse, causal=causal,
                              window=window)
                want = mha_ref_bwd(q, k, v, out, dout, causal=causal,
                                   window=window)
                for gname, a, b in zip(("dq", "dk", "dv"), got, want):
                    self.compare_rel(name, f"{dname} {gname} [{body}] {what}",
                                     a, b, tol)
                del q, k, v, dout, out, lse, got, want
            # dout as a transposed view, made contiguous by the wrapper
            q = self.randn(g, (1, 1000, 8, 128), dtype)
            k, v = (self.randn(g, (1, 1000, 2, 128), dtype) for _ in "kv")
            dout = self.randn(g, (1, 8, 1000, 128), dtype).transpose(1, 2)
            out, lse = mha_with_lse(q, k, v)
            got = mha_bwd(q, k, v, out, dout, lse=lse)
            body = flash_ops.bwd_body(dtype, 128)
            for gname, a, b in zip(("dq", "dk", "dv"), got,
                                   mha_ref_bwd(q, k, v, out, dout)):
                self.compare_rel(name, f"{dname} {gname} [{body}] dout a "
                                 f"transposed view S=1000", a, b, tol)
            again = mha_bwd(q, k, v, out, dout, lse=lse)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: two runs of one backward "
                                     f"differ")
            print(f"  {name:15s} {dname} [{body}] two runs of one backward: "
                  f"equal bit for bit")

    def compare_rel(self, kernel, label, out, ref, tol):
        """Max error relative to the reference's largest |value|."""
        self.torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rel = err / scale if scale else err
        ok = rel <= tol and bool(self.torch.isfinite(out).all())
        self.err[kernel] = max(self.err[kernel], err)
        self.rel_err[kernel] = max(self.rel_err.get(kernel, 0.0), rel)
        print(f"  {kernel:15s} {label:52s} max_abs_err={err:.3e} of "
              f"{scale:.3e}: {rel:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} {label} disagrees with its plain "
                                 f"version")

    def check_attention(self):
        torch = self.torch
        from repro_torch.kernels.decode_attention import (decode_mha,
                                                          decode_mha_ref)
        from repro_torch.kernels.decode_attention import ops as decode_ops
        from repro_torch.kernels.flash_attention import mha, mha_ref
        from repro_torch.kernels.flash_attention import ops as flash_ops
        llama, hymba = (32, 8, 128, ""), (25, 5, 64, " hymba H25/K5/hd64")
        qwen3 = (32, 4, 128, " qwen3 H32/K4/hd128")
        qwen2 = (64, 8, 128, " qwen2 H64/K8/hd128")
        small = (8, 4, 32, " H8/K4/hd32")
        moe_tiny = (4, 2, 16, " moe smoke H4/K2/hd16")
        yi, mixtral = (56, 8, 128, " yi H56/K8/hd128 G7"), (
            48, 8, 128, " mixtral H48/K8/hd128 G6")
        yi_tiny, g6_tiny = (7, 1, 16, " yi smoke H7/K1/hd16 G7"), (
            6, 1, 16, " H6/K1/hd16 G6")
        internvl2 = (16, 8, 128, " internvl2 H16/K8/hd128 G2")
        seamless = (16, 16, 64, " seamless H16/K16/hd64 G1")
        llama_tp2 = (16, 4, 128, " llama mesh rank H16/K4 (model 2)")
        llama_tp4 = (8, 2, 128, " llama mesh rank H8/K2 (model 4)")
        # hymba's 25 heads over model 4: 6, 6, 6 and 7 q heads a rank,
        # never whole groups of 5, so one kv head a q head (G 1)
        hymba_tp4 = [(H, H, 64, f" hymba mesh rank H{H}/K{H} G1 (model 4)")
                     for H in (6, 7)]
        qwen3_tp2 = (16, 2, 128, " qwen3 mesh rank H16/K2 G8 (model 2)")
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
                    (qwen2, 1, 2048, True, 0, "causal S=2048"),
                    (small, 2, 512, True, 0, "causal S=512"),
                    (moe_tiny, 2, 512, True, 0, "causal S=512"),
                    (moe_tiny, 1, 300, True, 48, "ragged causal window=48"),
                    (moe_tiny, 2, 130, False, 0, "bidirectional S=130"),
                    # the MLServe prefills: the LLM-DECODE seed (B 8), and
                    # EMB (granite-8b has llama's heads)
                    (llama, 8, 2048, True, 0, "causal S=2048 (decode seed)"),
                    (llama, 32, 512, True, 0, "causal S=512 (granite EMB)"),
                    (yi, 1, 2048, True, 0, "causal S=2048"),
                    # a rank's local heads of llama3-8b on the mesh
                    (llama_tp2, 2, 4096, True, 0, "causal S=4096"),
                    (llama_tp4, 2, 4096, True, 0, "causal S=4096"),
                    *[(h, 2, 4096, True, 2048, "window=2048 S=4096")
                      for h in hymba_tp4],
                    (qwen3_tp2, 2, 4096, True, 0, "causal S=4096"),
                    # a (2, 2) rank's: one row of the batch a data rank
                    (llama_tp2, 1, 4096, True, 0, "causal S=4096 (2, 2)"),
                    (qwen3_tp2, 1, 4096, True, 0, "causal S=4096 (2, 2)"),
                    (mixtral, 1, 8192, True, 4096, "window=4096 S=8192"),
                    (internvl2, 1, 2048, True, 0, "causal S=2048"),
                    (seamless, 1, 2048, False, 0,
                     "bidirectional S=2048 (encoder)"),
                    (seamless, 1, 2048, True, 0, "causal S=2048 (decoder)")]:
                q = self.randn(g, (B, S, H, hd), dtype)
                k, v = (self.randn(g, (B, S, K, hd), dtype) for _ in "kv")
                out = mha(q, k, v, causal=causal, window=window)
                ref = mha_ref(q, k, v, causal=causal, window=window)
                self.compare(FLASH["name"], f"{dname} B={B} {what}{arch} "
                             f"[{flash_ops.body(dtype, hd)}]", out, ref, tol)
            # seamless's cross-attention: the target's queries against the
            # source's keys, bidirectional
            for (H, K, hd, arch), Sq, Sk in [(seamless, 2048, 2048),
                                             (seamless, 2048, 1500)]:
                q = self.randn(g, (1, Sq, H, hd), dtype)
                k, v = (self.randn(g, (1, Sk, K, hd), dtype) for _ in "kv")
                out = mha(q, k, v, causal=False)
                ref = mha_ref(q, k, v, causal=False)
                self.compare(FLASH["name"], f"{dname} B=1 cross Sq={Sq} "
                             f"Sk={Sk}{arch} [{flash_ops.body(dtype, hd)}]",
                             out, ref, tol)
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
                    (qwen3, 8, 2048, 900, 900, 0, "partial fill 900/2048"),
                    (qwen2, 1, 2048, 2049, 2048, 0, "serve first wrap W=2048"),
                    (qwen2, 8, 2048, 2049, 2048, 0, "serve first wrap W=2048"),
                    (moe_tiny, 2, 512, 512, 512, 0, "full W=512"),
                    (moe_tiny, 1, 2048, 2049, 2048, 0, "first wrap W=2048"),
                    (moe_tiny, 2, 300, 37, 37, 0, "partial fill 37/300"),
                    (moe_tiny, 1, 256, 400, 399, 96, "wrapped ring window=96"),
                    (moe_tiny, 2, 64, 0, 0, 0, "no valid slot: mean of V"),
                    (yi, 1, 2048, 2049, 2048, 0, "serve first wrap W=2048"),
                    (yi, 8, 2048, 2049, 2048, 0, "serve first wrap W=2048"),
                    (yi, 2, 2048, 5000, 5000, 1024,
                     "wrapped ring window=1024"),
                    (mixtral, 1, 4096, 8193, 8192, 4096,
                     "serve ring W=4096 window=4096"),
                    (mixtral, 1, 8192, 9000, 9000, 4096,
                     "wrapped ring W=8192 window=4096"),
                    (mixtral, 8, 4096, 700, 700, 4096,
                     "partial fill 700/4096"),
                    (yi_tiny, 2, 300, 400, 399, 64, "wrapped ring window=64"),
                    (yi_tiny, 1, 2048, 2049, 2048, 0, "first wrap W=2048"),
                    (g6_tiny, 2, 256, 400, 399, 96, "wrapped ring window=96"),
                    (g6_tiny, 2, 64, 0, 0, 0, "no valid slot: mean of V"),
                    (internvl2, 1, 2048, 2049, 2048, 0,
                     "serve first wrap W=2048"),
                    (internvl2, 8, 2048, 2049, 2048, 0,
                     "serve first wrap W=2048"),
                    (seamless, 1, 2048, 2049, 2048, 0,
                     "self ring first wrap W=2048"),
                    (seamless, 8, 2048, 2049, 2048, 0,
                     "self ring first wrap W=2048"),
                    # the cross cache: slot_pos arange(W), pos W - 1
                    (seamless, 1, 2048, 2048, 2047, 0,
                     "cross, every slot valid W=2048"),
                    (seamless, 8, 2048, 2048, 2047, 0,
                     "cross, every slot valid W=2048"),
                    (seamless, 1, 1500, 1500, 1499, 0,
                     "cross, every slot valid W=1500"),
                    (seamless, 8, 1500, 1500, 1499, 0,
                     "cross, every slot valid W=1500")]:
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
        # the bf16 decode body's vector loads need 16-byte aligned caches
        g = self.gen(8)
        wide = self.randn(g, (1, 64, 2, 24), torch.bfloat16)
        q = self.randn(g, (1, 1, 4, 16), torch.bfloat16)
        sp = self.ring_slot_pos(64, 64, 1)
        p = torch.full((1,), 64, dtype=torch.int32, device=self.dev)
        before = decode_ops.launches
        try:
            decode_mha(q, wide[..., 2:18], wide[..., 2:18], sp, p)
        except ValueError as e:
            print(f"  {DECODE['name']:15s} misaligned bf16 hd 16 view raises: "
                  f"{e}")
        else:
            raise AssertionError("a misaligned decode view did not raise")
        if decode_ops.launches != before:
            raise AssertionError("a refused call counted a launch")
        # a group size the kernel does not take raises: no fallback
        q = self.randn(g, (1, 1, 24, 64), torch.bfloat16)
        kc = self.randn(g, (1, 256, 8, 64), torch.bfloat16)
        sp = self.ring_slot_pos(256, 256, 1)
        p = torch.full((1,), 256, dtype=torch.int32, device=self.dev)
        try:
            decode_mha(q, kc, kc, sp, p)
        except ValueError as e:
            print(f"  {DECODE['name']:15s} G 3 (not in {decode_ops.GROUPS}) "
                  f"raises: {e}")
        else:
            raise AssertionError("a group size outside GROUPS did not raise")
        if decode_ops.launches != before:
            raise AssertionError("a refused call counted a launch")

    def check_decode_hd(self):
        """The head_dim-slice pair (``decode_scores_hd``,
        ``decode_values_hd``) against its plain versions, each kernel on
        the same inputs, at the serving ranks' shapes: llama's heads (G 4)
        at hd slices 64, 32 and 8 (hd 128 over model 2, 4 and 16),
        qwen2's G 8 and yi's G 7, hymba's G 5 with its window of 2048 at
        slices 32, 16 and 4 (hd 64 over model 2, 4 and 16; a bf16 row of
        4 is one 8-byte vector); B 1 and 8; W 2048 after the ring's first
        wrap and at a partial fill; a window; bf16 and f32; the moe
        family's ranks: qwen3's G 8 over K 4 (its decode_32k rank, B 8 W
        32768 slice 8, and its serving runs' (1, 2) and (2, 2) ranks,
        slice 64) and mixtral's G 6 with its window of 4096 on its wrapped
        ring of 4096 (the decode_32k rank B 8 and the long_500k rank B 1
        at slice 8, the serving run's (1, 2) rank at slice 64);
        internvl2's G 2 (its decode_32k rank B 8 W 32768 at slice 8, its
        serving run's (1, 2) rank at slice 64) and seamless's G 1 (its
        decode_32k rank at slice 4 and its serving run's (1, 4) rank at
        slice 16, each with every slot valid, as the cross decode calls
        it, and after the self ring's wrap). Then the pair composed over
        every slice of hd 128 (mixtral's heads with a window of 1024 too,
        internvl2's), and over all 16 slices of hymba's and seamless's hd
        64 (the partial scores summed, as the all-reduce sums them)
        against ``decode_mha_ref`` on the whole heads; two runs bit for
        bit, at slice 8 (llama's, mixtral's and internvl2's heads) and at
        hymba's and seamless's slice 4; a slice it does not take (12)
        raises."""
        torch = self.torch
        from repro_torch.kernels.decode_attention import (
            decode_mha_ref, decode_scores_hd, decode_scores_hd_ref,
            decode_values_hd, decode_values_hd_ref)
        from repro_torch.kernels.decode_attention import ops as decode_ops
        sname, vname = SCORES_HD["name"], VALUES_HD["name"]
        W = PROMPT
        llama, qwen2, yi, hymba = (32, 8, 128), (64, 8, 128), (56, 8, 128), \
            (25, 5, 64)
        cases = [(llama, 64, 1, W + 1, 0, "llama G4 (model 2)"),
                 (llama, 32, 8, W + 1, 0, "llama G4 (model 4)"),
                 (llama, 8, 8, W + 1, 0, "llama G4 (model 16)"),
                 (llama, 64, 1, 700, 0, "llama G4 partial fill"),
                 (qwen2, 32, 1, W + 1, 0, "qwen2 G8 (model 4)"),
                 (qwen2, 32, 8, W + 1, 0, "qwen2 G8 (model 4)"),
                 (yi, 16, 1, W + 1, 0, "yi G7 (model 8)"),
                 (yi, 16, 8, 1500, 0, "yi G7 partial fill"),
                 (llama, 32, 1, W + 1, 512, "llama G4 window=512"),
                 (hymba, 32, 1, W + 1, W, "hymba G5 (model 2)"),
                 (hymba, 16, 8, W + 1, W, "hymba G5 (model 4)"),
                 (hymba, 4, 1, W + 1, W, "hymba G5 (model 16)"),
                 (hymba, 4, 8, W + 1, W, "hymba G5 (model 16)"),
                 (hymba, 4, 8, 1500, W, "hymba G5 partial fill")]
        # (heads, hs, B, W, fill, window, label): the decode_32k ranks on
        # 16x16 (B 128 over data 16, hd over model 16), mixtral's
        # long_500k rank (B 1 replicated; its cache is its 4096 window),
        # and the serving runs' ranks (hd over model 2, seamless's over
        # 4); mixtral's rings have wrapped (prompt 8192, and 524288 at
        # long_500k); a fill of W is the cross cache's every valid slot
        qwen3, mixtral = (32, 4, 128), (48, 8, 128)
        internvl2, seamless = (16, 8, 128), (16, 16, 64)
        rank_cases = [
            (qwen3, 8, 8, 32768, 32769, 0, "qwen3 G8 decode_32k rank"),
            (qwen3, 64, 2, W, W + 1, 0, "qwen3 G8 (1, 2) rank"),
            (qwen3, 64, 1, W, W + 1, 0, "qwen3 G8 (2, 2) rank"),
            (mixtral, 8, 8, 4096, 8193, 4096, "mixtral G6 decode_32k rank"),
            (mixtral, 8, 1, 4096, 524289, 4096,
             "mixtral G6 long_500k rank"),
            (mixtral, 64, 2, 4096, 8193, 4096, "mixtral G6 (1, 2) rank"),
            (internvl2, 8, 8, 32768, 32769, 0, "internvl2 G2 decode_32k rank"),
            (internvl2, 64, 2, W, W + 1, 0, "internvl2 G2 (1, 2) rank"),
            (seamless, 4, 8, 32768, 32768, 0,
             "seamless G1 decode_32k rank, cross"),
            (seamless, 4, 8, 32768, 32769, 0,
             "seamless G1 decode_32k rank, self"),
            (seamless, 16, 2, W, W, 0, "seamless G1 (1, 4) rank, cross"),
            (seamless, 16, 2, W, W + 1, 0, "seamless G1 (1, 4) rank, self")]
        for dname, tol in TOL.items():
            dtype = getattr(torch, dname)
            g = self.gen(21)
            for (H, K, hd), hs, B, fill, window, arch in cases:
                q = self.randn(g, (B, H, hs), dtype)
                kc, vc = (self.randn(g, (B, W, K, hs), dtype) for _ in "kv")
                sp = self.ring_slot_pos(W, fill, B)
                p = torch.full((B,), fill - 1, dtype=torch.int32,
                               device=self.dev)
                label = (f"{dname} B={B} W={W} H={H} K={K} hs={hs} fill="
                         f"{fill}{f' window={window}' if window else ''} "
                         f"[{arch}]")
                s_ref = decode_scores_hd_ref(q, kc)
                self.compare(sname, label, decode_scores_hd(q, kc), s_ref,
                             tol)
                self.compare(vname, label, decode_values_hd(
                    s_ref, vc, sp, p, head_dim=hd, window=window),
                    decode_values_hd_ref(s_ref, vc, sp, p, head_dim=hd,
                                         window=window), tol)
            # the moe, vlm and enc-dec ranks, each on its own ring:
            # qwen3's G 8 (K 4), mixtral's G 6 with its window of 4096,
            # internvl2's G 2 and seamless's G 1
            for (H, K, hd), hs, B, Wr, fill, window, arch in rank_cases:
                q = self.randn(g, (B, H, hs), dtype)
                kc, vc = (self.randn(g, (B, Wr, K, hs), dtype) for _ in "kv")
                sp = self.ring_slot_pos(Wr, fill, B)
                p = torch.full((B,), fill - 1, dtype=torch.int32,
                               device=self.dev)
                label = (f"{dname} B={B} W={Wr} H={H} K={K} hs={hs} fill="
                         f"{fill}{f' window={window}' if window else ''} "
                         f"[{arch}]")
                s_ref = decode_scores_hd_ref(q, kc)
                self.compare(sname, label, decode_scores_hd(q, kc), s_ref,
                             tol)
                self.compare(vname, label, decode_values_hd(
                    s_ref, vc, sp, p, head_dim=hd, window=window),
                    decode_values_hd_ref(s_ref, vc, sp, p, head_dim=hd,
                                         window=window), tol)
            # the pair over every slice against the whole heads
            for (H, K, hd), n, B, fill, window in (
                    (llama, 2, 1, W + 1, 0), (llama, 16, 8, W + 1, 0),
                    (qwen2, 4, 1, W + 1, 0), (yi, 8, 8, 1500, 0),
                    (hymba, 16, 8, W + 1, W), (hymba, 16, 1, 1500, W),
                    (mixtral, 2, 2, W + 1, 1024), (mixtral, 16, 8, W + 1,
                                                   1024),
                    (internvl2, 2, 2, W + 1, 0), (seamless, 16, 8, W, 0)):
                q = self.randn(g, (B, 1, H, hd), dtype)
                kc, vc = (self.randn(g, (B, W, K, hd), dtype) for _ in "kv")
                sp = self.ring_slot_pos(W, fill, B)
                p = torch.full((B,), fill - 1, dtype=torch.int32,
                               device=self.dev)
                parts = [slice(j * hd // n, (j + 1) * hd // n)
                         for j in range(n)]
                s = sum(decode_scores_hd(q[:, 0, :, sl].contiguous(),
                                         kc[..., sl].contiguous())
                        for sl in parts)
                out = torch.cat([decode_values_hd(
                    s, vc[..., sl].contiguous(), sp, p, head_dim=hd,
                    window=window) for sl in parts], dim=-1)[:, None]
                self.compare(vname, f"{dname} pair over {n} slices of hd "
                             f"{hd} B={B} H={H} K={K} fill={fill}"
                             f"{f' window={window}' if window else ''} vs "
                             f"decode_mha_ref", out,
                             decode_mha_ref(q, kc, vc, sp, p, window=window),
                             tol)
        for (H, K, hd), hs, window in ((llama, 8, 0), (hymba, 4, W),
                                       (mixtral, 8, W), (internvl2, 8, 0),
                                       (seamless, 4, 0)):
            g = self.gen(22)
            q = self.randn(g, (8, H, hs), torch.bfloat16)
            kc, vc = (self.randn(g, (8, W, K, hs), torch.bfloat16)
                      for _ in "kv")
            sp, p = self.ring_slot_pos(W, W + 1, 8), torch.full(
                (8,), W, dtype=torch.int32, device=self.dev)
            runs = [(s, decode_values_hd(s, vc, sp, p, head_dim=hd,
                                         window=window))
                    for s in (decode_scores_hd(q, kc),
                              decode_scores_hd(q, kc))]
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            print(f"  {sname}/{vname} H={H} K={K} hs={hs} two runs bit for "
                  f"bit: {'yes' if same else 'NO'}")
            if not same:
                raise AssertionError("the decode pair differs from run to "
                                     "run")
        before = (decode_ops.scores_launches, decode_ops.values_launches)
        g = self.gen(24)
        try:
            decode_scores_hd(self.randn(g, (1, 8, 12), torch.float32),
                             self.randn(g, (1, 64, 2, 12), torch.float32))
        except ValueError as e:
            print(f"  {sname} hd slice 12 raises: {e}")
        else:
            raise AssertionError("a slice outside HD_SLICES did not raise")
        if (decode_ops.scores_launches, decode_ops.values_launches) != before:
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
        # a mesh rank's channels at the training shape: falcon-mamba-7b's
        # 8192 over model 2, hymba-1.5b's 3200 over model 4
        for di, rank, arch in ((4096, 256, "falcon-mamba mesh rank (model "
                                "2)"), (800, 100, "hymba mesh rank (model "
                                                  "4)")):
            check(f"{arch} B=2 S=4096 long memory di={di}", self.scan_inputs(
                g, 2, 4096, di, xdtype=torch.bfloat16, h0_scale=1.0,
                proj_rank=rank, long_memory=True))
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

    def check_scan_bwd(self):
        """The scan's backward kernel on the forward's boundary states
        against `ssm_scan_ref_bwd`, each gradient's error over its largest
        |value| within ``BWD_TOL`` (dx in xr's dtype): falcon-mamba-7b's
        and hymba-1.5b's widths with the model's long-memory inputs at B 1
        x S 2048 and at the training shape B 2 x S 4096, xr bf16 and f32,
        hymba's width at every R, N 8, a ragged S, S 0, 1 and 5, nonzero
        h0 and dh_final (and none), B and C as column views of one
        projection, layouts that are not 16-byte aligned, and block
        counts that are not a multiple of the cluster (masked CTAs in the
        last cluster), each check naming the design that ran ("[R r,
        cluster k]"); two runs equal bit for bit; and the forward with its
        states giving y and h_final bit for bit as the forward without."""
        torch = self.torch
        from repro_torch.kernels.ssm_scan import ops as scan_ops
        from repro_torch.kernels.ssm_scan import (selective_scan,
                                                  selective_scan_bwd,
                                                  selective_scan_states,
                                                  ssm_scan_ref_bwd)
        name = SCAN_BWD["name"]
        g = self.gen(13)

        def check(what, ins, dh_final=True, R=0):
            B, S, di = ins[0].shape
            N = ins[4].shape[1]
            cfg = scan_ops.bwd_config(B, di, N, R=R, xdtype=ins[1].dtype)
            tag = (f"[R {cfg['states_per_thread']}{' forced' if R else ''}, "
                   f"cluster {cfg['cluster']}]")
            y, h = selective_scan(*ins)
            y1, h1, hs = selective_scan_states(*ins)
            if not (torch.equal(y, y1) and torch.equal(h, h1)):
                raise AssertionError(f"{name} {what}: the forward with its "
                                     f"states differs from the forward")
            dy = self.randn(g, (B, S, di), torch.float32)
            dhf = (self.randn(g, (B, di, N), torch.float32) if dh_final
                   else None)
            b0 = scan_ops.bwd_launches
            got = selective_scan_bwd(*ins[:5], hs, dy, dhf, R=R)
            if scan_ops.bwd_launches != b0 + (S > 0):
                raise AssertionError(f"{name} {what}: launches")
            want = ssm_scan_ref_bwd(*ins, dy, dhf)
            xd = "bf16" if ins[1].dtype == torch.bfloat16 else "f32"
            for gname, a, b in zip(("ddt", "dx", "dB", "dC", "dA", "dh0"),
                                   got, want):
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise AssertionError(f"{name} {what}: {gname} is "
                                         f"{a.dtype} {tuple(a.shape)}")
                if not a.numel():                   # S = 0
                    continue
                tol = BWD_TOL["bfloat16" if gname == "dx" and xd == "bf16"
                              else "float32"]
                self.compare_rel(name, f"{gname} {tag} xr {xd} {what}", a, b,
                                 tol)
            return ins[:5], hs, dy, dhf, got

        bf16 = torch.bfloat16
        for B, S, di, xdtype, rank, arch in [
                (1, 2048, 8192, bf16, 256, "falcon-mamba B=1 S=2048"),
                (2, 4096, 8192, bf16, 256, "falcon-mamba train B=2 S=4096"),
                (1, 2048, 3200, bf16, 100, "hymba B=1 S=2048"),
                (2, 4096, 3200, bf16, 100, "hymba train B=2 S=4096"),
                (1, 2048, 8192, None, 256, "falcon-mamba B=1 S=2048"),
                (2, 4096, 3200, None, 100, "hymba train B=2 S=4096"),
                # a mesh rank's channels: falcon over model 2, hymba over 4
                (2, 4096, 4096, bf16, 256,
                 "falcon-mamba mesh rank (model 2) B=2 S=4096"),
                (2, 4096, 800, bf16, 100,
                 "hymba mesh rank (model 4) B=2 S=4096")]:
            check(f"{arch} di={di} long memory, h0 and dh_final nonzero",
                  self.scan_inputs(g, B, S, di, xdtype=xdtype, h0_scale=1.0,
                                   proj_rank=rank, long_memory=True))
        # hymba's width at every R (R 4: 100 blocks, 13 clusters of 8, the
        # last with 4 masked CTAs)
        for R in scan_ops.BWD_PER_THREAD:
            check("hymba ragged S=1000 di=3200", self.scan_inputs(
                g, 2, 1000, 3200, xdtype=bf16, h0_scale=1.0, proj_rank=100,
                long_memory=True), R=R)
        check("N=8 B=2 S=1000 di=512", self.scan_inputs(
            g, 2, 1000, 512, N=8, xdtype=bf16, h0_scale=1.0, proj_rank=8,
            long_memory=True))
        check("dh_final None S=777 di=3200", self.scan_inputs(
            g, 1, 777, 3200, xdtype=bf16, h0_scale=1.0, long_memory=True),
            dh_final=False)
        # block counts that are not a multiple of the cluster: 11 blocks at
        # R 2 (one cluster of 8, one of 3 and 5 masked), 3 at R 4
        for di, R in ((176, 2), (80, 4)):
            check(f"di={di} ({-(-di // (8 * R))} blocks)", self.scan_inputs(
                g, 2, 300, di, xdtype=bf16, h0_scale=1.0, long_memory=True),
                R=R)
        # not 16-byte aligned: an odd di (201 blocks at R 2), and xr a view
        # at an odd offset
        check("odd di=3201", self.scan_inputs(
            g, 1, 2048, 3201, xdtype=bf16, h0_scale=1.0, long_memory=True))
        dt, _, Bm, Cm, A, h0 = self.scan_inputs(g, 1, 2048, 3200,
                                                h0_scale=1.0,
                                                long_memory=True)
        xr = self.randn(g, (1, 2048, 3201), bf16)[..., 1:]
        check("xr a view at offset 1 di=3200", (dt, xr, Bm, Cm, A, h0))
        for S in (0, 1, 5):
            check(f"S={S} di=3200", self.scan_inputs(
                g, 1, S, 3200, xdtype=bf16, h0_scale=1.0, long_memory=True))
        # two runs of one backward
        ins, hs, dy, dhf, got = check(
            "falcon-mamba train B=2 S=4096 di=8192 (determinism)",
            self.scan_inputs(g, 2, 4096, 8192, xdtype=bf16, h0_scale=1.0,
                             proj_rank=256, long_memory=True))
        again = selective_scan_bwd(*ins, hs, dy, dhf)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}: two runs of one backward differ")
        print(f"  {name:15s} two runs of one backward at B=2 S=4096 "
              f"di=8192: equal bit for bit")

    def phase_model(self):
        for arch in ARCHS + tuple(CUT) + EMBEDS:
            self.check_model(arch)

    def prompt_batch(self, cfg, B, S, seed):
        """A prefill batch of B x S and its tokens: tokens, or random bf16
        embeddings (``inputs_embeds``; an encoder-decoder's S source
        frames as ``src_embeds`` and the tokens as ``tgt_tokens``)."""
        torch = self.torch
        g = self.gen(seed)
        toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                             device=self.dev, generator=g)
        if not cfg.embed_input:
            return {"tokens": toks}, toks
        emb = self.randn(g, (B, S, cfg.d_model), torch.bfloat16)
        if cfg.is_encoder_decoder:
            return {"src_embeds": emb, "tgt_tokens": toks}, toks
        return {"inputs_embeds": emb}, toks

    def check_model(self, arch):
        """Two layers at full width (seamless-m4t-large-v2: 2 encoder and 2
        decoder layers), prompt 2048 (mixtral-8x22b's 8192; internvl2-2b
        from random bf16 embeddings; seamless from 2048 such source frames
        and a 2048-token target prefix): prefill and one decode step
        through the kernels against the plain path, the QKV biases
        (qwen2-72b) set to nonzero random values and, for the ``PINNED``
        archs, the MoE routing of the plain path held to the kernel path's
        at near-ties (`RoutePin`)."""
        torch = self.torch
        from repro_torch.configs import registry
        from repro_torch.models import Model, moe
        cfg = registry.get(arch).replace(num_layers=2)
        if cfg.is_encoder_decoder:
            cfg = cfg.replace(num_encoder_layers=2)
        prompt = CUT.get(arch, (0, PROMPT))[1]
        model = Model(cfg)
        params = model.init_params(self.gen(0))
        if cfg.attn_bias:
            g = self.gen(9)
            for name in ("bq", "bk", "bv"):
                leaf = params["layers"]["attn"][name]
                leaf.copy_(self.randn(g, tuple(leaf.shape), leaf.dtype))
        batch, toks = self.prompt_batch(cfg, 1, prompt, 2)
        pin = RoutePin(torch, moe) if arch in PINNED else None
        out = {}
        for plain in (False, True):
            with (contextlib.nullcontext() if pin is None
                  else pin.run(replay=plain)):
                logits, cache = model.prefill(params, batch, plain=plain)
                step, _ = model.decode_step(params, cache, toks[:, :1],
                                            plain=plain)
            out[plain] = (logits, step)
        extra = ((", QKV biases nonzero" if cfg.attn_bias else "")
                 + (f", window {cfg.sliding_window}" if cfg.sliding_window
                    else ""))
        if pin is not None:
            print(f"  {cfg.name} x2 layers prompt {prompt}: "
                  f"{len(pin.calls)} router calls, {pin.flips} tokens routed "
                  f"to other experts on the plain path at margins up to "
                  f"{max(pin.margins, default=0.0):.3e} (<= {ROUTE_TOL}), "
                  f"held to the kernel path's routing")
        for what, a, b in zip(("prefill logits", "decode logits"),
                              out[False], out[True]):
            err = (a - b).abs().max().item()
            ok = torch.allclose(a, b, atol=0.3, rtol=0.05)
            print(f"  {cfg.name} x2 layers prompt {prompt}{extra} {what}: "
                  f"kernel vs plain max_abs_err={err:.3e} (atol 0.3, rtol "
                  f"0.05) {'ok' if ok else 'FAIL'}")
            if not (ok and torch.isfinite(a).all()):
                raise AssertionError(f"{arch} {what}: kernel path disagrees")

    @staticmethod
    def counters():
        """Each kernel's launch count, by name, as an object whose
        ``launches`` reads and sets it."""
        from repro_torch.kernels.decode_attention import ops as decode_ops
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.ssm_scan import ops as scan_ops
        return {FLASH["name"]: flash_ops,
                FLASH_BWD["name"]: Counter(flash_ops, "bwd_launches"),
                DECODE["name"]: decode_ops,
                SCORES_HD["name"]: Counter(decode_ops, "scores_launches"),
                VALUES_HD["name"]: Counter(decode_ops, "values_launches"),
                SCAN["name"]: scan_ops,
                SCAN_BWD["name"]: Counter(scan_ops, "bwd_launches")}

    @staticmethod
    def dry_cell(arch, shape, layers=None):
        """`repro_torch.launch.dryrun.build_cell` of ``arch`` (cut to
        ``layers`` layers, if given) at ``shape`` on a mesh of one device:
        the step's inputs and their bytes, without a meta pass (the
        passes run in the host's "dry run" phase only)."""
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_debug_mesh
        return dryrun.build_cell(arch, shape, extra=(
            {"num_layers": layers} if layers else None),
            mesh=make_debug_mesh())

    def check_dry_params(self, arch, layers, param_bytes):
        """The dry run's param bytes of ``arch`` (cut to ``layers``) at a
        mesh of one device equal to the params on the card."""
        dry_params = self.dry_cell(arch, "decode_32k",
                                   layers).argument_bytes()["params"]
        print(f"  {arch}: the dry run's params at a mesh of one device "
              f"{dry_params} B, the params on the card {param_bytes} B "
              f"(serialize.tree_nbytes)")
        if dry_params != param_bytes:
            raise AssertionError(f"{arch}: the dry run counts {dry_params} B "
                                 f"of params, the card holds {param_bytes}")

    def held(self):
        """(allocated, requested) bytes of the caching allocator, after a
        collection and with cuBLAS's workspaces freed: each allocation
        counted at its block's size, and at the size it asked for."""
        torch = self.torch
        gc.collect()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        return (torch.cuda.memory_allocated(),
                torch.cuda.memory_stats()["requested_bytes.all.current"])

    def block_sizes(self, tensors):
        """(the sum of the caching allocator's blocks under the tensors'
        storages, their count, how many are 512 B or more over their
        storage), from the allocator's snapshot (a block's address is its
        segment's plus the sizes of the blocks before it)."""
        blocks = {}
        for seg in self.torch.cuda.memory_snapshot():
            addr = seg["address"]
            for b in seg["blocks"]:
                if b["state"] == "active_allocated":
                    blocks[addr] = b["size"]
                addr += b["size"]
        ptrs = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}
        missing = [hex(p) for p in ptrs if p not in blocks]
        if missing:
            raise AssertionError(f"no allocator block at {missing[:4]}")
        return (sum(blocks[p] for p in ptrs), len(ptrs),
                sum(blocks[p] - n >= 512 for p, n in ptrs.items()))

    def serve_path(self, arch):
        """Serve ``arch`` at full width, check the run, trace one replica,
        and free the server before the next path. An arch of ``ARCHS``
        runs through the serve driver's ``main`` at its published depth;
        one of ``CUT`` through `serve.run` on a server of its cut config
        and prompt."""
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
        layers, prompt = CUT.get(arch, (None, PROMPT))
        expect = registry.get(arch)
        for mod in counters.values():
            mod.launches = 0
        if layers is None:
            result = serve.main(["--arch", arch, "--prompt-len", str(prompt),
                                 "--requests", str(REQUESTS), "--gen",
                                 str(GEN), "--replicas", str(REPLICAS)])
        else:
            expect = expect.replace(num_layers=layers)
            result = serve.run(serve.NexusModelServer(
                expect, replicas=REPLICAS, prompt_len=prompt), REQUESTS, GEN)
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
        if cfg != expect:
            raise AssertionError(f"the serve run was not {arch} at full "
                                 f"width, {expect.num_layers} layers")
        params = server.instances[0].params
        if any(inst.params is not params for inst in server.instances):
            raise AssertionError("the replicas do not share one params copy")
        leaves = serialize.leaves(params)
        n_params = sum(x.numel() for x in leaves)
        param_bytes = serialize.tree_nbytes(params)
        print(f"  {arch}: {cfg.num_layers} of {registry.get(arch).num_layers}"
              f" layers, prompt {prompt}, {n_params} parameters "
              f"({param_bytes / 1e9:.2f} GB) on {leaves[0].device}; peak "
              f"{peak / 1e9:.2f} GB ({nvidia_smi()})")
        if n_params != cfg.param_count() or leaves[0].device.type != "cuda":
            raise AssertionError(f"{arch}: the params on the card are not "
                                 f"the full model")
        self.check_dry_params(arch, layers, param_bytes)
        if peak > 1.5 * param_bytes:
            raise AssertionError(f"{arch}: peak {peak} bytes for "
                                 f"{param_bytes} bytes of params: more than "
                                 f"one params copy?")
        del params, leaves
        L = cfg.num_layers
        attn = cfg.family in ("dense", "moe", "hybrid")
        ssm = cfg.family in ("ssm", "hybrid")
        want = every_kernel({
            FLASH["name"]: L * (REQUESTS + REPLICAS) if attn else 0,
            DECODE["name"]: L * (REQUESTS * GEN + REPLICAS) if attn else 0,
            SCAN["name"]: L * (REQUESTS + REPLICAS) if ssm else 0})
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
        self.trace(server, prompt_len=prompt)
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

    def trace(self, server, prompt_len):
        """One replica of a served model: `trace_model` on request 0's
        prompt."""
        torch = self.torch
        import numpy as np
        inst = server.instances[0]
        prompt = np.frombuffer(server.store.get("prompts", "req-0"), np.int32)
        toks = torch.from_numpy(prompt.copy())[None].to(self.dev)
        self.trace_model(server.cfg.name, inst.model, inst.params,
                         {"tokens": toks}, prompt_len)

    def trace_model(self, name, model, params, batch, prompt_len):
        """Where a request's time goes on one replica: host wall time of
        prefill and of a decode step (synchronised), and the kernel time
        torch.profiler sees in each; the rest of the wall time the
        device sits idle, waiting on the host."""
        torch = self.torch
        steps = 8
        state = {}

        def prefill():
            state["logits"], state["cache"] = model.prefill(params, batch)

        def decode():
            for _ in range(steps):
                tok = state["logits"][:, -1:].argmax(dim=-1).to(torch.int32)
                state["logits"], state["cache"] = model.decode_step(
                    params, state["cache"], tok)

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
            print(f"  {name}, one replica, prompt {prompt_len}, "
                  f"{what}: wall {wall_ms:.2f} ms, kernel time {dev_ms:.2f} ms in "
                  f"{launches:.0f} kernels, device idle share "
                  f"{1 - dev_ms / wall_ms:.3f}")
            for e in top[:12]:
                print(f"    {e.self_device_time_total / 1e3 / n:8.3f} ms "
                      f"{e.count / n:6.0f}x  {e.key[:80]}")

    def embeds_path(self, arch):
        """An arch of ``EMBEDS`` at full width and depth through the `Model`
        facade (its entry point; the serve driver refuses it), seed-0
        params on the card: at each of ``EMBEDS_BATCHES`` a prefill of
        ``PROMPT`` positions from random bf16 embeddings, then ``GEN``
        greedy decode steps, with exact launch counts (every count set to
        0 just before the run and read just after), prefill and decode
        wall, tok/s and peak device memory; the B 1 run replayed through
        the plain path on its tokens, logits compared at each step (atol
        0.3, rtol 0.05); one replica traced. Each batch size is warmed by
        one prefill and one decode step before its run."""
        torch = self.torch
        from repro_torch.configs import registry
        from repro_torch.models import Model, serialize
        gc.collect()
        torch.cuda.empty_cache()
        cfg = registry.get(arch)
        model = Model(cfg)
        params = model.init_params()
        leaves = serialize.leaves(params)
        n_params = sum(x.numel() for x in leaves)
        param_bytes = serialize.tree_nbytes(params)
        print(f"  {arch}: {n_params} parameters ({param_bytes / 1e9:.2f} GB) "
              f"on {leaves[0].device} ({nvidia_smi()})")
        if n_params != cfg.param_count() or leaves[0].device.type != "cuda":
            raise AssertionError(f"{arch}: the params on the card are not "
                                 f"the full model")
        self.check_dry_params(arch, None, param_bytes)
        del leaves
        L = cfg.num_layers
        if cfg.is_encoder_decoder:      # encoder, decoder and cross layers
            per_prefill, per_step = cfg.num_encoder_layers + 2 * L, 2 * L
        else:
            per_prefill, per_step = L, L
        counters = self.counters()
        want = every_kernel({FLASH["name"]: per_prefill,
                             DECODE["name"]: per_step * GEN})
        first = None
        for B in EMBEDS_BATCHES:
            batch, toks = self.prompt_batch(cfg, B, PROMPT, 20 + B)
            # warm: the first calls at a shape pick their GEMM algorithms
            _, cache = model.prefill(params, batch)
            model.decode_step(params, cache, toks[:, :1])
            del cache
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for mod in counters.values():
                mod.launches = 0
            run = self.generate(model, params, batch)
            launches = {name: mod.launches for name, mod in counters.items()}
            self.launches[f"{arch} B={B}"] = launches
            peak = torch.cuda.max_memory_allocated()
            wall = run["prefill_s"] + GEN * run["step_s"]
            print(f"  {arch} B={B} prompt {PROMPT} + {GEN} greedy steps: "
                  f"prefill {run['prefill_s'] * 1e3:.1f} ms, decode step "
                  f"{run['step_s'] * 1e3:.2f} ms, tok/s={B * GEN / wall:.2f}, "
                  f"max_memory_allocated={peak / 1e9:.2f} GB, "
                  f"launches={launches}")
            if launches != want:
                raise AssertionError(f"{arch} B={B} launch counts {launches} "
                                     f"!= {want}")
            for i, logits in enumerate(run["logits"]):
                if logits.shape != (B, 1, cfg.vocab_size) or not bool(
                        torch.isfinite(logits).all()):
                    raise AssertionError(f"{arch} B={B} call {i}: logits "
                                         f"{tuple(logits.shape)}, not finite "
                                         f"or of the wrong shape")
            if first is None:
                first = (batch, run)
        batch, run = first
        for mod in counters.values():
            mod.launches = 0
        plain = self.generate(model, params, batch, plain=True,
                              tokens=run["tokens"])
        if any(mod.launches for mod in counters.values()):
            raise AssertionError("the plain replay launched a kernel")
        worst = 0.0
        for i, (a, b) in enumerate(zip(run["logits"], plain["logits"])):
            err = (a - b).abs().max().item()
            worst = max(worst, err)
            if not torch.allclose(a, b, atol=0.3, rtol=0.05):
                raise AssertionError(f"{arch} B=1 call {i}: kernel path "
                                     f"against plain path max_abs_err "
                                     f"{err:.3e} (atol 0.3, rtol 0.05)")
        print(f"  {arch} B=1 replayed on the plain path: prefill and {GEN} "
              f"steps, logits max_abs_err={worst:.3e} (atol 0.3, rtol 0.05) "
              f"ok")
        self.trace_model(cfg.name, model, params, batch, PROMPT)
        del params, batch, run, plain, first
        gc.collect()
        torch.cuda.empty_cache()

    def generate(self, model, params, batch, plain=False, tokens=None):
        """Prefill, then ``GEN`` decode steps, each feeding the greedy
        token (or, given ``tokens``, that step's row of them); the logits
        of every call, the tokens fed, and the synchronised host wall time
        of the prefill and of one decode step (their mean)."""
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, plain=plain)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, fed = [logits], []
        for i in range(GEN):
            tok = (logits[:, -1:].argmax(dim=-1).to(torch.int32)
                   if tokens is None else tokens[i])
            fed.append(tok)
            logits, cache = model.decode_step(params, cache, tok, plain=plain)
            out.append(logits)
        torch.cuda.synchronize()
        return {"logits": out, "tokens": fed, "prefill_s": t1 - t0,
                "step_s": (time.perf_counter() - t1) / GEN}

    def profile(self, fn):
        """Total kernel time (ms) and kernel count of fn() under
        torch.profiler, and the kernel rows by time."""
        out = {}
        with self.profiled(out):
            fn()
        return out["ms"], out["count"], out["rows"]

    @contextlib.contextmanager
    def profiled(self, out):
        """torch.profiler around the block; fills ``out`` with the total
        kernel time (ms), the kernel count and the kernel rows by time."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        # device-side rows only (CPU operators also carry the time of the
        # kernels they launch); "Command Buffer Full" is a launch-queue
        # stall marker, not a kernel
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.key != "Command Buffer Full"]
        rows.sort(key=lambda e: -e.self_device_time_total)
        out.update(ms=sum(e.self_device_time_total for e in rows) / 1e3,
                   count=sum(e.count for e in rows), rows=rows)

    # -------------------------------------------------------------- train
    def phase_train(self):
        """Each arch of ``TRAIN_RUNS`` trained through `launch/train.run`;
        then kernel path against plain path on a 2-layer model of each;
        then a checkpoint round trip at smoke size."""
        self.train_summary = {}
        for arch, layers in TRAIN_RUNS:
            self.train_full(arch, layers)
        for arch, _ in TRAIN_RUNS:
            self.train_against_plain(arch)
        self.train_checkpoint_round_trip()

    @staticmethod
    def train_launches(cfg, steps, recompute):
        """The kernel launches of ``steps`` train steps of ``cfg``: per
        layer each forward kernel once and again in the remat recompute,
        each backward kernel once."""
        L = cfg.num_layers
        attn = cfg.family in ("dense", "vlm", "moe", "hybrid")
        ssm = cfg.family in ("ssm", "hybrid")
        return every_kernel({
            FLASH["name"]: steps * L * (1 + recompute) if attn else 0,
            FLASH_BWD["name"]: steps * L if attn else 0,
            SCAN["name"]: steps * L * (1 + recompute) if ssm else 0,
            SCAN_BWD["name"]: steps * L if ssm else 0})

    def train_full(self, arch, layers):
        """``TRAIN_STEPS`` AdamW steps of B ``TRAIN_BATCH`` x S
        ``TRAIN_SEQ`` on ``arch`` (full width, ``layers`` of its layers or
        all, bf16, seed-0 init), fed by SyntheticCorpus -> DataPipeline ->
        the port's NexusBackend: loss and grad norm per step (finite),
        step wall and device time, tokens/s, mfu (6 x the matmul params x
        tokens, plus the causal, windowed attention's), peak device memory
        and host RSS, exact launches of every kernel (the forwards, their
        recompute under the remat policy, the backwards), and a
        torch.profiler trace of step ``TRAIN_TRACED`` with the train
        kernels' rows."""
        torch = self.torch
        from repro_torch.configs import InputShape, registry
        from repro_torch.launch import train
        from repro_torch.models import serialize
        from repro_torch.models.flops import model_flops
        gc.collect()
        torch.cuda.empty_cache()
        cfg = registry.get(arch)
        full_depth = cfg.num_layers
        if layers:
            cfg = cfg.replace(num_layers=layers)
        B, S, L = TRAIN_BATCH, TRAIN_SEQ, cfg.num_layers
        n_params = cfg.param_count()
        # the embedding table is a gather, not a product, unless it is
        # also the head
        n_matmul = n_params - (0 if cfg.tie_embeddings
                               else cfg.vocab_size * cfg.d_model)
        print(f"  {cfg.name} x{L} of {full_depth}: {n_params} parameters "
              f"({2 * n_params / 1e9:.2f} GB in bf16; params, grads, f32 mu "
              f"and nu {12 * n_params / 1e9:.2f} GB), remat "
              f"{cfg.remat_policy!r}, B {B} x S {S}; before the phase "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        trace = {}

        def step_context(step):
            return (self.profiled(trace) if step == TRAIN_TRACED
                    else contextlib.nullcontext())

        counters = self.counters()
        before = self.held()
        torch.cuda.reset_peak_memory_stats()
        for mod in counters.values():
            mod.launches = 0
        with RssSampler() as rss:
            result = train.run(cfg, steps=TRAIN_STEPS, batch=B, seq=S,
                               ckpt_every=TRAIN_STEPS + 1, device="cuda",
                               step_context=step_context)
        launches = {n: m.launches for n, m in counters.items()}
        state = result.pop("state")
        path = f"train {cfg.name} x{L}"
        self.launches[path] = launches
        peak = torch.cuda.max_memory_allocated()
        recompute = 0 if cfg.remat_policy == "none" else 1
        want = self.train_launches(cfg, TRAIN_STEPS, recompute)
        window = cfg.sliding_window or S
        pairs = sum(min(i + 1, window) for i in range(S)) if cfg.num_heads \
            and cfg.family != "ssm" else 0
        flops = 6 * n_matmul * B * S + 12 * B * cfg.num_heads \
            * cfg.head_dim * pairs * L
        for r in result["records"]:
            dev_s = r["device_s"]
            print(f"  {path} step {r['step']}: loss {r['loss']:.6f} grad_norm "
                  f"{r['grad_norm']:.6f}; wall {r['wall_s'] * 1e3:.1f} ms, "
                  f"device {dev_s * 1e3:.1f} ms, {B * S / r['wall_s']:.1f} "
                  f"tokens/s, mfu {flops / r['wall_s'] / BF16_FLOPS_PER_S:.4f}"
                  f" (wall) {flops / dev_s / BF16_FLOPS_PER_S:.4f} (device)")
        print(f"  {path}: model FLOPs per step {flops:.4e} (6 x {n_matmul} "
              f"matmul params x {B * S} tokens + attention 12 B H hd x "
              f"{pairs} visible pairs x L), mfu against "
              f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s dense bf16; peak device "
              f"memory {peak / 1e9:.2f} GB; host RSS {rss.start / 2**30:.2f} "
              f"GiB at the start, peak {rss.peak / 2**30:.2f} GiB; launches "
              f"{launches} ({nvidia_smi()})")
        steady = [r["wall_s"] for r in result["records"][1:]
                  if r["step"] != TRAIN_TRACED] or [result["records"][-1][
                      "wall_s"]]
        wall_ms = 1e3 * sum(steady) / len(steady)
        print(f"  {path} step {TRAIN_TRACED} traced: kernel time "
              f"{trace['ms']:.1f} ms in {trace['count']} kernels against the "
              f"untraced steps' mean wall {wall_ms:.1f} ms: device idle share "
              f"{1 - trace['ms'] / wall_ms:.3f}")
        for e in trace["rows"][:15]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x  {e.key[:90]}")
        ours = [e for e in trace["rows"]
                if any(k in e.key for k in TRAIN_KERNELS)]
        print(f"  {path} step {TRAIN_TRACED}: the port's kernels "
              f"{sum(e.self_device_time_total for e in ours) / 1e3:.3f} ms "
              f"of {trace['ms']:.1f} ms:")
        for e in ours:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x  {e.key[:90]}")
        if launches != want:
            raise AssertionError(f"{path}: launches {launches} != {want}")
        if len(result["records"]) != TRAIN_STEPS or not all(
                math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in result["records"]):
            raise AssertionError(f"{path}: not {TRAIN_STEPS} finite steps")
        if serialize.leaves(state.params)[0].device.type != "cuda":
            raise AssertionError(f"{path}: the params are not on the card")
        shape = InputShape("train", S, B, "train")
        mf = model_flops(cfg, shape)["total"]
        dev_ms = 1e3 * sum(r["device_s"] for r in result["records"][1:]
                           if r["step"] != TRAIN_TRACED) / max(1, sum(
                               1 for r in result["records"][1:]
                               if r["step"] != TRAIN_TRACED))
        print(f"  {path}: model_flops(cfg, {shape}) total {mf:.4e} "
              f"(repro_torch.models.flops) against the count above "
              f"{flops:.4e}: ratio {mf / flops:.4f}; mfu by model_flops "
              f"{mf / (wall_ms / 1e3) / BF16_FLOPS_PER_S:.4f} (wall) "
              f"{mf / (dev_ms / 1e3) / BF16_FLOPS_PER_S:.4f} (device), by "
              f"the count above {flops / (wall_ms / 1e3) / BF16_FLOPS_PER_S:.4f}"
              f" (wall) {flops / (dev_ms / 1e3) / BF16_FLOPS_PER_S:.4f} "
              f"(device), over the untraced steps' mean wall {wall_ms:.1f} ms "
              f"and device {dev_ms:.1f} ms ({nvidia_smi()})")
        self.train_summary[path] = {
            "records": result["records"], "peak": peak, "rss_peak": rss.peak,
            "flops": flops, "model_flops": mf, "trace_ms": trace["ms"],
            "wall_ms": wall_ms, "device_ms": dev_ms}
        del result, trace
        self.train_state_bytes(path, arch, layers, state, before)
        del state
        gc.collect()
        torch.cuda.empty_cache()

    def train_state_bytes(self, path, arch, layers, state, before):
        """The dry run's train-state bytes of ``arch`` (cut to ``layers``)
        at B ``TRAIN_BATCH`` x S ``TRAIN_SEQ`` on a mesh of one
        device against what the card holds with only ``state`` alive, less
        what it held before `train.run` (``before``, from `held`): the
        requested bytes equal exactly, and the allocated bytes are the
        state's blocks, each its leaf rounded up by the allocator."""
        from repro_torch.configs import InputShape
        from repro_torch.parallel.placement import leaves_with_paths
        shape = InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train")
        cell = self.dry_cell(arch, shape, layers)
        dry = cell.argument_bytes()["state"]
        dry_leaves = len(leaves_with_paths(cell.args["state"]))
        alloc, req = self.held()
        held, asked = alloc - before[0], req - before[1]
        leaves = [t for _, t in leaves_with_paths(state)]
        blocks, n_blocks, wide = self.block_sizes(leaves)
        print(f"  {path}: train state by the dry run {dry} B in "
              f"{dry_leaves} leaves ({cell.mesh.name}, {cell.step}); "
              f"on the card {asked} B requested, {held} B allocated in "
              f"{len(leaves)} leaves, {n_blocks} blocks of {blocks} B: "
              f"{held - dry} B over the dry run, "
              f"{(held - dry) / n_blocks:.1f} B a block, {wide} blocks "
              f"512 B or more over their leaf ({nvidia_smi()})")
        self.train_summary[path].update(state_dry=dry, state_held=held,
                                        state_asked=asked,
                                        state_leaves=len(leaves))
        if asked != dry or len(leaves) != dry_leaves:
            raise AssertionError(f"{path}: the card holds {asked} B in "
                                 f"{len(leaves)} leaves beside the state, "
                                 f"the dry run counts {dry} B in "
                                 f"{dry_leaves}")
        if held != blocks:
            raise AssertionError(f"{path}: {held} B allocated, the state's "
                                 f"blocks are {blocks} B")

    def train_against_plain(self, arch):
        """A 2-layer full-width model of ``arch``, B 1 x S ``TRAIN_SEQ``:
        one train step on the kernel path and one on the plain path
        (``make_train_step(..., plain=True)``) from the same params and
        batch. The loss within 2e-2, and every gradient leaf, as the
        step's first moment (0.1 x the clipped gradient), within 5e-2 of
        its largest |value| (the bf16 tolerances of
        tests/test_torch_train.py). With a selective scan the config sets
        ``inner_remat``: the plain path's chunked scan then keeps one
        chunk's (B, 128, di, N) tensors at a time in its backward, not
        every chunk's (tens of GB a layer at falcon-mamba-7b's width); the
        kernel path does not read it."""
        torch = self.torch
        from repro_torch.configs import registry
        from repro_torch.models import Model, serialize
        from repro_torch.optim import adamw_init, make_train_step
        cfg = registry.get(arch).replace(num_layers=2)
        if cfg.family in ("ssm", "hybrid"):
            cfg = cfg.replace(inner_remat=True)
        model = Model(cfg)
        params = model.init_params(self.gen(0))
        toks = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ + 1),
                             dtype=torch.int32, device=self.dev,
                             generator=self.gen(31))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        names = [k for k, _ in _paths(params)]
        counters = self.counters()
        out = {}
        for plain in (True, False):         # the kernel path takes params
            state = adamw_init(params if not plain else
                               serialize.unflatten(params, [
                                   p.clone() for p in serialize.leaves(
                                       params)]))
            for mod in counters.values():
                mod.launches = 0
            state, metrics = make_train_step(model, plain=plain)(state,
                                                                 batch)
            path = f"train {cfg.name} x2 {'plain' if plain else 'kernel'}"
            self.launches[path] = {n: m.launches
                                   for n, m in counters.items()}
            out[plain] = (metrics, serialize.leaves(state.mu))
            print(f"  {path}: loss {float(metrics['loss']):.6f} grad_norm "
                  f"{float(metrics['grad_norm']):.6f}, launches "
                  f"{self.launches[path]}")
            del state
        if any(self.launches[f"train {cfg.name} x2 plain"].values()):
            raise AssertionError("the plain path launched a kernel")
        want = self.train_launches(cfg, 1, cfg.remat_policy != "none")
        if self.launches[f"train {cfg.name} x2 kernel"] != want:
            raise AssertionError(f"train {cfg.name} kernel path: launches != "
                                 f"{want}")
        err = abs(float(out[False][0]["loss"]) - float(out[True][0]["loss"]))
        worst, bad = 0.0, []
        for name, a, b in zip(names, out[False][1], out[True][1]):
            scale = b.abs().max().item()
            rel = (a - b).abs().max().item() / max(scale, 1e-30)
            worst = max(worst, rel)
            if rel > 5e-2 or not bool(torch.isfinite(a).all()):
                bad.append((name, rel))
        print(f"  train {cfg.name} x2 B=1 S={TRAIN_SEQ}: kernel vs plain loss "
              f"diff {err:.3e} (atol 2e-2), worst gradient leaf "
              f"{worst:.3e} of its max (5e-2) over {len(names)} leaves "
              f"{'ok' if err <= 2e-2 and not bad else 'FAIL'}")
        if err > 2e-2 or bad:
            raise AssertionError(f"train {cfg.name} kernel vs plain: loss "
                                 f"diff {err}, leaves {bad}")
        del params, out
        gc.collect()
        torch.cuda.empty_cache()

    def train_checkpoint_round_trip(self):
        """llama3-8b smoke on the card: 2 steps with a checkpoint at step 2
        through the port's AsyncCheckpointer (``wait()`` inside `run`),
        then a run with ``--resume`` semantics on the same store restores
        it; the restored state equals the saved one bit for bit."""
        torch = self.torch
        from repro_torch.checkpoint.ckpt import _items
        from repro_torch.configs import registry
        from repro_torch.launch import train
        cfg = registry.get_smoke("llama3-8b")
        runtime = train.build_runtime()
        counters = self.counters()
        for mod in counters.values():
            mod.launches = 0
        saved = train.run(cfg, steps=2, batch=2, seq=64, ckpt_every=2,
                          device="cuda", runtime=runtime)
        restored = train.run(cfg, steps=0, batch=2, seq=64, resume=True,
                             device="cuda", runtime=runtime)
        path = f"train {cfg.name} checkpoint round trip"
        self.launches[path] = {n: m.launches for n, m in counters.items()}
        a, b = (dict(_items(r["state"])) for r in (saved, restored))
        objects = runtime[0].list_bucket("ckpts")
        same = (list(a) == list(b) and all(
            x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
            for x, y in zip(a.values(), b.values())))
        print(f"  {path}: {len(objects)} objects in the bucket, restored at "
              f"step {restored['start_step']} into {len(b)} leaves on "
              f"{b['params/embed'].device}: "
              f"{'equal bit for bit' if same else 'DIFFERENT'}; launches "
              f"{self.launches[path]}")
        if restored["start_step"] != 2 or int(b["step"]) != 2 or not same:
            raise AssertionError(f"{path}: the restored state differs")

    def phase_train_mesh(self):
        """Each arch of ``MESH_RUNS`` at full width, cut to its layers,
        trained ``MESH_STEPS`` steps through ``train.run`` on each of its
        meshes, against the same steps on one
        rank of the card (`one_rank_run`): every step's loss and grad
        norm, and each post-step params leaf over every rank's shard of
        it, within the bf16 tolerances of tests/test_torch_train.py; each
        rank's train state on the card against the dry run's state bytes
        on that mesh, exactly in requested bytes; exact launches of
        the family's attention and scan kernels on each rank's local
        heads and channels; the model-axis gathers by path; step wall and
        device time and the collectives by kind, bytes and seconds, with a
        reduce-scatter in every step of a run whose placement gathers (the
        backward of every gather). The moe family also:
        each step's load-balancing loss against one rank's (within
        ``MESH_LEAF_TOL`` of it), and its routing (`RouteLog`) on one
        rank and on each rank: assignments kept and dropped a layer,
        those whose expert differs from one rank's, and the largest
        router margin among them (at most ``ROUTE_TOL``); kept and
        dropped equal to one rank's in every call. Every one-rank
        run comes first; then one spawn of `mesh_ranks` a count of ranks
        trains each of its runs in turn (the ranks' start-up once a
        count, not once a run) and makes a sharded checkpoint's round
        trip (`mesh_checkpoint`)."""
        torch = self.torch
        import tempfile
        cards = torch.cuda.device_count()
        os.environ["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT), str(SRC), os.environ.get("PYTHONPATH", "")])
        tmp = tempfile.mkdtemp(prefix="mesh-")
        by_count, serves = {}, {}
        # the one-rank references are written to disk by one thread of
        # their own while the phase goes on: the next runs, and the
        # spawns, whose ranks wait for a run's file only when they check
        # against it (`wait_for_file`); torch.save without the CRC-32
        # (`no_crc32`) releases the GIL while it writes
        writer = concurrent.futures.ThreadPoolExecutor(1)
        try:
            for arch, layers, shapes in MESH_RUNS:
                run = self.one_rank_run(arch, layers, tmp, writer)
                for shape in shapes:
                    by_count.setdefault(math.prod(shape), []).append(
                        {**run, "shape": shape})
            for arch, layers, shapes, *cut in MESH_SERVE_RUNS:
                one = self.one_rank_serve(arch, layers)
                for shape in shapes:
                    serves.setdefault(math.prod(shape), []).append(
                        {**one, "shape": shape,
                         "steps": serve_steps(shape, *cut)})
            bad = []
            for n in sorted(set(by_count) | set(serves)):
                bad += self.train_mesh(n, cards, by_count.get(n, []),
                                       serves.get(n, []))
            for run in (r for runs in by_count.values() for r in runs):
                run["saved"].result()            # raises a failed save
        finally:
            writer.shutdown(wait=True)
            shutil.rmtree(tmp, ignore_errors=True)
        if bad:
            raise AssertionError(f"train and serve (mesh): {bad}")

    def one_rank_run(self, arch, layers, tmp, writer):
        """``MESH_STEPS`` steps of ``arch`` cut to ``layers`` on one rank
        of the card, its launches and, for the moe family, its routing;
        its params and first moments (and routing) saved under ``tmp``
        for the ranks, copied to the host here and written by ``writer``
        (one thread) while the phase goes on. Returns what `train_mesh`
        takes, ``saved`` the write's future."""
        torch = self.torch
        from repro_torch.configs import registry
        from repro_torch.launch import train
        from repro_torch.models import moe
        from repro_torch.parallel.placement import leaves_with_paths
        cfg = registry.get(arch).replace(num_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        counters = self.counters()
        for mod in counters.values():
            mod.launches = 0
        log = RouteLog(torch, moe)
        t0 = time.monotonic()
        with log.run() if cfg.family == "moe" else contextlib.nullcontext():
            one = train.run(cfg, steps=MESH_STEPS, batch=TRAIN_BATCH,
                            seq=TRAIN_SEQ, ckpt_every=MESH_STEPS + 1,
                            device="cuda")
        path = f"train (mesh) {arch} x{layers} one rank"
        print(f"  {path}: train.run {time.monotonic() - t0:.1f} s")
        self.launches[path] = {n: m.launches for n, m in counters.items()}
        for r in one["records"]:
            print(f"  {path} step {r['step']}: loss {r['loss']:.6f} "
                  f"grad_norm {r['grad_norm']:.6f} aux_loss "
                  f"{r['aux_loss']:.6e}; wall "
                  f"{r['wall_s'] * 1e3:.1f} ms, device "
                  f"{r['device_s'] * 1e3:.1f} ms ({nvidia_smi()})")
        self.print_routing(path, log.calls, layers)
        run = {"cfg": cfg, "records": one["records"], "routes": None,
               "route_calls": log.calls,
               "reference": str(Path(tmp) / f"{arch}-state.pt")}
        if log.experts:
            run["routes"] = str(Path(tmp) / f"{arch}-routes.pt")
            torch.save(log.experts, run["routes"])
        # the copy to the host stays on the phase's path: on a stream of
        # a thread of its own, it stalled the next runs on the card by as
        # long and held the leaves there meanwhile
        t0 = time.monotonic()
        host = {f"{name}/" + "/".join(map(str, p)): t.cpu()
                for name in ("params", "mu") for p, t in
                leaves_with_paths(getattr(one["state"], name))}
        copy_s = time.monotonic() - t0

        def save():
            t1 = time.monotonic()
            part = run["reference"] + ".part"
            with no_crc32():          # a file the ranks read once, at once
                torch.save(host, part)
            os.replace(part, run["reference"])
            print(f"  {path}: params and first moments saved for the ranks, "
                  f"{os.path.getsize(run['reference']) / 1e9:.2f} GB: copied "
                  f"to the host in {copy_s:.1f} s on the phase's path, "
                  f"written in {time.monotonic() - t1:.1f} s by a thread "
                  f"beside it, {shutil.disk_usage(tmp).free / 1e9:.0f} GB "
                  f"left there", flush=True)
            host.clear()
        run["saved"] = writer.submit(save)
        del one
        gc.collect()
        torch.cuda.empty_cache()
        return run

    def one_rank_serve(self, arch, layers):
        """``arch`` at full width cut to ``layers`` served on one rank of
        the card: a prefill of MESH_SERVE_BATCH x its prompt
        (`serve_batch`) and MESH_SERVE_STEPS greedy decode steps from
        `serve_params`, its walls, peak memory and launches. Returns what
        the ranks are held to: every step's logits, the tokens fed to the
        steps (each the argmax of the logits before it), for the ssm and
        hybrid families the f32 ``ssm`` state after the last step, on the
        host, and for the moe family its experts router call by router
        call (`RouteLog`), to which the ranks are pinned."""
        torch = self.torch
        from repro_torch.configs import registry
        from repro_torch.models import Model
        from repro_torch.models import moe
        cfg, _ = cut_config(arch, layers)
        gc.collect()
        torch.cuda.empty_cache()
        model = Model(cfg)
        params = serve_params(cfg, self.dev)
        batch = serve_batch(cfg, self.dev)
        log = RouteLog(torch, moe)
        counters = self.counters()
        for mod in counters.values():
            mod.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with log.run() if cfg.family == "moe" else contextlib.nullcontext():
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, batch)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            outs, tokens, step_s = [logits], [], []
            for _ in range(MESH_SERVE_STEPS):
                tokens.append(outs[-1].argmax(-1).to(torch.int32))
                t0 = time.perf_counter()
                logits, cache = model.decode_step(params, cache, tokens[-1])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                outs.append(logits)
        peak = torch.cuda.max_memory_allocated()
        path = f"serve (mesh) {arch} x{layers} one rank"
        self.launches[path] = {n: m.launches for n, m in counters.items()}
        print(f"  {path}: B {MESH_SERVE_BATCH} x prompt "
              f"{serve_len(arch)}, "
              f"{MESH_SERVE_STEPS} greedy steps: prefill "
              f"{prefill_s * 1e3:.1f} ms, decode step "
              f"{min(step_s) * 1e3:.2f}-{max(step_s) * 1e3:.2f} ms (median "
              f"{sorted(step_s)[len(step_s) // 2] * 1e3:.2f}); peak device "
              f"memory {peak / 1e9:.2f} GB; launches {self.launches[path]} "
              f"({nvidia_smi()})")
        res = {"cfg": cfg, "depth": registry.get(arch).num_layers,
               "prefill_s": prefill_s, "step_s": step_s,
               "peak": peak,
               "logits": torch.stack([o.cpu() for o in outs]),
               "tokens": torch.stack([t.cpu() for t in tokens]),
               "ssm": cache["ssm"].cpu() if "ssm" in cache else None,
               "routes": log.experts or None}
        del model, params, cache, outs, logits
        gc.collect()
        torch.cuda.empty_cache()
        return res

    def check_mesh_serve(self, one, ranks):
        """One serving run's results on the ranks of its mesh
        (`mesh_serve`'s) against its one-rank run (`one_rank_serve`'s):
        prints them and returns the checks that failed."""
        from repro_torch.launch import sharding as SH
        from repro_torch.launch.mesh import Mesh
        cfg, shape = one["cfg"], one["shape"]
        arch, L, steps = cfg.name, cfg.num_layers, one["steps"]
        attn = cfg.family != "ssm"          # the dense, moe and hybrid ones
        mamba = cfg.family in ("ssm", "hybrid")
        experts = cfg.family == "moe"
        xattn = int(cfg.is_encoder_decoder)  # the decoder's cross-attention
        rows = MESH_SERVE_BATCH // shape[0]
        # the embedding is summed over model where its vocab is split
        # there; where the guard leaves it whole (an odd vocab) each rank
        # looks its tokens up in its own copy
        emb = int(SH.param_spec("embed", (cfg.vocab_size, cfg.d_model),
                                Mesh(("data", "model"), shape))[0]
                  == "model")
        # the attention kernels on the rank's heads (an encoder-decoder's
        # encoder, decoder and cross-attention in the prefill, self and
        # cross in a decode step), the scan on its channels; a decode
        # step's sums over model: the split embedding, then each layer's
        # wo (and cross wo) and MLP (the experts' partial outputs in f32)
        # and/or x_proj (f32) and out_proj
        want = every_kernel({
            **({FLASH["name"]: L * (1 + xattn) + cfg.num_encoder_layers,
                SCORES_HD["name"]: L * steps * (1 + xattn),
                VALUES_HD["name"]: L * steps * (1 + xattn)} if attn else {}),
            **({SCAN["name"]: L} if mamba else {})})
        W = min(serve_len(arch), cfg.sliding_window or serve_len(arch))
        scores_b = (L * rows * cfg.num_heads * (W + xattn * serve_len(arch))
                    * 4 if attn else 0)
        sums = emb + L * (2 * attn + 2 * mamba + xattn)
        sums_b = ((emb + L * (2 * attn + mamba - experts + xattn)) * rows
                  * cfg.d_model * 2 + experts * L * rows * cfg.d_model * 4
                  + mamba * L * rows * (cfg.dt_rank + 2 * cfg.ssm_state) * 4)
        # the prefill's count gather: each layer's per-expert counts from
        # every data rank, where the data axes split the batch
        counts = L if experts and shape[0] > 1 else 0
        in_proj_b = mamba * L * rows * 2 * cfg.d_inner // shape[1] * 2
        where = f"serve (mesh) {arch} x{L} on {shape}"
        bad = []
        for r, res in enumerate(ranks):
            path = f"{where} rank {r}"
            self.launches[path] = res["launches"]
            st = res["step_s"]
            print(f"  {path} on {res['device']}: {res['local']}; prefill "
                  f"{res['prefill_s'] * 1e3:.1f} ms (one rank "
                  f"{one['prefill_s'] * 1e3:.1f}), to_decode_layout "
                  f"{res['reshard_s'] * 1e3:.1f} ms, decode step "
                  f"{min(st) * 1e3:.2f}-{max(st) * 1e3:.2f} ms (median "
                  f"{sorted(st)[len(st) // 2] * 1e3:.2f}; one rank median "
                  f"{sorted(one['step_s'])[MESH_SERVE_STEPS // 2] * 1e3:.2f}"
                  f"); peak "
                  f"device memory {res['peak'] / 1e9:.2f} GB (one rank "
                  f"{one['peak'] / 1e9:.2f}); {res['note']} ({nvidia_smi()})")
            for what, c in (("prefill", res["prefill_c"]),
                            ("to_decode_layout", res["reshard_c"]),
                            ("decode step 0", res["step_c"][0]),
                            ("decode step 1", res["step_c"][1])):
                print(f"  {path} {what} collectives: calls {c['calls']}, "
                      f"bytes {c['bytes_by']}, {c['host_s'] * 1e3:.1f} ms "
                      f"host" + ("" if c["device_s"] is None else
                                 f", {c['device_s'] * 1e3:.2f} ms device"))
            print(f"  {path} model-axis gathers: prefill "
                  f"{res['prefill_gathers']}, the decode steps "
                  f"{res['decode_gathers']}" + (
                      "" if res["state"] is None else
                      f"; the last step's f32 ssm state "
                      f"{res['state']['shape']} gathered over model against "
                      f"one rank's: max_abs_err {res['state']['err']:.3e} "
                      f"{'ok' if res['state']['close'] else 'FAIL'}"))
            coll_s = [c["host_s"] for c in res["step_c"]]
            score_s = [c["host_s_by"].get("score_all_reduce", 0.0)
                       for c in res["step_c"]]
            print(f"  {path}: the decode steps' wall {sum(st) * 1e3:.1f} ms "
                  f"over {steps} steps: collectives {sum(coll_s) * 1e3:.1f} "
                  f"ms host ({sum(coll_s) / sum(st):.3f} of it), the score "
                  f"all-reduce {sum(score_s) * 1e3:.1f} ms "
                  f"({sum(score_s) / sum(st):.3f} of it)")
            print(f"  {path}: logits against one rank's over "
                  f"{steps + 1} outputs: max_abs_err "
                  f"{max(res['errs']):.3e} (atol {MESH_SERVE_ATOL}, rtol "
                  f"{MESH_SERVE_RTOL}) {'ok' if res['close'] else 'FAIL'}; "
                  f"greedy tokens {res['compared']} compared (top-2 margin "
                  f"over the tolerance), {res['flips']} differ; score "
                  f"all-reduce {scores_b} B and in_proj exchange "
                  f"{in_proj_b} B a step; launches "
                  f"{res['launches']} (want {want}); params "
                  f"{res['bytes']['params']} B and decode cache "
                  f"{res['bytes']['cache']} B on the card, dry run "
                  f"{res['dry']['params']} B and {res['dry']['cache']} B "
                  f"({res['mesh']}); seconds {res['seconds']}")
            if not res["close"] or res["flips"]:
                bad.append((path, "logits or tokens", max(res["errs"]),
                            res["flips"]))
            if res["routing"] is not None:
                moved = sum(c["moved"] for c in res["routing"])
                margin = max(c["margin"] for c in res["routing"])
                print(f"  {path} routing: {len(res['routing'])} router "
                      f"calls (the prefill's {L}, then {L} a decode step), "
                      f"{moved} assignments pinned to one rank's experts, "
                      f"the largest router margin among them {margin:.3e} "
                      f"(at most {ROUTE_TOL})")
                if margin > ROUTE_TOL:
                    bad.append((path, "a route moved at margin", margin))
            if res["launches"] != want:
                bad.append((path, "launches", res["launches"]))
            if res["prefill_c"]["calls"].get("all_to_all", 0) != 2 * L * (
                    attn + xattn):
                bad.append((path, "prefill all_to_all", res["prefill_c"]))
            if res["prefill_c"]["calls"].get("count_all_gather", 0) != counts:
                bad.append((path, "prefill count gathers", res["prefill_c"]))
            for i, c in enumerate(res["step_c"]):
                calls, nb = c["calls"], c["bytes_by"]
                if (calls.get("all_to_all", 0) != 2 * L * (2 * attn + xattn)
                        or calls.get("score_all_reduce", 0) != L * (
                            attn + xattn)
                        or nb.get("score_all_reduce", 0) != scores_b
                        or calls.get("in_proj_all_to_all", 0) != L * mamba
                        or nb.get("in_proj_all_to_all", 0) != in_proj_b
                        or calls.get("all_reduce") != sums
                        or nb.get("all_reduce") != sums_b
                        or "count_all_gather" in calls):
                    bad.append((path, "decode step collectives", i, c))
                    break
            if "layers/mamba/in_proj" in res["decode_gathers"]:
                bad.append((path, "in_proj gathered in a decode step",
                            res["decode_gathers"]))
            if mamba and steps == MESH_SERVE_STEPS and (
                    res["state"] is None or not res["state"]["close"]):
                bad.append((path, "ssm state", res["state"]))
            if (res["bytes"]["params"], res["bytes"]["cache"]) != (
                    res["dry"]["params"], res["dry"]["cache"]):
                bad.append((path, "bytes", res["bytes"], res["dry"]))
        return bad

    @staticmethod
    def print_routing(path, calls, layers):
        """Each step's forward calls of the router (a `RouteLog`'s): the
        assignments each layer keeps and drops, and those whose expert
        differs from one rank's with their largest margin; each layer's
        remat recompute must route as its forward did. A step calls the
        router for layers 0 .. L-1, then, under remat, again for L-1 .. 0
        in the backward's recompute."""
        if not calls:
            return
        per_step = len(calls) // MESH_STEPS
        for j, c in enumerate(calls):
            j %= per_step
            c["layer"] = j if j < layers else per_step - 1 - j

        def key(c):
            return (c["kept"], c["dropped"], c["moved"], c["margin"],
                    c["counts"].tolist())
        for step in range(MESH_STEPS):
            run = calls[step * per_step:(step + 1) * per_step]
            fwd = {}
            for c in run:
                if c["layer"] in fwd and key(c) != key(fwd[c["layer"]]):
                    raise AssertionError(f"{path}: the recompute of layer "
                                         f"{c['layer']} routed otherwise")
                fwd.setdefault(c["layer"], c)
            print(f"  {path} step {step} routing: " + "; ".join(
                f"layer {l}: kept {c['kept']}, dropped {c['dropped']}, "
                f"moved {c['moved']} (margin {c['margin']:.3e})"
                for l, c in sorted(fwd.items()))
                  + f" ({len(run)} router calls, {layers} layers)")

    def train_mesh(self, n, cards, runs, serves):
        """One spawn of `mesh_ranks` on ``n`` ranks for the one-rank
        ``runs`` (`one_rank_run`'s, each with its mesh ``shape``), the
        checkpoint round trip and the serving runs ``serves``
        (`one_rank_serve`'s, each with its ``shape``); prints and returns
        the checks that failed."""
        from repro_torch.launch.ranks import spawn
        nccl = cards >= n
        backend = "nccl" if nccl else "gloo"
        names = ", ".join(f"{r['cfg'].name} x{r['cfg'].num_layers} on "
                          f"{r['shape']}" for r in runs)
        served = ", ".join(
            f"{r['cfg'].name} x{r['cfg'].num_layers} ({r['cfg'].num_layers}"
            f" of its {r['depth']} layers"
            + (", encoder and decoder each" if r["cfg"].is_encoder_decoder
               else "") + f") on {r['shape']}, {r['steps']} decode steps"
            + ("" if r["steps"] == MESH_SERVE_STEPS else
               f" (cut from {MESH_SERVE_STEPS}: FSDP over data gathers "
               f"every weight each step, ~6-7 s a step over gloo on one "
               f"card)")
            for r in serves)
        print(f"  train (mesh) {n} ranks: {cards} card(s) on this machine: "
              f"backend {backend}, "
              f"{'one card a rank' if nccl else 'every rank on card 0'}; "
              f"(data, model) meshes: {names} in turn, B {TRAIN_BATCH} x S "
              f"{TRAIN_SEQ}, {MESH_STEPS} steps; then a sharded "
              f"checkpoint's round trip; then serving {served}; B "
              f"{MESH_SERVE_BATCH} x prompt {PROMPT} (mixtral-8x22b "
              f"{serve_len('mixtral-8x22b')}; internvl2-2b's of bf16 "
              f"embeddings; seamless-m4t-large-v2's as many source frames "
              f"and target tokens), a prefill and the decode steps each",
              flush=True)
        t0 = time.monotonic()
        ranks = spawn("chip_smoke:mesh_ranks", n, {
            "runs": [{"arch": r["cfg"].name, "layers": r["cfg"].num_layers,
                      "shape": r["shape"], "reference": r["reference"],
                      "routes": r["routes"]} for r in runs],
            "shared": not nccl, "ckpt_shape": max(
                (r["shape"] for r in runs), key=lambda s: s[0]),
            "serves": [{"arch": r["cfg"].name,
                        "layers": r["cfg"].num_layers, "shape": r["shape"],
                        "logits": r["logits"][:r["steps"] + 1],
                        "tokens": r["tokens"][:r["steps"]],
                        # the state after one rank's last step
                        "ssm": (r["ssm"] if r["steps"] == MESH_SERVE_STEPS
                                else None),
                        "routes": r["routes"]}
                       for r in serves]},
            backend=backend,
            timeout_s=MESH_TIMEOUT_S, echo=True)
        print(f"  train (mesh) {n} ranks ({names}; serving {served}): spawn "
              f"to the last rank's end {time.monotonic() - t0:.1f} s")
        bad = []
        for i, run in enumerate(runs):
            bad += self.check_mesh_run(run, [res["runs"][i] for res in ranks])
        bad += self.check_mesh_checkpoint([res["ckpt"] for res in ranks])
        for i, one in enumerate(serves):
            bad += self.check_mesh_serve(one, [res["serves"][i]
                                               for res in ranks])
        return bad

    def check_mesh_run(self, run, ranks):
        """One arch's results on the ranks of its mesh against its
        one-rank ``run``: prints them and returns the checks that
        failed."""
        cfg, one_records = run["cfg"], run["records"]
        arch, L, shape = cfg.name, cfg.num_layers, run["shape"]
        want = self.train_launches(cfg, MESH_STEPS, 1)
        where = f"train (mesh) {arch} x{L} on {shape}"
        routing = (whole_batch_routing(ranks, shape[1], cfg)
                   if ranks[0]["routing"] is not None else None)
        bad = []
        for r, res in enumerate(ranks):
            path = f"{where} rank {r}"
            self.launches[path] = res["launches"]
            total = {"calls": {}, "bytes": 0, "host_s": 0.0,
                     "device_s": None}
            for rec, ref in zip(res["records"], one_records):
                c = rec["collectives"]
                dev_c = (f"{c['device_s'] * 1e3:.1f} ms device" if
                         c["device_s"] is not None else "no device events "
                         "(gloo through host memory)")
                print(f"  {path} step {rec['step']}: loss {rec['loss']:.6f} "
                      f"(one rank {ref['loss']:.6f}) grad_norm "
                      f"{rec['grad_norm']:.6f} ({ref['grad_norm']:.6f}) "
                      f"aux_loss {rec['aux_loss']:.6e} "
                      f"({ref['aux_loss']:.6e}); "
                      f"wall {rec['wall_s'] * 1e3:.1f} ms, device "
                      f"{rec['device_s'] * 1e3:.1f} ms; collectives "
                      f"{c['calls']}, {c['bytes'] / 1e9:.3f} GB, "
                      f"{c['host_s'] * 1e3:.1f} ms host, {dev_c}")
                if abs(rec["loss"] - ref["loss"]) > MESH_LOSS_TOL or abs(
                        rec["grad_norm"] - ref["grad_norm"]) > \
                        MESH_LEAF_TOL * ref["grad_norm"] or abs(
                        rec["aux_loss"] - ref["aux_loss"]) > \
                        MESH_LEAF_TOL * ref["aux_loss"]:
                    bad.append((path, rec["step"], "loss, grad norm or "
                                "aux loss"))
                if res["gathers_placement"] and not c["calls"].get(
                        "reduce_scatter"):
                    bad.append((path, rec["step"], "no reduce-scatter in a "
                                "step whose placement gathers"))
                for op, k in c["calls"].items():
                    total["calls"][op] = total["calls"].get(op, 0) + k
                total["bytes"] += c["bytes"]
                total["host_s"] += c["host_s"]
                if c["device_s"] is not None:
                    total["device_s"] = (total["device_s"] or 0.0) + c[
                        "device_s"]
            print(f"  {path}: collectives over {len(res['records'])} steps "
                  f"by kind {total['calls']}, {total['bytes'] / 1e9:.3f} GB, "
                  f"{total['host_s']:.3f} s host, " + (
                      "no device events (gloo through host memory)"
                      if total["device_s"] is None else
                      f"{total['device_s']:.4f} s device (NCCL)")
                  + f"; placement gathers: "
                  f"{'yes' if res['gathers_placement'] else 'no'} "
                  f"(FSDP over data: {'yes' if res['fsdp'] else 'no'}, "
                  f"model-axis gathers {res['gathers'] or 'none'})")
            if routing is not None:
                calls = routing[r]
                self.print_routing(path, calls, L)
                margin = max(c["margin"] for c in calls)
                if margin > ROUTE_TOL:
                    bad.append((path, "a route moved at margin", margin))
                kd = [(c["kept"], c["dropped"]) for c in calls]
                if kd != [(c["kept"], c["dropped"])
                          for c in run["route_calls"]]:
                    bad.append((path, "kept and dropped differ from one "
                                "rank's", kd))
            print(f"  {path}: seconds {res['seconds']} (imports, "
                  f"train.run, bytes and params checks)")
            print(f"  {path} on {res['device']}: {res['local']}; "
                  f"launches {res['launches']} (want {want}); train state "
                  f"{res['requested']} B requested on the card, dry run "
                  f"{res['dry']} B ({res['mesh']}); state bytes by rank "
                  f"{res['state_bytes']}; model-axis gathers "
                  f"{res['gathers'] or 'none'}; peak device memory "
                  f"{res['peak'] / 1e9:.2f} GB; {res['note']} "
                  f"({nvidia_smi()})")
            if res["launches"] != want:
                bad.append((path, "launches", res["launches"]))
            if res["requested"] != res["dry"]:
                bad.append((path, "state bytes", res["requested"],
                            res["dry"]))
        first = ranks[0]
        upd, mu = first["update_worst"], first["mu_worst"]
        print(f"  {where}: against one rank's, "
              f"leaf by leaf over every rank's shards: first moments' worst "
              f"leaf {mu[1]:.3e} of its largest |value| ({mu[0]}; "
              f"tolerance {MESH_LEAF_TOL}); params' update (params - init) "
              f"worst leaf {upd[1]:.3e} of one rank's update in norm "
              f"({upd[0]}; tolerance {MESH_UPDATE_TOL}), {first['moved']} "
              f"of {first['leaves']} leaves moved on one rank, the rest "
              f"equal to init on both")
        if mu[1] > MESH_LEAF_TOL:
            bad.append((where, "first moments", mu))
        if upd[1] > MESH_UPDATE_TOL:
            bad.append((where, "params update", upd))
        return bad

    def check_mesh_checkpoint(self, ranks):
        """Every rank's `mesh_checkpoint`: prints it and returns the
        checks that failed."""
        bad = []
        for r, res in enumerate(ranks):
            path = (f"train (mesh) llama3-8b smoke checkpoint on "
                    f"{res['shape']} rank {r}")
            self.launches[path] = res["launches"]
            print(f"  {path}: {res['objects']} objects in rank 0's bucket, "
                  f"restored at step {res['start_step']} into "
                  f"{res['leaves']} shards on {res['device']}: "
                  f"{'equal bit for bit' if res['same'] else 'DIFFERENT'} "
                  f"({res['seconds']:.1f} s; {res['note']})")
            if res["start_step"] != 2 or not res["same"]:
                bad.append((path, "the restored shards differ"))
        return bad

    def phase_mlserve(self):
        """The MLServe cores at tiny scale, then at full width cut to
        ``MLSERVE_FULL_LAYERS``: each role's scenarios from their seed
        payloads, kernel path against plain path on the same bytes."""
        torch = self.torch
        from repro_torch.models import serving
        for scale in MLSERVE_SCALES:
            for role, scenarios in MLSERVE.items():
                serving._bundle.cache_clear()
                gc.collect()
                torch.cuda.empty_cache()
                with (cut_bundle(role, MLSERVE_FULL_LAYERS[role])
                      if scale == "full" else contextlib.nullcontext()):
                    self.mlserve_role(role, scenarios, scale)
        serving._bundle.cache_clear()

    def mlserve_role(self, role, scenarios, scale):
        """One role's scenarios at one scale from payloads seeded once."""
        torch = self.torch
        from repro_torch.core import calibrate
        from repro_torch.models import serving
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
        # the plain replay runs its forward on the inputs the kernel run
        # decoded (its params, tokens and decode state), not on a second
        # decode of the payloads
        runs = {False: self.run_core(scenario, payloads, scale, False)}
        runs[True] = self.run_core(scenario, payloads, scale, True,
                                   decoded=runs[False].pop("decoded"))
        L = cfg.num_layers
        expect = every_kernel({
            FLASH["name"]: L if scenario != "LLM-DECODE" else 0,
            DECODE["name"]: L if scenario in ("LLM-COLD", "LLM-DECODE")
            else 0})
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
            decode = ("decode (reusing the kernel run's inputs)" if plain
                      else "decode")
            print(f"  {path} {'plain ' if plain else 'kernel'}: "
                  f"{sum(got)} B in, {len(run['body'])} B out; {decode} "
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
        """Where the codec's time goes, on the decode state: decode
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

    def run_core(self, scenario, payloads, scale, plain, decoded=None):
        """One core call: its output bytes (and token), the logits and
        token of each `_next_token` it took, its step times, launches and
        peaks. Without ``decoded`` the inputs the core decodes (its params
        from `serving._load_params`, then what it reads with
        `serialize.loads`: tokens or the decode state, cloned since a
        decode step updates it in place) are recorded and returned under
        ``"decoded"``; given them, the core's decode calls return them in
        the same order instead of decoding the payloads again (a sharded
        core still joins its shards first)."""
        torch = self.torch
        from repro_torch.models import serialize, serving
        counters = self.counters()
        for mod in counters.values():
            mod.launches = 0
        seen, timings = [], {}
        orig, load_params, loads = (serving._next_token,
                                    serving._load_params, serialize.loads)
        record, inside = [], [0]

        def spy(logits):
            tok = orig(logits)
            seen.append((logits[:, -1].float(), tok))
            return tok

        def clone(tree):
            if isinstance(tree, dict):
                return {k: clone(v) for k, v in tree.items()}
            if isinstance(tree, (tuple, list)):
                return type(tree)(clone(v) for v in tree)
            return tree.clone()

        def params_spy(*args, **kw):
            inside[0] += 1
            try:
                out = load_params(*args, **kw)
            finally:
                inside[0] -= 1
            record.append(out)
            return out

        def loads_spy(*args, **kw):
            out = loads(*args, **kw)
            if not inside[0]:
                record.append(clone(out))
            return out

        if decoded is not None:
            replay = iter(decoded)
            params_spy = loads_spy = lambda *args, **kw: next(replay)
        serving._next_token = spy
        serving._load_params, serialize.loads = params_spy, loads_spy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            out = serving.run_scenario(scenario, payloads, plain=plain,
                                       timings=timings)
        finally:
            serving._next_token = orig
            serving._load_params, serialize.loads = load_params, loads
        if decoded is not None and next(replay, None) is not None:
            raise AssertionError(f"{scenario}: the replay left decoded "
                                 f"inputs unread")
        token = None
        if scenario == "LLM-DECODE":
            out, token = out
        return {"body": out, "token": token, "seen": seen,
                "timings": timings,
                "launches": {n: m.launches for n, m in counters.items()},
                "peak": torch.cuda.max_memory_allocated(),
                "rss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                * 1024, **({"decoded": record} if decoded is None else {})}

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

    def phase_node(self):
        """The worker-node runtime (`repro_torch.core.runtime.WorkerNode`)
        running the MLServe handlers on the card: every scenario under all
        7 variants at tiny scale, then two of them under the
        FaultInjector; the paper suite and the scenarios; then llama3-8b
        LLM-PREFILL twice at full width under ``nexus`` with the
        SharedCache on."""
        from repro_torch.models import serving
        for role, scenarios in NODE_TINY.items():
            serving._bundle.cache_clear()
            seeded = serving.seed_role(role, scenarios, scale="tiny")
            for scenario in scenarios:
                payloads = seeded.pop(scenario)
                self.node_tiny(scenario, payloads)
                if scenario in FAULTED:
                    for system in FAULTED_SYSTEMS:
                        self.node_faulted(scenario, system, payloads)
        serving._bundle.cache_clear()
        self.node_suite()
        gc.collect()
        self.torch.cuda.empty_cache()
        self.node_full()

    def node_invoke(self, node, name, path):
        """One invocation with every launch count set to 0 just before it
        and read just after; returns the result and its durable output."""
        counters = self.counters()
        for mod in counters.values():
            mod.launches = 0
        res = node.invoke(name).result(timeout=NODE_TIMEOUT_S)
        self.launches[path] = {n: m.launches for n, m in counters.items()}
        return res, node.store.get("out", f"{res.invocation_id}-out")

    def node_tiny(self, scenario, payloads):
        """One scenario under every variant, a cold then a warm invocation
        each: outputs byte-identical across variants and invocations and
        equal to the kernel-path core called directly on the same bytes,
        with the core's kernel launches on every run."""
        from repro_torch.core.plan import SYSTEMS
        from repro_torch.core.runtime import WorkerNode
        from repro_torch.core.workloads import ml_suite
        from repro_torch.models import serving
        w = ml_suite("tiny")[scenario]
        direct = serving.run_scenario(scenario, payloads)
        body, token = direct if scenario == "LLM-DECODE" else (direct, None)
        L = serving._bundle(serving.SCENARIO_INPUTS[scenario][0],
                            "tiny")["cfg"].num_layers
        expect = every_kernel({
            FLASH["name"]: L if scenario != "LLM-DECODE" else 0,
            DECODE["name"]: L if scenario in ("LLM-COLD", "LLM-DECODE")
            else 0})
        for system in SYSTEMS:
            node = WorkerNode(system, byte_scale=1.0)
            try:
                node.deploy(w)
                node.seed_input(scenario, payloads=payloads)
                for want_cold in (True, False):
                    run = "cold" if want_cold else "warm"
                    path = f"node tiny {scenario} {system} {run}"
                    res, out = self.node_invoke(node, scenario, path)
                    groups = ", ".join(f"{g} {t * 1e3:.2f}"
                                       for g, t in res.breakdown.items())
                    print(f"  {path}: {res.latency_s * 1e3:.2f} ms; groups "
                          f"(ms) {groups}; launches {self.launches[path]}")
                    if res.cold != want_cold:
                        raise AssertionError(f"{path}: cold={res.cold}")
                    if out != body or res.response.get("token") != token:
                        raise AssertionError(f"{path}: the durable output "
                                             f"is not the core's")
                    if self.launches[path] != expect:
                        raise AssertionError(f"{path}: launches "
                                             f"{self.launches[path]} != "
                                             f"{expect}")
            finally:
                node.shutdown()
        print(f"  node tiny {scenario}: {len(body)} B out, byte-identical "
              f"across {len(SYSTEMS)} variants x cold/warm and equal to the "
              f"kernel-path core")

    def node_faulted(self, scenario, system, payloads):
        """One scenario under one variant at tiny scale, fault-free and
        then under the FaultInjector: one backend crash in the middle of
        the params GET (as the fault-free run timed it: under ``nexus``
        the backend's GET inside the ingress prefetch, under ``baseline``
        the guest's in-guest GET) and a storage-slow window over the run,
        the caller re-driving a failed invocation under the same
        invocation id. Exactly one success, the crash inside the faulted
        run's first params GET, and the durable output byte-equal to the
        fault-free run's."""
        from repro_torch.core.backend import NexusBackend
        from repro_torch.core.faults import (BACKEND_CRASH, STORAGE_SLOW,
                                             FaultInjector, FaultSchedule,
                                             FaultSpec)
        from repro_torch.core.frontend import BaselineClient
        from repro_torch.core.plan import SYSTEMS
        from repro_torch.core.runtime import WorkerNode
        from repro_torch.core.workloads import ml_suite
        w = ml_suite("tiny")[scenario]
        gets = []
        # the GET's whole storage call: the backend's authorized GET
        # (connect, transfer, SDK, token bucket) or the guest's. Both are
        # private methods of the copied `backend.py`/`frontend.py`; a
        # re-copy that moves the GET out of them must move this spy too.
        cls, attr = ((BaselineClient, "get_object") if SYSTEMS[system].coupled
                     else (NexusBackend, "_authorized_get"))
        call = getattr(cls, attr)

        def spy(obj, *args, **kw):
            key = kw.get("Key", args[-1] if args else None)
            t0 = time.monotonic()
            try:
                return call(obj, *args, **kw)
            finally:
                gets.append((key, t0, time.monotonic()))

        def run(schedule):
            node = WorkerNode(system, byte_scale=1.0,
                              plan_stall_timeout_s=30.0,
                              writeback_ack_timeout_s=0.5)
            gets.clear()
            counters = self.counters()
            for mod in counters.values():
                mod.launches = 0
            try:
                node.deploy(w)
                params_key = node.seed_input(scenario, payloads=payloads)[0]
                inj = (FaultInjector(node, schedule).start()
                       if schedule is not None else None)
                t0 = time.monotonic() - (inj.now() if inj is not None
                                         else 0.0)
                attempts, errors = 0, []
                try:
                    while True:
                        attempts += 1
                        try:
                            res = node.invoke(scenario, inv_id="faulted-0") \
                                .result(timeout=NODE_TIMEOUT_S)
                            break
                        except Exception as e:   # noqa: BLE001 — re-driven
                            errors.append(type(e).__name__)
                            if attempts >= 20:
                                raise
                            time.sleep(0.05)
                finally:
                    if inj is not None:
                        inj.stop()
                return {"res": res, "attempts": attempts, "errors": errors,
                        "out": node.store.get("out", "faulted-0-out"),
                        "params": [(a - t0, b - t0) for k, a, b in gets
                                   if k == params_key],
                        "stats": dict(inj.stats) if inj is not None else {},
                        "launches": {n: m.launches
                                     for n, m in counters.items()}}
            finally:
                node.shutdown()

        setattr(cls, attr, spy)
        try:
            clean = run(None)
            lo, hi = clean["params"][0]
            at = (lo + hi) / 2
            schedule = FaultSchedule((FaultSpec(BACKEND_CRASH, at),
                                      FaultSpec(STORAGE_SLOW, 0.0, 1.0, 6.0)))
            faulted = run(schedule)
        finally:
            setattr(cls, attr, call)
        path = f"node faults {scenario} {system}"
        self.launches[path] = faulted["launches"]
        print(f"  {path}: fault-free params GET [{lo * 1e3:.1f}, "
              f"{hi * 1e3:.1f}] ms, latency {clean['res'].latency_s * 1e3:.1f}"
              f" ms; crash at {at * 1e3:.1f} ms, storage 6x slower over "
              f"[0, 1000] ms: params GETs "
              f"{[(round(a * 1e3, 1), round(b * 1e3, 1)) for a, b in faulted['params']]}"
              f" ms, {faulted['attempts']} attempt(s) ({faulted['errors']}),"
              f" latency of the success {faulted['res'].latency_s * 1e3:.1f}"
              f" ms, injector {faulted['stats']}, launches "
              f"{faulted['launches']}")
        if clean["attempts"] != 1 or clean["errors"]:
            raise AssertionError(f"{path}: the fault-free run failed")
        if not any(a <= at < b for a, b in faulted["params"][:1]):
            raise AssertionError(f"{path}: the crash missed the params GET")
        if not SYSTEMS[system].coupled and faulted["stats"]["crashes"] != 1:
            raise AssertionError(f"{path}: the backend was not killed once")
        if faulted["out"] != clean["out"]:
            raise AssertionError(f"{path}: the durable output differs from "
                                 f"the fault-free run's")
        if faulted["launches"] != clean["launches"]:
            raise AssertionError(f"{path}: launches {faulted['launches']} != "
                                 f"the fault-free run's {clean['launches']}")

    def node_suite(self):
        """The paper suite and the multi-I/O scenarios, deployed by name
        under every variant and invoked all at once: no device work, the
        node's other traffic in the process that runs the card's, outputs
        byte-identical across the variants."""
        from repro_torch.core.plan import SYSTEMS
        from repro_torch.core.runtime import WorkerNode
        from repro_torch.core.workloads import REGISTRY
        counters = self.counters()
        for mod in counters.values():
            mod.launches = 0
        outs = {}
        t0 = time.perf_counter()
        for system in SYSTEMS:
            node = WorkerNode(system)
            try:
                for name in REGISTRY:
                    node.deploy(name)
                    node.seed_input(name)
                futs = {name: node.invoke(name, inv_id=name)
                        for name in REGISTRY}
                res = {name: f.result(timeout=NODE_TIMEOUT_S)
                       for name, f in futs.items()}
                outs[system] = {
                    name: [node.store.get("out", f"{name}-out" + (
                        "" if k == 0 else f"-{k}"))
                        for k in range(len(REGISTRY[name].profile.puts))]
                    for name in REGISTRY}
                print(f"  node suite {system}: {len(REGISTRY)} functions, "
                      f"latency {min(r.latency_s for r in res.values()) * 1e3:.1f}"
                      f"-{max(r.latency_s for r in res.values()) * 1e3:.1f} ms")
            finally:
                node.shutdown()
        self.launches["node suite"] = {n: m.launches
                                       for n, m in counters.items()}
        first = outs[next(iter(SYSTEMS))]
        if any(o != first for o in outs.values()):
            raise AssertionError("node suite: outputs differ across variants")
        if any(self.launches["node suite"].values()):
            raise AssertionError("node suite: a kernel ran")
        print(f"  node suite: {len(REGISTRY)} functions x {len(SYSTEMS)} "
              f"variants byte-identical in {time.perf_counter() - t0:.1f}s; "
              f"no kernel launched")

    def node_full(self):
        """llama3-8b LLM-PREFILL at full width, cut to ``NODE_LAYERS`` of
        its 32 layers, under ``nexus`` with the SharedCache on, sized to
        the invocation's real GET and PUT bytes: two invocations of the
        full-scale workload on one node. The first misses, prefetches its
        3.85 GB params GET into the tenant arena and fills the cache (a
        sha256 of the bytes and a copy into the cache's arena); the second
        is served from the cache (the modeled hit sleep, a copy out of the
        cache and one into the tenant arena). Both durable outputs against
        the kernel-path core called directly on the same payload bytes.
        The MLServe cores take the cut config as the role's full scale for
        the run (`cut_bundle`)."""
        with cut_bundle("llm", NODE_LAYERS):
            self.node_full_cut()

    def node_full_cut(self):
        torch = self.torch
        from repro_torch.core import arena, fabric
        from repro_torch.core.cache import CacheSpec, SharedCache
        from repro_torch.core.plan import SYSTEMS
        from repro_torch.core.ratelimit import DEFAULT_MAX_DEBT_S
        from repro_torch.core.runtime import WorkerNode
        from repro_torch.core.storage import ObjectStore
        from repro_torch.core.transport import TRANSPORTS
        from repro_torch.core.workloads import ml_suite
        from repro_torch.models import serving
        name, system = "LLM-PREFILL", "nexus"
        path = f"node full {name} {system} x{NODE_LAYERS}"
        with open("/proc/meminfo") as f:
            mem = {k: v.strip() for k, v in
                   (line.split(":", 1) for line in f)}
        print(f"  {path}: before the phase MemTotal {mem['MemTotal']}, "
              f"MemAvailable {mem['MemAvailable']}, this process "
              f"{RssSampler.now() / 2**30:.2f} GiB")
        w = ml_suite("full")[name]
        cfg = serving._bundle("llm", "full")["cfg"]
        sizes = serving.role_sizes(cfg)
        t0 = time.perf_counter()
        payloads = serving.seed_role("llm", [name], scale="full")[name]
        print(f"  {path}: payloads built in {time.perf_counter() - t0:.1f}s")
        real_in = [len(p) for p in payloads]
        real_out = sizes["kv_prefill_bytes"]
        print(f"  {path}: the profile declares GETs of "
              f"{[g.size_bytes for g in w.profile.gets]} B and a PUT of "
              f"{[p.size_bytes for p in w.profile.puts]} B (per device of "
              f"the reference's 8-device slice); the real payloads are "
              f"{real_in} B in and {real_out} B out, and the node's fetch "
              f"and write costs follow the real bytes")

        # the modeled sleeps of the GET and the PUT, from the port's own
        # cost model, which size the node's deadlines (twice each)
        tr = TRANSPORTS[SYSTEMS[system].transport]

        def modeled(n):
            return {"transfer": tr.transfer_latency(n),
                    "sdk": fabric.fabric_op_mcycles("aws", "go", n)
                    / fabric.GHZ_MCYC_PER_S,
                    "token bucket at most": DEFAULT_MAX_DEBT_S}

        get_s, put_s = modeled(real_in[0]), modeled(real_out)
        for what, m in (("params GET", get_s), ("KV PUT", put_s)):
            print(f"  {path}: modeled {what} sleeps "
                  + ", ".join(f"{k} {v:.2f} s" for k, v in m.items()))
        for other in ("baseline", "wasm"):
            spec = SYSTEMS[other]
            cost = (fabric.in_guest_op_cost if spec.virtualized
                    else fabric.in_process_op_cost)(spec.sdk, spec.guest_lang,
                                                    real_in[0])
            print(f"  {path}: under {other} (not run) the params "
                  f"GET would sleep {cost.total() / fabric.GHZ_MCYC_PER_S:.2f}"
                  f" s of modeled in-guest fabric, plus a "
                  f"{TRANSPORTS[spec.transport].transfer_latency(real_in[0]):.2f}"
                  f" s transfer")
        arena_mb = (sum(real_in) + real_out) / 2**20 + 1.0
        spec = CacheSpec(capacity_mb=arena_mb)
        print(f"  {path}: cache {spec}; a hit on the params GET sleeps "
              f"{spec.hit_duration_s(real_in[0]):.3f} s (modeled)")
        node = WorkerNode(
            system, store=ObjectStore(), byte_scale=1.0, arena_mb=arena_mb,
            cache=spec, connect_timeout_s=2 * sum(get_s.values()),
            writeback_ack_timeout_s=2 * sum(put_s.values()),
            plan_stall_timeout_s=2 * (sum(get_s.values())
                                      + sum(put_s.values())) + 300.0)
        # host work on the cache's path, timed: the fill's hash and copy
        # into the cache's arena, the hit's copy out of it, and every
        # copy of 1 GiB or more into an arena slot. PERF.md's fill/hit
        # split rests on private boundaries of the copied `core/cache.py`
        # (`SharedCache._ck` hashes, `SharedCache._park` copies in,
        # `SharedCache.get` copies out) and on `arena.Slot.write`: a
        # re-copy of `cache.py` that moves that work must update these
        # spies, or the split silently times something else.
        host = []

        def timed(what, fn):
            def call(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    host.append((what, time.perf_counter() - t))
            return call

        spies = {(SharedCache, "_ck"): "fill sha256",
                 (SharedCache, "_park"): "fill park (the cache arena's "
                                         "allocation on first use, the copy)",
                 (SharedCache, "get"): "hit copy out of the cache arena"}
        originals = {k: getattr(*k) for k in spies}
        slot_write = arena.Slot.write

        def write(slot, data, at=0):
            if len(data) < 2**30:
                return slot_write(slot, data, at)
            return timed(f"copy into the {slot.arena.tenant} arena",
                         slot_write)(slot, data, at)

        timings, orig = {}, serving.llm_prefill
        runs, rss = [], RssSampler()
        try:
            for (cls, attr), what in spies.items():
                setattr(cls, attr, timed(what, originals[cls, attr]))
            arena.Slot.write = write
            node.deploy(w)
            node.seed_input(name, payloads=payloads)
            bucket = node.backend.limiter.bucket("s3")
            waits, throttle = [], bucket.throttle

            def spy(nbytes, sleep=time.sleep):
                waits.append((nbytes, throttle(nbytes, sleep)))
                return waits[-1][1]

            bucket.throttle = spy
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with rss:
                for i in (1, 2):
                    host.clear()
                    waits.clear()
                    timings.clear()
                    serving.llm_prefill = (lambda *a, **k:
                                           orig(*a, timings=timings, **k))
                    res, out = self.node_invoke(node, name,
                                                f"{path} invocation {i}")
                    runs.append({"res": res, "out": out,
                                 "host": list(host), "waits": list(waits),
                                 "timings": dict(timings),
                                 "hits": node.backend.stats["cache_hits"],
                                 "cache": node.cache_stats()})
                    serving.llm_prefill = orig
            peak = torch.cuda.max_memory_allocated()
            stats = dict(node.backend.stats)
        finally:
            serving.llm_prefill = orig
            for (cls, attr) in spies:
                setattr(cls, attr, originals[cls, attr])
            arena.Slot.write = slot_write
            node.shutdown()
        del node
        gc.collect()
        want = every_kernel({FLASH["name"]: cfg.num_layers})
        direct = serving.llm_prefill(*payloads)
        for i, run in enumerate(runs, 1):
            res = run["res"]
            label = f"{path} invocation {i}"
            groups = ", ".join(f"{g} {t:.3f}" for g, t in res.breakdown.items())
            print(f"  {label}: latency {res.latency_s:.3f} s, cold {res.cold};"
                  f" groups (s) {groups}")
            print(f"  {label}: token-bucket waits (bytes, s) {run['waits']}; "
                  f"host work on the cache's path (s) "
                  f"{[(what, round(t, 3)) for what, t in run['host'] if t >= 1e-3]};"
                  f" handler measured decode "
                  f"{run['timings']['decode'] * 1e3:.1f} ms, forward "
                  f"{run['timings']['forward'] * 1e3:.1f} ms, encode "
                  f"{run['timings']['encode'] * 1e3:.1f} ms beside compute[0] "
                  f"{res.breakdown['compute[0]'] * 1e3:.1f} ms")
            print(f"  {label}: backend cache hits so far {run['hits']}; cache "
                  f"{run['cache']}; launches {self.launches[label]}")
            print(f"  {label}: durable output {len(run['out'])} B "
                  f"{'==' if run['out'] == direct else '!='} the kernel-path "
                  f"core's on the same payload bytes")
            if self.launches[label] != want:
                raise AssertionError(f"{label}: launches "
                                     f"{self.launches[label]} != {want}")
            if run["out"] != direct or len(run["out"]) != real_out:
                raise AssertionError(f"{label}: the durable output is not the "
                                     f"core's")
        print(f"  {path}: fetch[0] of the miss "
              f"{runs[0]['res'].breakdown['fetch[0]']:.3f} s, of the hit "
              f"{runs[1]['res'].breakdown['fetch[0]']:.3f} s; latency "
              f"{runs[0]['res'].latency_s:.3f} -> "
              f"{runs[1]['res'].latency_s:.3f} s")
        print(f"  {path}: peak device {peak / 2**30:.2f} GiB; host RSS "
              f"{rss.start / 2**30:.2f} GiB at the first invocation's start "
              f"(the payloads, the store and the tenant arena), peak "
              f"{rss.peak / 2**30:.2f} GiB during the two; backend {stats}")
        if not runs[0]["res"].cold or runs[1]["res"].cold:
            raise AssertionError(f"{path}: not a cold then a warm invocation")
        if runs[0]["hits"] != 0 or runs[1]["hits"] < 1:
            raise AssertionError(f"{path}: the second invocation's params GET "
                                 f"did not hit the cache")
        if runs[1]["cache"]["hits"] < 1 or stats["prefetches"] != 2:
            raise AssertionError(f"{path}: cache {runs[1]['cache']}, "
                                 f"prefetches {stats['prefetches']}")
        self.node_full_runs = [run["res"] for run in runs]

    def phase_density(self):
        """The density simulator (`repro_torch.core.des`) on this
        machine's host: the four engines on one run each of the paper
        suite and the full-scale MLServe suite, one latency digest each;
        `find_density` for the five systems of Fig 6; then the DES's
        zero-contention LLM-PREFILL under ``nexus`` per breakdown group
        beside the full-width node run of the worker-node phase. Every
        number is modeled virtual time (the reference's cost model on
        4 nodes x 28 cores x 128 GB) or this host's wall time; nothing
        here runs on the card, and no kernel launches."""
        counters = self.counters()
        for mod in counters.values():
            mod.launches = 0
        self.density_engines()
        self.density_search()
        self.density_against_card()
        self.launches["density"] = {n: m.launches
                                    for n, m in counters.items()}
        if any(self.launches["density"].values()):
            raise AssertionError("density: a kernel ran")

    def density_engines(self):
        """Each run under all four engines, which must give one digest."""
        from repro_torch.core.des import ENGINES, DensitySimulator
        from repro_torch.core.workloads import ml_suite
        runs = {
            "baseline n 160 (paper suite, 20 s)": lambda engine:
                DensitySimulator("baseline", 160, seed=1, duration_s=20.0,
                                 warmup_s=5.0, engine=engine),
            "nexus n 20 (ml_suite full, 15 s)": lambda engine:
                DensitySimulator("nexus", 20, seed=1, duration_s=15.0,
                                 warmup_s=3.0, mean_rate=0.25,
                                 suite=ml_suite("full"), engine=engine),
        }
        for label, build in runs.items():
            digests = {}
            for engine in ENGINES:
                t0 = time.perf_counter()
                sim = build(engine)
                res = sim.run()
                digests[engine] = latency_digest(res, sim)
                print(f"  density engines {label} {engine:8s}: sha256 "
                      f"{digests[engine]} completed {res.completed} "
                      f"cold_starts {res.cold_starts} (modeled); host wall "
                      f"{time.perf_counter() - t0:.2f} s")
            if len(set(digests.values())) != 1:
                raise AssertionError(f"density engines {label}: the engines' "
                                     f"digests differ: {digests}")

    def density_search(self):
        """`find_density(system, seed=1, fast=True)` at its defaults for
        the five systems of Fig 6, one process per system; each density
        must be a passing probe below every failing one."""
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        t0 = time.perf_counter()
        with ProcessPoolExecutor(
                max_workers=len(DENSITY_SYSTEMS),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            found = dict(zip(DENSITY_SYSTEMS,
                             pool.map(density_search, DENSITY_SYSTEMS)))
        base = found["baseline"][0]
        print(f"  density search: modeled virtual-time densities from the "
              f"reference's cost model (4 nodes x 28 cores x 128 GB, SLO p99 "
              f"< 5x unloaded), seed 1, fast=True; host wall seconds of "
              f"this machine, {len(DENSITY_SYSTEMS)} searches in parallel "
              f"processes, {time.perf_counter() - t0:.1f} s in all; not a "
              f"measurement of the card")
        for system, (best, probes, wall) in found.items():
            print(f"  density {system:20s}: {best} functions, "
                  f"{len(probes)} probes {[n for n, _ in probes]}, gain over "
                  f"baseline {best / base - 1:+.1%}, host wall {wall:.1f} s")
            fails = [n for n, ok in probes if not ok]
            if (best <= 0 or (best, True) not in probes
                    or any(n <= best for n in fails)):
                raise AssertionError(f"density {system}: {best} is not a "
                                     f"passing probe below every failing "
                                     f"one: {probes}")

    def density_against_card(self):
        """The DES's zero-contention LLM-PREFILL under ``nexus`` (the
        settings of the reference's `TestDESParity`), cold and warm,
        per breakdown group, beside the full-width node run of the
        worker-node phase (``NODE_LAYERS`` layers; the miss is cold, the
        hit warm)."""
        from repro_torch.core.calibrate import load_calibration
        from repro_torch.core.des import DensitySimulator
        from repro_torch.core.plan import (SYSTEMS, compile_plan,
                                           phase_durations, phase_group)
        from repro_torch.core.workloads import ml_suite
        if self.node_full_runs is None:
            raise AssertionError("density against card: the worker-node "
                                 "phase left no full-width run")
        name, system = "LLM-PREFILL", "nexus"
        spec, w = SYSTEMS[system], ml_suite("full")[name]
        machine = load_calibration()["machines"]["full"]
        print(f"  density against card: the DES prices {name}'s compute "
              f"from calibration.json's {machine['name']!r} profile "
              f"({machine}, an 8-device A100/TPUv4-class slice) and its "
              f"I/O from the per-device bytes it declares "
              f"({[g.size_bytes for g in w.profile.gets]} B in, "
              f"{[p.size_bytes for p in w.profile.puts]} B out); the card "
              f"prices nothing: the node run moved the real bytes of the "
              f"full width cut to {NODE_LAYERS} of 32 layers, and served "
              f"its second params GET from the "
              f"SharedCache, which the DES run here leaves off. The gap is "
              f"a finding, not a check")
        for cold, res in zip((True, False), self.node_full_runs):
            sim = DensitySimulator(system, 1, seed=0, duration_s=5.0,
                                   warmup_s=0.0, cores=4096,
                                   backend_workers=4096, nodes=1,
                                   mem_gb=4096.0, suite={name: w})
            fn = sim.functions[0]
            inst = sim._spawn(fn)
            inst.state = "busy"
            sim._execute(inst, 0.0, cold=cold)
            sim.loop.run(3600.0)
            (lat,) = sim.latencies[fn]
            plan = compile_plan(spec, w.profile, cold=cold)
            durs = phase_durations(spec, w, cold=cold)
            if abs(lat - plan.critical_path(durs)) > 1e-9 * lat:
                raise AssertionError(f"density against card: DES latency "
                                     f"{lat} is not the critical path")
            groups = {}
            for phase in plan.phase_names:
                g = phase_group(phase)
                groups[g] = groups.get(g, 0.0) + durs.get(phase, 0.0)
            run = ("cold, beside the node's miss" if cold
                   else "warm, beside the node's cache hit")
            print(f"  density against card {name} {system} {run}: DES "
                  f"latency {lat:.4f} s (modeled), node {res.latency_s:.4f} s "
                  f"(card run, cold {res.cold})")
            for g in ("fetch[0]", "compute[0]", "write[0]"):
                print(f"    {g:11s} DES {groups[g]:10.4f} s   node "
                      f"{res.breakdown[g]:10.4f} s")

    def phase_fleet(self):
        """The fleet model (`repro_torch.core.cluster`) and PlanCheck's
        matrix (`repro_torch.core.analysis`) on this machine's host: the
        headline fleet of `benchmarks/cluster.py` under its five dispatch
        policies, one process each, at least 3 of them with distinct
        (goodput, p99) as the bench requires; then `run_matrix()`, which
        must be clean, and every seeded corruption of `mutate`, which
        `verify_program` must catch with its own code. Every latency is
        modeled virtual time; nothing here runs on the card, and no
        kernel launches."""
        counters = self.counters()
        for mod in counters.values():
            mod.launches = 0
        self.fleet_policies()
        self.plancheck()
        self.launches["fleet and plancheck"] = {n: m.launches
                                                for n, m in counters.items()}
        if any(self.launches["fleet and plancheck"].values()):
            raise AssertionError("fleet and plancheck: a kernel ran")

    def phase_dryrun(self):
        """The dry run (`repro_torch.launch.dryrun`) of every runnable cell
        on both production meshes,
        on this machine's host, no kernel launching: per cell the
        per-device argument and output bytes against the card's memory,
        the analytic and the counted FLOPs per device; the largest
        argument bytes per shape; then `calibrate.main(["--check"])`,
        which must find the committed calibration regenerated exactly."""
        import io
        torch = self.torch
        from repro_torch.core import calibrate
        from repro_torch.launch import dryrun
        counters = self.counters()
        for mod in counters.values():
            mod.launches = 0
        total = torch.cuda.get_device_properties(0).total_memory
        cells = dryrun.cells_to_run()
        largest = {}
        t0 = time.monotonic()
        for arch, shape, multi in cells:
            t = time.monotonic()
            rec = dryrun.run_cell(arch, shape, multi)
            arg, out = rec["memory"]["argument_B"], rec["memory"]["output_B"]
            print(f"  dry run {arch} {shape} {rec['mesh']}: argument_B {arg} "
                  f"({arg / total:.4f} of the card), output_B {out} "
                  f"({out / total:.4f}); FLOPs per device "
                  f"{rec['model_flops_per_device']:.4e} model, "
                  f"{rec['flops_per_device']:.4e} counted ({rec['flops_by']})"
                  f"; {time.monotonic() - t:.2f}s")
            if arg > largest.get(shape, (0,))[0]:
                largest[shape] = (arg, arch, rec["mesh"])
        passes = time.monotonic() - t0
        for shape, (arg, arch, mesh) in largest.items():
            print(f"  dry run {shape}: the largest argument_B {arg} B "
                  f"({arch}, {mesh}), {arg / total:.4f} of the card's "
                  f"{total} B ({torch.cuda.get_device_name(0)})")
        archs = sorted({a for a, _, _ in cells})
        print(f"  dry run: {len(cells)} cells of {len(archs)} archs "
              f"({', '.join(archs)}) on both meshes in {passes:.1f}s")
        buf = io.StringIO()
        t = time.monotonic()
        try:
            with contextlib.redirect_stdout(buf):
                same = calibrate.main(["--check"])
        except SystemExit:
            same = False
        print(f"  calibrate --check: {buf.getvalue().splitlines()[-1]} "
              f"({time.monotonic() - t:.1f}s)")
        self.launches["dry run"] = {n: m.launches
                                    for n, m in counters.items()}
        if not same:
            raise AssertionError("the calibration does not regenerate")
        if any(self.launches["dry run"].values()):
            raise AssertionError("dry run: a kernel ran")

    def fleet_policies(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        t0 = time.perf_counter()
        with ProcessPoolExecutor(
                max_workers=len(FLEET_POLICIES),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            cells = dict(zip(FLEET_POLICIES,
                             pool.map(fleet_run, FLEET_POLICIES)))
        members = cells[FLEET_POLICIES[0]][0]["members"]
        print(f"  fleet n {FLEET_N} {members}, {10 * FLEET_N} functions, azure "
              f"arrivals, seed 5, 30 s after 6 s warmup: modeled virtual-time "
              f"latencies from the reference's cost model; host wall seconds "
              f"of this machine, {len(FLEET_POLICIES)} runs in parallel "
              f"processes, {time.perf_counter() - t0:.1f} s in all; not a "
              f"measurement of the card")
        for policy, (m, wall) in cells.items():
            print(f"  fleet {policy:12s}: offered {m['offered']} completed "
                  f"{m['completed']} goodput {m['goodput']} p50 "
                  f"{m['p50_s'] * 1e3:.3f} ms p99 {m['p99_s'] * 1e3:.3f} ms "
                  f"shed {m['shed']} mean utilisation {m['util_mean']:.4f} "
                  f"(modeled); host wall {wall:.1f} s")
            if not m["conserved"] or m["completed"] <= 0:
                raise AssertionError(f"fleet {policy}: arrivals not conserved "
                                     f"or nothing completed: {m}")
        outcomes = {(m["goodput"], m["p99_s"]) for m, _ in cells.values()}
        print(f"  fleet: {len(outcomes)} distinct (goodput, p99) outcomes of "
              f"{len(FLEET_POLICIES)} policies (the bench asks for 3)")
        if len(outcomes) < 3:
            raise AssertionError("fleet: the dispatch policies are "
                                 "indistinguishable")

    def plancheck(self):
        from repro_torch.core.analysis import run_matrix, verify_program
        from repro_torch.core.analysis import mutate
        from repro_torch.core.analysis.diag import PlanCheckError
        from repro_torch.core.plan import (SYSTEMS, compile_program,
                                           duration_vector)
        from repro_torch.core.transport import TRANSPORTS
        from repro_torch.core.workloads import REGISTRY
        t0 = time.perf_counter()
        report = run_matrix()
        print(f"  plancheck: {report.handlers_checked} handlers, "
              f"{report.cells_verified} plan/program cells, "
              f"{len(report.warnings)} warnings, {len(report.failures)} "
              f"failures; host wall {time.perf_counter() - t0:.1f} s")
        if not report.ok or report.warnings:
            raise AssertionError(f"plancheck: the matrix is not clean: "
                                 f"{report.failures + report.warnings}")
        # the mutation matrix of tests/test_plancheck.py
        cells = [("nexus", "PIPE", True), ("nexus", "PIPE", False),
                 ("nexus", "SG", True), ("nexus", "FAN", True),
                 ("nexus-tcp", "PIPE", True), ("nexus-async", "PIPE", True),
                 ("baseline", "PIPE", True), ("baseline", "AES", False)]
        caught = {}
        for c in mutate.CORRUPTIONS:
            for system, wname, cold in cells:
                spec, w = SYSTEMS[system], REGISTRY[wname]
                prog = compile_program(
                    spec, w.profile, cold,
                    kernel_bypass=TRANSPORTS[spec.transport].kernel_bypass)
                try:
                    bad, durs = mutate.corrupt(
                        prog, duration_vector(spec, w, cold), c.name, seed=7)
                except mutate.Ineligible:
                    continue
                try:
                    verify_program(bad, durations=durs)
                except PlanCheckError as e:
                    if e.code != c.code:
                        raise AssertionError(
                            f"plancheck: {c.name} on {system}/{wname} raised "
                            f"{e.code}, not {c.code}") from e
                else:
                    raise AssertionError(f"plancheck: {c.name} on "
                                         f"{system}/{wname} passed")
                caught[c.name] = caught.get(c.name, 0) + 1
        missed = [c.name for c in mutate.CORRUPTIONS if c.name not in caught]
        print(f"  plancheck mutations: {len(caught)} of "
              f"{len(mutate.CORRUPTIONS)} corruptions each caught with its "
              f"own code on {sum(caught.values())} eligible cells")
        if missed:
            raise AssertionError(f"plancheck: no eligible cell for {missed}")

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
                *llama, 0, "granite-8b MLServe EMB", B=32, S=512),
            # head_dim 16 (the moe role's tiny heads) at the serve shape
            "hd 16 H=4 K=2": self.time_flash(4, 2, 16, 0, "hd 16, the moe "
                                             "smoke heads"),
            "yi-34b": self.time_flash(56, 8, 128, 0, "yi-34b"),
            "qwen2-72b": self.time_flash(64, 8, 128, 0, "qwen2-72b"),
            "mixtral-8x22b S=8192": self.time_flash(
                48, 8, 128, 4096, "mixtral-8x22b", S=8192),
            "internvl2-2b": self.time_flash(16, 8, 128, 0, "internvl2-2b"),
            # a rank's local heads of llama3-8b's training on the mesh
            "llama3-8b mesh rank H16/K4 (model 2) B=2 S=4096":
                self.time_flash(16, 4, 128, 0, "llama3-8b mesh rank, model "
                                "2", B=TRAIN_BATCH, S=TRAIN_SEQ),
            "llama3-8b mesh rank H8/K2 (model 4) B=2 S=4096":
                self.time_flash(8, 2, 128, 0, "llama3-8b mesh rank, model 4",
                                B=TRAIN_BATCH, S=TRAIN_SEQ),
            **{f"hymba-1.5b mesh rank H{H}/K{H} G1 (model 4) B=2 S=4096 "
               f"window=2048": self.time_flash(
                   H, H, 64, 2048, "hymba-1.5b mesh rank, model 4",
                   B=TRAIN_BATCH, S=TRAIN_SEQ) for H in (6, 7)},
            "qwen3-moe-30b-a3b mesh rank H16/K2 G8 (model 2) B=2 S=4096":
                self.time_flash(16, 2, 128, 0, "qwen3-moe-30b-a3b mesh rank, "
                                "model 2", B=TRAIN_BATCH, S=TRAIN_SEQ),
            # a (2, 2) rank's heads: one row of the batch a data rank
            "llama3-8b mesh rank H16/K4 (2, 2) B=1 S=4096":
                self.time_flash(16, 4, 128, 0, "llama3-8b mesh rank, (2, 2)",
                                B=1, S=TRAIN_SEQ),
            "qwen3-moe-30b-a3b mesh rank H16/K2 G8 (2, 2) B=1 S=4096":
                self.time_flash(16, 2, 128, 0, "qwen3-moe-30b-a3b mesh rank, "
                                "(2, 2)", B=1, S=TRAIN_SEQ),
            "seamless-m4t-large-v2 encoder": self.time_flash(
                16, 16, 64, 0, "seamless-m4t-large-v2 encoder",
                causal=False),
            "seamless-m4t-large-v2 decoder": self.time_flash(
                16, 16, 64, 0, "seamless-m4t-large-v2 decoder"),
            "seamless-m4t-large-v2 cross Sk=1500": self.time_flash(
                16, 16, 64, 0, "seamless-m4t-large-v2 cross, ragged source",
                causal=False, Sk=1500)}
        self.timing[DECODE["name"]] = self.time_decode(1, *llama, 0,
                                                       "llama3-8b")
        self.also[DECODE["name"]] = {
            "llama3-8b B=8": self.time_decode(8, *llama, 0, "llama3-8b"),
            "hymba-1.5b": self.time_decode(1, *hymba, 2048, "hymba-1.5b"),
            "qwen3-moe-30b-a3b": self.time_decode(1, *qwen3, 0,
                                                  "qwen3-moe-30b-a3b"),
            "qwen3-moe-30b-a3b B=8": self.time_decode(8, *qwen3, 0,
                                                      "qwen3-moe-30b-a3b"),
            "hd 16 H=4 K=2": self.time_decode(1, 4, 2, 16, 0, "hd 16, the moe "
                                              "smoke heads"),
            "yi-34b": self.time_decode(1, 56, 8, 128, 0, "yi-34b"),
            "yi-34b B=8": self.time_decode(8, 56, 8, 128, 0, "yi-34b"),
            "qwen2-72b": self.time_decode(1, 64, 8, 128, 0, "qwen2-72b"),
            "qwen2-72b B=8": self.time_decode(8, 64, 8, 128, 0, "qwen2-72b"),
            "mixtral-8x22b W=4096": self.time_decode(
                1, 48, 8, 128, 4096, "mixtral-8x22b, the served ring",
                W=4096),
            "mixtral-8x22b W=8192": self.time_decode(
                1, 48, 8, 128, 4096, "mixtral-8x22b", W=8192),
            "internvl2-2b": self.time_decode(1, 16, 8, 128, 0,
                                             "internvl2-2b"),
            "internvl2-2b B=8": self.time_decode(8, 16, 8, 128, 0,
                                                 "internvl2-2b"),
            # every slot valid: the self ring after its first wrap, and
            # the cross cache at W 2048 alike
            "seamless-m4t-large-v2": self.time_decode(
                1, 16, 16, 64, 0, "seamless-m4t-large-v2, self and cross"),
            "seamless-m4t-large-v2 B=8": self.time_decode(
                8, 16, 16, 64, 0, "seamless-m4t-large-v2, self and cross"),
            "seamless-m4t-large-v2 cross W=1500": self.time_decode(
                1, 16, 16, 64, 0, "seamless-m4t-large-v2 cross, ragged "
                "source", W=1500)}
        # the serving ranks' heads (the "train (mesh)" phase's serving
        # runs): llama3-8b at model 2, qwen2-72b at model 4 (G 8; the
        # heads of qwen3-moe-30b-a3b's at model 2), mixtral-8x22b at model
        # 2 (G 6, its window, prompt 8192)
        self.also[FLASH["name"]].update({
            "llama3-8b serving rank H16/K4 (model 2) B=2 S=2048":
                self.time_flash(16, 4, 128, 0, "llama3-8b serving rank, "
                                "model 2", B=MESH_SERVE_BATCH),
            "qwen2-72b serving rank H16/K2 G8 (model 4) B=2 S=2048":
                self.time_flash(16, 2, 128, 0, "qwen2-72b serving rank, "
                                "model 4", B=MESH_SERVE_BATCH),
            "mixtral-8x22b serving rank H24/K4 G6 (model 2) B=2 S=8192 "
            "window=4096": self.time_flash(
                24, 4, 128, 4096, "mixtral-8x22b serving rank, model 2",
                B=MESH_SERVE_BATCH, S=serve_len("mixtral-8x22b")),
            # internvl2-2b at model 2 (G 2) and seamless-m4t-large-v2 at
            # model 4 (G 1): its encoder and cross-attention (Sq = Sk =
            # 2048, bidirectional) and its decoder
            "internvl2-2b serving rank H8/K4 G2 (model 2) B=2 S=2048":
                self.time_flash(8, 4, 128, 0, "internvl2-2b serving rank, "
                                "model 2", B=MESH_SERVE_BATCH),
            "seamless-m4t-large-v2 serving rank H4/K4 (model 4) B=2 S=2048 "
            "encoder and cross": self.time_flash(
                4, 4, 64, 0, "seamless-m4t-large-v2 serving rank, model 4, "
                "encoder and cross", B=MESH_SERVE_BATCH, causal=False),
            "seamless-m4t-large-v2 serving rank H4/K4 (model 4) B=2 S=2048 "
            "decoder": self.time_flash(
                4, 4, 64, 0, "seamless-m4t-large-v2 serving rank, model 4, "
                "decoder", B=MESH_SERVE_BATCH)})
        # the head_dim-slice pair at a decode_32k rank's shape on the 16x16
        # mesh (B 128 over data 16, hd 128 over model 16), and at the
        # serving runs' ranks
        rows = self.time_decode_hd(8, 32, 8, 8, 32768, "llama3-8b "
                                   "decode_32k rank, 16x16 mesh")
        self.timing[SCORES_HD["name"]], self.timing[VALUES_HD["name"]] = rows
        also = {}
        for label, shape in (
                ("llama3-8b (1, 2) rank B=2 hs=64", (2, 32, 8, 64)),
                ("llama3-8b (1, 4) rank B=2 hs=32", (2, 32, 8, 32)),
                ("llama3-8b (2, 2) rank B=1 hs=64", (1, 32, 8, 64)),
                ("qwen2-72b (1, 4) rank B=2 H=64 K=8 hs=32", (2, 64, 8, 32))):
            also[label] = self.time_decode_hd(*shape, PROMPT,
                                              f"{label}, serving run")
        # hymba-1.5b (H 25 over K 5, hd 64, its window of 2048 bounds the
        # ring): the decode_32k rank on 16x16 (B 128 over data 16, hd 64
        # over model 16: a slice of 4), the long_500k rank (B 1
        # replicated), the serving run's (1, 4) rank (a slice of 16)
        for label, shape in (
                ("hymba-1.5b decode_32k rank B=8 hs=4", (8, 25, 5, 4)),
                ("hymba-1.5b long_500k rank B=1 hs=4", (1, 25, 5, 4)),
                ("hymba-1.5b (1, 4) rank B=2 hs=16", (2, 25, 5, 16))):
            also[label] = self.time_decode_hd(*shape, PROMPT, label,
                                              head_dim=64, window=PROMPT)
        # the moe family: qwen3-moe-30b-a3b's decode_32k rank on 16x16 (B
        # 128 over data 16, H 32 over K 4, hd 128 over model 16) and its
        # serving runs' ranks (hd over model 2); mixtral-8x22b's, its ring
        # the 4096 window: decode_32k on 16x16, long_500k (B 1
        # replicated) and the serving run's (1, 2) rank
        for label, shape, W, window in (
                ("qwen3-moe-30b-a3b decode_32k rank B=8 K=4 hs=8",
                 (8, 32, 4, 8), 32768, 0),
                ("qwen3-moe-30b-a3b (1, 2) rank B=2 hs=64", (2, 32, 4, 64),
                 PROMPT, 0),
                ("qwen3-moe-30b-a3b (2, 2) rank B=1 hs=64", (1, 32, 4, 64),
                 PROMPT, 0),
                ("mixtral-8x22b decode_32k rank B=8 H=48 K=8 hs=8",
                 (8, 48, 8, 8), 4096, 4096),
                ("mixtral-8x22b long_500k rank B=1 hs=8", (1, 48, 8, 8),
                 4096, 4096),
                ("mixtral-8x22b (1, 2) rank B=2 hs=64", (2, 48, 8, 64), 4096,
                 4096)):
            also[label] = self.time_decode_hd(*shape, W, label,
                                              window=window)
        # internvl2-2b (H 16 over K 8, hd 128: G 2) and
        # seamless-m4t-large-v2 (H 16 over K 16, hd 64: G 1; its self and
        # cross caches alike, every slot valid): the decode_32k ranks on
        # 16x16 (B 128 over data 16, hd over model 16) and the serving
        # runs' ranks (internvl2's hd over model 2, seamless's over 4)
        for label, shape, W, hd in (
                ("internvl2-2b decode_32k rank B=8 H=16 K=8 hs=8",
                 (8, 16, 8, 8), 32768, 128),
                ("seamless-m4t-large-v2 decode_32k rank B=8 H=16 K=16 hs=4, "
                 "self and cross", (8, 16, 16, 4), 32768, 64),
                ("internvl2-2b (1, 2) rank B=2 hs=64", (2, 16, 8, 64), PROMPT,
                 128),
                ("seamless-m4t-large-v2 (1, 4) rank B=2 hs=16, self and "
                 "cross", (2, 16, 16, 16), PROMPT, 64)):
            also[label] = self.time_decode_hd(*shape, W, label, head_dim=hd)
        for i, meta in enumerate((SCORES_HD, VALUES_HD)):
            self.also[meta["name"]] = {k: v[i] for k, v in also.items()}
        self.timing[FLASH_BWD["name"]] = self.time_flash_bwd(
            TRAIN_BATCH, TRAIN_SEQ, *llama, "llama3-8b training shape")
        self.also[FLASH_BWD["name"]] = {
            "llama3-8b B=1 S=2048": self.time_flash_bwd(
                1, 2048, *llama, "llama3-8b"),
            "hymba-1.5b S=4096 window=2048": self.time_flash_bwd(
                1, TRAIN_SEQ, *hymba, "hymba-1.5b", window=2048),
            "llama3-8b mesh rank H16/K4 (model 2) B=2 S=4096":
                self.time_flash_bwd(TRAIN_BATCH, TRAIN_SEQ, 16, 4, 128,
                                    "llama3-8b mesh rank, model 2"),
            "llama3-8b mesh rank H8/K2 (model 4) B=2 S=4096":
                self.time_flash_bwd(TRAIN_BATCH, TRAIN_SEQ, 8, 2, 128,
                                    "llama3-8b mesh rank, model 4"),
            **{f"hymba-1.5b mesh rank H{H}/K{H} G1 (model 4) B=2 S=4096 "
               f"window=2048": self.time_flash_bwd(
                   TRAIN_BATCH, TRAIN_SEQ, H, H, 64, "hymba-1.5b mesh rank, "
                   "model 4", window=2048) for H in (6, 7)},
            "qwen3-moe-30b-a3b mesh rank H16/K2 G8 (model 2) B=2 S=4096":
                self.time_flash_bwd(TRAIN_BATCH, TRAIN_SEQ, 16, 2, 128,
                                    "qwen3-moe-30b-a3b mesh rank, model 2"),
            "llama3-8b mesh rank H16/K4 (2, 2) B=1 S=4096":
                self.time_flash_bwd(1, TRAIN_SEQ, 16, 4, 128,
                                    "llama3-8b mesh rank, (2, 2)"),
            "qwen3-moe-30b-a3b mesh rank H16/K2 G8 (2, 2) B=1 S=4096":
                self.time_flash_bwd(1, TRAIN_SEQ, 16, 2, 128,
                                    "qwen3-moe-30b-a3b mesh rank, (2, 2)")}
        self.timing[SCAN["name"]] = self.time_scan(8192, 256, "falcon-mamba-7b")
        self.also[SCAN["name"]] = {
            "hymba-1.5b": self.time_scan(3200, 100, "hymba-1.5b"),
            "falcon-mamba-7b B=2 S=4096, with and without states":
                self.time_scan_states(8192, 256, "falcon-mamba-7b"),
            "hymba-1.5b B=2 S=4096, with and without states":
                self.time_scan_states(3200, 100, "hymba-1.5b"),
            # the plain scans (~1-3 s a call) are timed at the training
            # shapes only: the cut that pays for the mesh phase's moe run
            "falcon-mamba-7b mesh rank di=4096 (model 2) B=2 S=4096, with "
            "and without states": self.time_scan_states(
                4096, 256, "falcon-mamba-7b mesh rank, model 2",
                plain=False),
            "hymba-1.5b mesh rank di=800 (model 4) B=2 S=4096, with and "
            "without states": self.time_scan_states(
                800, 100, "hymba-1.5b mesh rank, model 4", plain=False)}
        self.timing[SCAN_BWD["name"]] = self.time_scan_bwd(
            TRAIN_BATCH, TRAIN_SEQ, 8192, 256, "falcon-mamba-7b training "
            "shape")
        self.also[SCAN_BWD["name"]] = {
            "hymba-1.5b B=2 S=4096": self.time_scan_bwd(
                TRAIN_BATCH, TRAIN_SEQ, 3200, 100, "hymba-1.5b training "
                "shape", plain=False),
            "falcon-mamba-7b B=1 S=2048": self.time_scan_bwd(
                1, PROMPT, 8192, 256, "falcon-mamba-7b", plain=False),
            "falcon-mamba-7b mesh rank di=4096 (model 2) B=2 S=4096":
                self.time_scan_bwd(TRAIN_BATCH, TRAIN_SEQ, 4096, 256,
                                   "falcon-mamba-7b mesh rank, model 2",
                                   plain=False),
            "hymba-1.5b mesh rank di=800 (model 4) B=2 S=4096":
                self.time_scan_bwd(TRAIN_BATCH, TRAIN_SEQ, 800, 100,
                                   "hymba-1.5b mesh rank, model 4",
                                   plain=False)}

    @staticmethod
    def bound(nbytes, flops, peak=BF16_FLOPS_PER_S):
        """The least time (ms) for the work, and what sets it."""
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / peak
        return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")

    def window_mask(self, S, window):
        """The library call's boolean mask of a causal window shorter than
        S (None where ``is_causal`` says it all)."""
        if not window or window >= S:
            return None
        i = self.torch.arange(S, device=self.dev)
        return (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)

    def time_flash(self, H, K, hd, window, arch, B=1, S=PROMPT, causal=True,
                   Sk=None):
        """Prefill at the serve shape (B=1, S=2048 unless given), causal
        unless asked, keys as many as queries unless ``Sk``, bf16."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.flash_attention import mha, mha_ref
        dt = torch.bfloat16
        g = self.gen(3)
        Sk = Sk or S
        sets = []
        for _ in range(4 if B * S <= PROMPT else 2):
            q = self.randn(g, (B, S, H, hd), dt)
            sets.append((q, *(self.randn(g, (B, Sk, K, hd), dt)
                              for _ in "kv")))
        lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                    for s in sets]
        # visited (query, key) pairs: causal, within the window; or all
        pairs = (sum(min(i + 1, window or S) for i in range(S)) if causal
                 else S * Sk)
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * Sk * K * hd)
        bms, by = self.bound(nbytes, 4 * B * H * hd * pairs)
        lib_mask = self.window_mask(S, window)
        row = self.time_row(
            lambda s: mha(*s, causal=causal, window=window),
            lambda s: mha_ref(*s, causal=causal, window=window),
            lambda s: F.scaled_dot_product_attention(
                *s, attn_mask=lib_mask,
                is_causal=causal and lib_mask is None, enable_gqa=True),
            sets, lib_sets, 20, 5)
        row.update(bound_ms=bms, bound_by=by)
        self.report(f"flash_attention bf16 B={B} S={S}"
                    f"{f' Sk={Sk}' if Sk != S else ''} "
                    f"{'causal' if causal else 'bidirectional'} H={H} K={K} "
                    f"hd={hd} window={window} ({arch})", row)
        return row

    def time_flash_bwd(self, B, S, H, K, hd, arch, window=0):
        """The attention backward at a causal training shape, bf16, on
        the forward's lse: the kernel by graph replay (and eagerly), the
        plain backward (`mha_ref_bwd`) eagerly, and the library's
        backward (autograd of one ``F.scaled_dot_product_attention(...,
        enable_gqa=True)``, causal or with the window's mask, on the same
        inputs in its (B, H, S, hd) layout; it also starts from its
        forward's saved lse; a yardstick the port never calls) eagerly
        between CUDA events. The bound by operations is 2.5x the
        forward's FLOPs over the visible pairs; by bytes, q, k, v, out,
        lse and dout read once and dq, dk, dv written once."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.flash_attention import (mha_bwd,
                                                         mha_ref_bwd,
                                                         mha_with_lse)
        from repro_torch.kernels.flash_attention import ops as flash_ops
        dt = torch.bfloat16
        g = self.gen(12)
        lib_mask = self.window_mask(S, window)
        sets, lib_sets = [], []
        for _ in range(2):
            q = self.randn(g, (B, S, H, hd), dt)
            k, v = (self.randn(g, (B, S, K, hd), dt) for _ in "kv")
            dout = self.randn(g, (B, S, H, hd), dt)
            sets.append((q, k, v, *mha_with_lse(q, k, v, window=window),
                         dout))
            lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            lout = F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=lib_mask, is_causal=lib_mask is None,
                enable_gqa=True)
            lib_sets.append((lq, lk, lv, lout,
                             dout.transpose(1, 2).contiguous()))
        pairs = sum(min(i + 1, window or S) for i in range(S))
        flops = 2.5 * 4 * B * H * hd * pairs
        nbytes = 2 * (4 * B * S * H * hd + 4 * B * S * K * hd) + 4 * B * H * S
        bms, by = self.bound(nbytes, flops)

        def kernel(s):
            return mha_bwd(s[0], s[1], s[2], s[3], s[5], lse=s[4],
                           window=window)

        row = {"ms": self.time_ms(kernel, sets, 5, graph=True),
               "eager_ms": self.time_ms(kernel, sets, 5),
               "plain_ms": self.time_ms(
                   lambda s: mha_ref_bwd(s[0], s[1], s[2], s[3], s[5],
                                         window=window), sets[:1], 2),
               "library_ms": self.time_ms(
                   lambda s: torch.autograd.grad(s[3], s[:3], s[4],
                                                 retain_graph=True),
                   lib_sets, 10)}
        row["library_eager_ms"] = row["library_ms"]
        row.update(bound_ms=bms, bound_by=by, body=flash_ops.bwd_body(dt, hd))
        self.report(f"flash_attention_bwd bf16 B={B} S={S} causal H={H} K={K}"
                    f" hd={hd} window={window} [{row['body']}] ({arch}; "
                    f"{flops / 1e9:.1f} GFLOP, library eager)", row)
        del sets, lib_sets
        return row

    def time_decode(self, B, H, K, hd, window, arch, W=PROMPT):
        """Decode at the serve shape: W=2048 (unless given) after the
        ring's first wrap, bf16. The bound counts the K and V rows of the
        valid slots only (with a window shorter than W, the others are
        not needed), and slot_pos whole."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.decode_attention import (decode_mha,
                                                          decode_mha_ref)
        from repro_torch.kernels.decode_attention import ops as decode_ops
        dt, pos = torch.bfloat16, W
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
        n_valid = int(valid.sum())
        nbytes = 2 * (2 * B * H * hd + 2 * n_valid * K * hd) + 4 * (B * W + B)
        bms, by = self.bound(nbytes, 4 * H * hd * n_valid)
        row = self.time_row(
            lambda s: decode_mha(*s, window=window),
            lambda s: decode_mha_ref(*s, window=window),
            lambda s: F.scaled_dot_product_attention(
                s[0], s[1], s[2], attn_mask=s[3], enable_gqa=True),
            sets, lib_sets, 200, 50)
        row.update(bound_ms=bms, bound_by=by)
        C = decode_ops.cluster_size(W, B, K)
        row.update(cluster=C)
        self.report(f"flash_decode bf16 B={B} W={W} H={H} K={K} hd={hd} "
                    f"window={window} [cluster {C}] ({arch})", row)
        return row

    def time_decode_hd(self, B, H, K, hs, W, arch, head_dim=128, window=0):
        """The head_dim-slice pair at a rank's shape: B x H q heads over K
        kv heads on an hd slice ``hs`` of ``head_dim``, a W-slot ring after
        its first wrap (every slot valid, within a ``window`` of W too),
        bf16, the values kernel on f32 summed scores. Bounds by
        bytes (each input read once, each output written once; f32 FMAs
        at 67 TFLOP/s for the operations). The scores' library call is
        one ``torch.einsum`` on the bf16 tensors; the values have no one
        call, and the nearest expression (``torch.where`` of the mask and
        scale, ``torch.softmax``, ``torch.matmul`` with V) is timed beside
        them (``expression_ms``). Returns (scores row, values row)."""
        torch = self.torch
        from repro_torch.kernels.decode_attention import (
            decode_scores_hd, decode_scores_hd_ref, decode_values_hd,
            decode_values_hd_ref)
        dt, hd, G = torch.bfloat16, head_dim, H // K
        per_set = 2 * 2 * B * W * K * hs + 4 * B * H * W
        n = min(32, max(3, math.ceil(120e6 / per_set)))
        g = self.gen(23)
        sp = self.ring_slot_pos(W, W + 1, B)
        p = torch.full((B,), W, dtype=torch.int32, device=self.dev)
        mask = (sp >= 0) & (sp <= p[:, None])
        sets = []
        for _ in range(n):
            q = self.randn(g, (B, H, hs), dt)
            kc, vc = (self.randn(g, (B, W, K, hs), dt) for _ in "kv")
            sets.append((q, kc, vc, decode_scores_hd_ref(q, kc)))
        shape = f"bf16 B={B} W={W} H={H} K={K} hs={hs} ({arch})"
        sbytes = 2 * B * H * hs + 2 * B * W * K * hs + 4 * B * H * W
        bms, by = self.bound(sbytes, 2 * B * H * W * hs, F32_FLOPS_PER_S)
        srow = self.time_row(
            lambda t: decode_scores_hd(t[0], t[1]),
            lambda t: decode_scores_hd_ref(t[0], t[1]),
            lambda t: torch.einsum("bkgd,bwkd->bkgw",
                                   t[0].view(B, K, G, hs), t[1]),
            sets, sets, 200, 20)
        srow.update(bound_ms=bms, bound_by=by, library="torch.einsum("
                    "'bkgd,bwkd->bkgw') of the bf16 q and K slice")
        self.report(f"decode_scores_hd {shape}", srow)
        n_valid = int(mask.sum())
        vbytes = (4 * B * H * W + 2 * n_valid * K * hs + 4 * (B * W + B)
                  + 2 * B * H * hs)
        bms, by = self.bound(vbytes, 2 * H * n_valid * hs,
                             F32_FLOPS_PER_S)
        scale = 1.0 / math.sqrt(hd)

        def expression(t):
            sc = torch.where(mask[:, None, :], t[3] * scale, -1e30)
            prob = torch.softmax(sc, dim=-1).view(B, K, G, W).to(dt)
            return torch.matmul(prob, t[2].permute(0, 2, 1, 3))

        vrow = self.time_row(
            lambda t: decode_values_hd(t[3], t[2], sp, p, head_dim=hd,
                                       window=window),
            lambda t: decode_values_hd_ref(t[3], t[2], sp, p, head_dim=hd,
                                           window=window),
            None, sets, sets, 200, 20)
        vrow.update(bound_ms=bms, bound_by=by,
                    expression_ms=self.time_ms(expression, sets, 200,
                                               graph=True),
                    expression="torch.where (mask, scale) + torch.softmax + "
                               "torch.matmul with the V slice")
        self.report(f"decode_values_hd {shape}", vrow)
        print(f"    nearest expression ({vrow['expression']}): "
              f"{vrow['expression_ms']:.4f} ms (graph replay)")
        del sets
        return srow, vrow

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

    def time_scan_states(self, di, rank, arch, B=TRAIN_BATCH, S=TRAIN_SEQ,
                         plain=True):
        """The forward scan at a training shape (xr bf16, B and C views of
        the projection) by graph replay, without its boundary states (the
        serve paths' code) and with them (the train path's): what saving
        them costs. Each beside its bound by bytes (as `time_scan`'s,
        plus the states written) and, with ``plain``, the plain version
        of both, `ssm_scan_ref` (eager, one call)."""
        from repro_torch.kernels.ssm_scan import ops as scan_ops
        from repro_torch.kernels.ssm_scan import (selective_scan,
                                                  selective_scan_states)
        from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
        N = 16
        g = self.gen(14)
        sets = [self.scan_inputs(g, B, S, di, xdtype=self.torch.bfloat16,
                                 proj_rank=rank, long_memory=True)
                for _ in range(2)]
        nbytes = (B * S * di * (4 + 2 + 4) + 2 * 4 * B * S * N
                  + 4 * di * N + 2 * 4 * B * di * N)
        states = 4 * B * -(-S // scan_ops.CHUNK) * di * N
        row = {"ms": self.time_ms(lambda s: selective_scan(*s), sets, 20,
                                  graph=True),
               "states_ms": self.time_ms(lambda s: selective_scan_states(*s),
                                         sets, 20, graph=True),
               "bound_ms": self.bound(nbytes, 0)[0],
               "states_bound_ms": self.bound(nbytes + states, 0)[0],
               "plain_ms": self.time_ms(lambda s: ssm_scan_ref(*s), sets[:1],
                                        1) if plain else None}
        print(f"  ssm_scan bf16 B={B} S={S} di={di} N={N} ({arch}): without "
              f"states {row['ms']:.4f} ms (bound {row['bound_ms']:.4f} ms, "
              f"bytes), with a state every {scan_ops.CHUNK} steps "
              f"{row['states_ms']:.4f} ms (bound "
              f"{row['states_bound_ms']:.4f} ms, {states / 1e6:.1f} MB of "
              f"states more) ({row['states_ms'] / row['ms'] - 1:+.1%}); "
              f"plain ssm_scan_ref {plain_text(row['plain_ms'])}")
        return row

    def time_scan_bwd(self, B, S, di, rank, arch, plain=True):
        """The scan's backward as the train path calls it (xr bf16, B and C
        views of the projection, the model's long-memory inputs, no
        dh_final), on the forward's boundary states: the kernel by graph
        replay (and eagerly), the plain backward (`ssm_scan_ref_bwd`)
        eagerly; no PyTorch call computes it (library none). The bound is
        the largest of: the bytes (dt, xr, dy read and d(dt), dx written
        per (b, t, d); B, C read and dB, dC written per (b, t, n); one
        saved state read every ``BOUND_CHUNK`` steps, whatever interval
        the kernel reads; A read, dA and dh0 written), 20 f32 operations
        per state and step at the f32 peak, and one exponential per state
        and step on the special-function units (16 a clock per SM at the
        1.98 GHz boost); the plain backward only with ``plain``. Then
        every R of ``BWD_PER_THREAD`` by graph
        replay beside the rule's pick, each named by its R, sub-chunk,
        cluster, warps an SM and shared memory a CTA."""
        torch = self.torch
        from repro_torch.kernels.ssm_scan import ops as scan_ops
        from repro_torch.kernels.ssm_scan import (selective_scan_bwd,
                                                  selective_scan_states,
                                                  ssm_scan_ref_bwd)
        N = 16
        g = self.gen(15)
        sets = []
        for _ in range(2):
            ins = self.scan_inputs(g, B, S, di, xdtype=torch.bfloat16,
                                   proj_rank=rank, long_memory=True,
                                   h0_scale=1.0)
            hs = selective_scan_states(*ins)[2]
            sets.append((ins, hs, self.randn(g, (B, S, di), torch.float32)))
        steps = B * S * di * N
        nc = -(-S // BOUND_CHUNK)
        nbytes = (B * S * di * (4 + 2 + 4 + 4 + 2) + 4 * 4 * B * S * N
                  + 4 * B * nc * di * N + 3 * 4 * di * N + 4 * B * di * N)
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        sfu_ms = steps / (sms * 16 * SM_CLOCK_HZ) * 1e3
        bms, by = self.bound(nbytes, 20 * steps, F32_FLOPS_PER_S)
        if sfu_ms > bms:
            bms, by = sfu_ms, "operations"

        def kernel(s, R=0):
            return selective_scan_bwd(*s[0][:5], s[1], s[2], R=R)

        def design(cfg):
            return (f"R {cfg['states_per_thread']}, a state every "
                    f"{scan_ops.CHUNK} steps, sub-chunk "
                    f"{cfg['sub_chunk']}, cluster {cfg['cluster']}, "
                    f"{4 * cfg['ctas_per_sm']} warps an SM, "
                    f"{cfg['smem_bytes'] / 1024:.1f} KB a CTA")

        cfg = scan_ops.bwd_config(B, di, N)
        row = {"ms": self.time_ms(kernel, sets, 10, graph=True),
               "eager_ms": self.time_ms(kernel, sets, 10),
               "plain_ms": self.time_ms(
                   lambda s: ssm_scan_ref_bwd(*s[0], s[2]), sets[:1], 1)
               if plain else None,
               "library_ms": None, "bound_ms": bms, "bound_by": by,
               "sfu_ms": sfu_ms, "chunk": scan_ops.CHUNK, **cfg}
        self.report(f"ssm_scan_bwd B={B} S={S} di={di} N={N} xr bf16 "
                    f"[{design(cfg)}] ({arch}; "
                    f"{nbytes / 1e6:.1f} MB, {steps / 1e9:.3f}e9 state-steps, "
                    f"exponentials alone {sfu_ms:.4f} ms)", row)
        row["ms_by_states_per_thread"] = {}
        for R in scan_ops.BWD_PER_THREAD:
            ms = self.time_ms(lambda s, R=R: kernel(s, R), sets, 10,
                              graph=True)
            row["ms_by_states_per_thread"][R] = ms
            print(f"    {design(scan_ops.bwd_config(B, di, N, R=R))}: "
                  f"{ms:.4f} ms (graph replay), share of bound "
                  f"{bms / ms:.3f}")
        del sets
        return row

    def report(self, label, row):
        lib = row["library_ms"]
        print(f"  {label}: kernel {row['ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), share of bound "
              f"{row['bound_ms'] / row['ms']:.3f}, plain "
              f"{plain_text(row['plain_ms'])}, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}")
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
                         "max_abs_err": self.err[name],
                         **({"max_rel_err": self.rel_err[name]}
                            if name in self.rel_err else {}),
                         **self.timing[name], "also": self.also[name]})
        return json.dumps({"kernels": rows})


def plain_text(ms) -> str:
    """A plain version's time, or that this shape does not time it."""
    return "not timed at this shape" if ms is None else f"{ms:.4f} ms"


@contextlib.contextmanager
def cut_bundle(role, layers):
    """``serving._bundle`` answers ``role`` at full scale with its
    full-width config cut to ``layers`` layers while the block runs."""
    from repro_torch.models import serving
    bundle = serving._bundle
    cfg = bundle(role, "full")["cfg"].replace(num_layers=layers)
    cut = {"cfg": cfg, "structs": serving._structs_for(cfg)}
    serving._bundle = (lambda r, scale="tiny": cut if
                       (r, scale) == (role, "full") else bundle(r, scale))
    try:
        yield
    finally:
        serving._bundle = bundle


@contextlib.contextmanager
def no_crc32():
    """``torch.save`` without the zip records' CRC-32 while the block runs
    (where the installed torch has the switch): computing it bounds the
    save of the mesh phase's reference at ~0.8 GB/s."""
    try:
        from torch.utils.serialization import config
    except ImportError:
        config = None
    save = getattr(config, "save", None)
    old = getattr(save, "compute_crc32", None)
    if old is not None:
        save.compute_crc32 = False
    try:
        yield
    finally:
        if old is not None:
            save.compute_crc32 = old


def against_one_rank(model, state, tp, mesh, reference):
    """This rank's post-step ``state`` leaf by leaf against one rank's
    (``reference``: its params and first moments, saved whole), each leaf
    whole over every rank's shard: the first moment's largest error over
    its largest |value|, and the params' update from init (drawn again
    from the run's seed) against one rank's update in norm; the worst
    leaf of each, and how many leaves moved on one rank."""
    import torch
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import placement as P
    wait_for_file(reference)
    want = torch.load(reference, mmap=True, weights_only=True)
    init = dict(P.leaves_with_paths(model.init_params(
        torch.Generator(device=mesh.device).manual_seed(0))))
    mu = dict(P.leaves_with_paths(state.mu))
    upd_worst, mu_worst, moved = ("", 0.0), ("", 0.0), 0
    for p, leaf in P.leaves_with_paths(state.params):
        path = "/".join(map(str, p))

        def mine(t):
            return P.local_shard(t, tp.specs[path], mesh).to(
                mesh.device).float()
        # each leaf whole over every rank's shard, no gather: the sums of
        # squares of (update - one rank's update) and of one rank's
        # update, the largest first-moment error and |value|
        b, i = mine(want[f"params/{path}"]), mine(init.pop(p))
        m, m1 = mu[p], mine(want[f"mu/{path}"])
        s = C.all_reduce(torch.stack([(leaf.float() - b).square().sum(),
                                      (b - i).square().sum()]), mesh,
                         mesh.axis_names)
        x = C.all_reduce(torch.stack([(m - m1).abs().max(),
                                      m1.abs().max()]), mesh,
                         mesh.axis_names, "max")
        del b, i, m1
        moved += bool(s[1] > 0)
        upd = (s[0].sqrt() / s[1].sqrt()).item() if s[1] > 0 else (
            0.0 if s[0] == 0 else math.inf)
        upd_worst = max(upd_worst, (path, upd), key=lambda w: w[1])
        mu_worst = max(mu_worst, (path, (x[0] / x[1].clamp_min(
            1e-30)).item()), key=lambda w: w[1])
    return {"update_worst": upd_worst, "mu_worst": mu_worst,
            "moved": moved, "leaves": len(mu)}


def wait_for_file(path, timeout_s=MESH_TIMEOUT_S):
    """Wait until ``path`` exists (the parent's writer thread renames a
    one-rank reference into place once it is whole)."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written within {timeout_s} s")
        time.sleep(0.2)


def mesh_ranks(runs, shared, ckpt_shape, serves=()):
    """One rank of `Smoke.train_mesh`'s spawn (a process of its own, in a
    process group that ``repro_torch.launch.ranks.spawn`` set up):
    `mesh_rank` for each of ``runs`` in turn, each run's state freed
    before the next, then `mesh_checkpoint` on a ``ckpt_shape`` mesh,
    then `mesh_serve` for each of ``serves``."""
    import torch
    out = []
    for run in runs:
        out.append(mesh_rank(shared=shared, **run))
        gc.collect()
        torch.cuda.empty_cache()
    ckpt = mesh_checkpoint(ckpt_shape, shared)
    served = []
    for run in serves:
        gc.collect()
        torch.cuda.empty_cache()
        served.append(mesh_serve(shared=shared, **run))
    return {"runs": out, "ckpt": ckpt, "serves": served}


def registry_depth(arch) -> int:
    """``arch``'s published number of layers."""
    from repro_torch.configs import registry
    return registry.get(arch).num_layers


def serve_steps(shape, cut=None) -> int:
    """The decode steps of a serving run on a (data, model) ``shape``:
    its run's ``cut`` ({shape: steps}) where it names the shape, else
    MESH_SERVE_STEPS, or MESH_SERVE_FSDP_STEPS where data is split."""
    return (cut or {}).get(shape, MESH_SERVE_STEPS if shape[0] == 1 else
                           MESH_SERVE_FSDP_STEPS)


def cut_config(arch, layers):
    """``arch`` at full width with ``layers`` of its layers (an
    encoder-decoder's encoder cut to as many), and the dry run's
    ``extra`` of that cut."""
    from repro_torch.configs import registry
    cfg = registry.get(arch)
    extra = {"num_layers": layers}
    if cfg.is_encoder_decoder:
        extra["num_encoder_layers"] = layers
    return cfg.replace(**extra), extra


def serve_params(cfg, device):
    """Seed-0 params of ``cfg`` on ``device``, the QKV biases (where the
    config has them) drawn nonzero from seed 9, as phase 3 draws them."""
    import torch
    from repro_torch.models import Model
    params = Model(cfg, device=device).init_params(
        torch.Generator(device=device).manual_seed(0))
    if cfg.attn_bias:
        g = torch.Generator(device=device).manual_seed(9)
        for name in ("bq", "bk", "bv"):
            leaf = params["layers"]["attn"][name]
            leaf.copy_(torch.randn(tuple(leaf.shape), generator=g,
                                   device=device).to(leaf.dtype))
    return params


def serve_len(arch) -> int:
    """A serving run's prompt: PROMPT, or the one ``CUT`` gives ``arch``
    (mixtral-8x22b's 8192, twice its window)."""
    return CUT.get(arch, (None, PROMPT))[1]


def serve_batch(cfg, device):
    """The serving runs' prefill batch, seed 2: MESH_SERVE_BATCH x
    `serve_len` tokens; for the vlm family as many bf16 embeddings
    (``inputs_embeds``); for an encoder-decoder a target prefix of as
    many tokens and as many bf16 source frames (``src_embeds``)."""
    import torch
    g = torch.Generator(device=device).manual_seed(2)
    shape = (MESH_SERVE_BATCH, serve_len(cfg.name))
    toks = torch.randint(0, cfg.vocab_size, shape, dtype=torch.int32,
                         device=device, generator=g)
    if not cfg.embed_input:
        return {"tokens": toks}
    emb = torch.randn(shape + (cfg.d_model,), generator=g,
                      device=device).to(torch.bfloat16)
    if cfg.is_encoder_decoder:
        return {"src_embeds": emb, "tgt_tokens": toks}
    return {"inputs_embeds": emb}


def mesh_serve(arch, layers, shape, shared, logits, tokens, ssm=None,
               routes=None):
    """One rank of a serving run (`Smoke.check_mesh_serve`): ``arch`` at
    full width cut to ``layers`` on this rank of the (data, model)
    ``shape`` mesh (`rank_mesh_of`) under the reference's serving
    shardings (``launch.sharding.serve_placement``): `serve_params` cut to
    this rank's shards, a prefill of its rows of `serve_batch`,
    ``kv_cache.to_decode_layout``, and a decode step for each of one
    rank's ``tokens`` (teacher-forced), with every kernel's launches
    counted from 0 just before the prefill and read after the last step,
    the collectives of the prefill, the reshard and each step by kind,
    the model-axis gathers of the prefill and of the decode steps by
    path, walls, peak memory, the params' and decode cache's bytes on
    the card and the dry run's decode-step argument bytes at this mesh;
    then every output's logits gathered whole against one rank's
    ``logits``, and the last step's f32 ``ssm`` state gathered over
    ``model`` against one rank's ``ssm`` (where given). With ``routes``
    (the moe family: one rank's experts, router call by router call) a
    `RouteLog` of this rank's routing, its data rank's rows of each call,
    which pins it to one rank's experts where they differ. The ranks draw
    the whole params and cut their shards one at a time, so the card
    holds one whole copy at once."""
    t0 = time.monotonic()
    import torch
    import torch.distributed as dist
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import Model
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models import moe
    from repro_torch.models.registry import param_structs
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import placement as P
    cfg, extra = cut_config(arch, layers)
    mesh = rank_mesh_of(shape, shared)
    dev = mesh.device
    tp = SH.serve_placement(mesh, param_structs(cfg), kvc.init_cache(
        cfg, MESH_SERVE_BATCH, serve_len(arch), device="meta"))
    log = (RouteLog(torch, moe, routes, part=(
        dist.get_rank() // shape[1], shape[0] if tp.rows_split else 1))
        if routes else None)
    params = None
    for r in range(dist.get_world_size()):    # one whole copy at a time
        if r == dist.get_rank():
            whole = serve_params(cfg, dev)
            params = P.params_to_mesh(whole, tp)
            del whole
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    model = Model(cfg, device=dev)

    def rows(t):
        return P.local_shard(t, SH.batch_spec("t", tuple(t.shape), mesh),
                             mesh)

    def timed(fn):
        torch.cuda.synchronize(dev)
        mesh.stats.reset()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t1, mesh.stats.summary()

    batch = {k: rows(v) for k, v in serve_batch(cfg, dev).items()}
    counters = Smoke.counters()
    for mod in counters.values():
        mod.launches = 0
    t1 = time.monotonic()
    with log.run() if log else contextlib.nullcontext():
        (out, cache), prefill_s, prefill_c = timed(
            lambda: model.prefill(params, batch, tp=tp))
        cache, reshard_s, reshard_c = timed(
            lambda: kvc.to_decode_layout(cache, tp))
        prefill_g = dict(tp.gathers)
        tp.gathers.clear()
        nbytes = {"params": P.state_bytes(params),
                  "cache": P.state_bytes(cache)}
        outs, step_s, step_c = [out], [], []
        for tok in tokens:
            t = rows(tok.to(dev))
            (out, cache), sec, c = timed(
                lambda t=t: model.decode_step(params, cache, t, tp=tp))
            outs.append(out)
            step_s.append(sec)
            step_c.append(c)
    launches = {n: m.launches for n, m in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    decode_g = dict(tp.gathers)
    t2 = time.monotonic()
    state = None
    if ssm is not None:
        full = P.gather_full(cache["ssm"], tp.specs["cache/decode/ssm"],
                             mesh)
        want = ssm.to(dev)
        state = {"err": (full - want).abs().max().item(),
                 "close": torch.allclose(full, want, atol=MESH_SERVE_ATOL,
                                         rtol=MESH_SERVE_RTOL),
                 "shape": tuple(full.shape)}
        del full, want
    errs, close, flips, compared = [], True, 0, 0
    for out, want in zip(outs, logits):
        full = P.gather_full(out, tp.specs["logits"], mesh)
        want = want.to(dev)
        errs.append((full - want).abs().max().item())
        close &= torch.allclose(full, want, atol=MESH_SERVE_ATOL,
                                rtol=MESH_SERVE_RTOL)
        top = want.topk(2, dim=-1).values
        sure = (top[..., 0] - top[..., 1]) > (
            MESH_SERVE_ATOL + MESH_SERVE_RTOL * top[..., 0].abs())
        same = full.argmax(-1) == want.argmax(-1)
        flips += int((sure & ~same).sum())
        compared += int(sure.sum())
    cell = dryrun.build_cell(arch, InputShape(
        "decode", serve_len(arch), MESH_SERVE_BATCH, "decode"), extra=extra,
        mesh=Mesh(mesh.axis_names, mesh.sizes))
    local = []
    if cfg.family == "moe":
        e0, e1 = tp.split(cfg.num_experts)
        local.append(f"experts [{e0}, {e1}) of {cfg.num_experts}, w_gate "
                     f"spec {tp.specs['layers/moe/w_gate']}")
    if "k" in cache:
        h0, h1 = tp.split(cfg.num_heads)
        local.append(f"q heads [{h0}, {h1}) of {cfg.num_heads}; decode "
                     f"cache k {tuple(cache['k'].shape)} (hd slice "
                     f"{cache['k'].shape[-1]} of {cfg.head_dim})" + (
                         f", cross_k {tuple(cache['cross_k'].shape)}"
                         if "cross_k" in cache else ""))
    if "ssm" in cache:
        c0, c1 = tp.split(cfg.d_inner)
        local.append(f"d_inner channels [{c0}, {c1}) of {cfg.d_inner}; "
                     f"conv {tuple(cache['conv'].shape)}, ssm "
                     f"{tuple(cache['ssm'].shape)}")
    v0, v1 = tp.split(cfg.vocab_size)
    local.append(f"vocab [{v0}, {v1}) of {cfg.vocab_size}, logits spec "
                 f"{tp.specs['logits']}")
    return {"device": str(dev), "note": C.backend_note(mesh),
            "local": "; ".join(local), "launches": launches, "peak": peak,
            "prefill_gathers": prefill_g, "decode_gathers": decode_g,
            "state": state, "routing": log.calls if log else None,
            "prefill_s": prefill_s, "reshard_s": reshard_s,
            "step_s": step_s, "prefill_c": prefill_c,
            "reshard_c": reshard_c, "step_c": step_c, "errs": errs,
            "close": bool(close), "flips": flips, "compared": compared,
            "bytes": nbytes, "dry": cell.argument_bytes(),
            "mesh": f"{cell.mesh.name}, {cell.step}",
            "seconds": {"start": t1 - t0, "serve": t2 - t1,
                        "checks": time.monotonic() - t2}}


def rank_mesh_of(shape, shared):
    """This rank's ``launch.mesh.rank_mesh`` of the (data, model)
    ``shape`` over the spawn's process group, on the device `join_mesh`
    gives it: card 0 for every rank (``shared``, gloo) or
    ``cuda:{LOCAL_RANK}`` (NCCL)."""
    import torch
    import torch.distributed as dist
    from repro_torch.device import rank_device
    from repro_torch.launch.mesh import rank_mesh
    dev = rank_device("cuda", shared=shared)
    if dev.index is not None:
        torch.cuda.set_device(dev)
    return rank_mesh(("data", "model"), shape, device=dev,
                     backend=dist.get_backend())


def mesh_checkpoint(shape, shared):
    """A sharded checkpoint's round trip on this rank of a (data, model)
    ``shape`` mesh (`rank_mesh_of`), at llama3-8b's smoke config: 2
    steps through ``train.run``, whose ``AsyncCheckpointer.save(step,
    state, tp)`` gathers every leaf to rank 0 at step 2, then a run with
    ``--resume`` semantics on the same store, whose `restore_to_mesh`
    broadcasts each leaf from rank 0 and cuts this rank's shard; every
    restored shard against the saved one, bit for bit."""
    import torch
    from repro_torch.checkpoint.ckpt import _items
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.parallel import collectives as C
    t0 = time.monotonic()
    cfg = registry.get_smoke("llama3-8b")
    mesh = rank_mesh_of(shape, shared)
    counters = Smoke.counters()
    for mod in counters.values():
        mod.launches = 0
    runtime = train.build_runtime()
    saved = train.run(cfg, steps=2, batch=2, seq=64, ckpt_every=2,
                      mesh=mesh, runtime=runtime)
    restored = train.run(cfg, steps=0, batch=2, seq=64, resume=True,
                         mesh=mesh, runtime=runtime)
    a, b = (dict(_items(r["state"])) for r in (saved, restored))
    same = list(a) == list(b) and all(
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        for x, y in zip(a.values(), b.values()))
    return {"shape": shape, "same": same, "leaves": len(b),
            "start_step": restored["start_step"],
            "objects": len(runtime[0].list_bucket("ckpts")),
            "device": str(mesh.device), "note": C.backend_note(mesh),
            "launches": {n: m.launches for n, m in counters.items()},
            "seconds": time.monotonic() - t0}


def mesh_rank(arch, layers, shape, shared, reference, routes=None):
    """One rank of `Smoke.phase_train_mesh` (a process of its own, in a
    process group that ``repro_torch.launch.ranks.spawn`` set up): the
    steps of ``arch`` at full width, ``layers`` of its layers, on the
    (data, model) ``shape`` mesh: ``train.run(mesh="debug")`` for
    (1, n), else a `rank_mesh_of` passed to ``train.run`` (``shared``:
    every rank on card 0 over gloo, passed explicitly; else NCCL on
    ``cuda:{LOCAL_RANK}``) with every kernel's launches counted from 0,
    the requested bytes the card holds with only the train state alive
    and the dry run's on that mesh, then, leaf by leaf against one
    rank's (``reference``), each over every rank's
    shard: the first moment's largest error over its largest |value|,
    and the params' update from init (drawn again from the run's seed)
    in norm. With ``routes`` (one rank's experts, call by call, of the
    moe family) a `RouteLog` of this rank's routing against them (its
    data rank's tokens of them), which holds the rank to one rank's
    experts where they differ."""
    t0 = time.monotonic()
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import InputShape, registry
    from repro_torch.launch import dryrun
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.placement import axes_of
    cfg = registry.get(arch).replace(num_layers=layers)
    d = dist.get_rank() // shape[1]                  # the data rank
    log = (RouteLog(torch, moe, torch.load(routes, weights_only=True),
                    part=(d, shape[0])) if routes else None)
    counters = Smoke.counters()
    for mod in counters.values():
        mod.launches = 0
    if torch.cuda.is_initialized():       # this rank's card, an earlier run
        torch.cuda.reset_peak_memory_stats()
    t1 = time.monotonic()
    with log.run() if log else contextlib.nullcontext():
        if shape[0] == 1:
            res = train.run(cfg, steps=MESH_STEPS, batch=TRAIN_BATCH,
                            seq=TRAIN_SEQ, ckpt_every=MESH_STEPS + 1,
                            device="cuda" if shared else None,
                            backend="gloo" if shared else None,
                            mesh="debug")
        else:
            res = train.run(cfg, steps=MESH_STEPS, batch=TRAIN_BATCH,
                            seq=TRAIN_SEQ, ckpt_every=MESH_STEPS + 1,
                            mesh=rank_mesh_of(shape, shared))
    launches = {n: m.launches for n, m in counters.items()}
    t2 = time.monotonic()
    state, tp, mesh = res.pop("state"), res["tp"], res["mesh"]
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    requested = torch.cuda.memory_stats(mesh.device)[
        "requested_bytes.all.current"]
    cell = dryrun.build_cell(arch, InputShape(
        "train", TRAIN_SEQ, TRAIN_BATCH, "train"), extra={
            "num_layers": layers}, mesh=Mesh(mesh.axis_names, mesh.sizes))
    local = []
    if cfg.num_heads:
        h0, h1 = tp.split(cfg.num_heads)
        G = cfg.num_heads // cfg.num_kv_heads
        k0, k1 = h0 // G, (h1 - 1) // G + 1
        aligned = (h0 % G == 0 and h1 % G == 0) or k1 - k0 == 1
        local.append(f"q heads [{h0}, {h1}) of {cfg.num_heads}, kv "
                     f"[{k0}, {k1}) of {cfg.num_kv_heads}"
                     + ("" if aligned else ", one kv head a q head (G 1)"))
    if cfg.family in ("ssm", "hybrid"):
        c0, c1 = tp.split(cfg.d_inner)
        local.append(f"d_inner channels [{c0}, {c1}) of {cfg.d_inner}")
    if cfg.family == "moe":
        e0, e1 = tp.split(cfg.num_experts)
        local.append(f"experts [{e0}, {e1}) of {cfg.num_experts}, w_gate "
                     f"spec {tp.specs['layers/moe/w_gate']}")
    v0, v1 = tp.split(cfg.vocab_size)
    local.append(f"vocab [{v0}, {v1}) of {cfg.vocab_size}, embed spec "
                 f"{tp.specs['embed']}")
    if shape[0] > 1:
        local.append(f"batch rows [{d * TRAIN_BATCH // shape[0]}, "
                     f"{(d + 1) * TRAIN_BATCH // shape[0]}) of {TRAIN_BATCH}")
    # FSDP: a params leaf split over the data axes, gathered where used
    fsdp = mesh.group(tp.data) is not None and any(
        a in tp.data for spec in tp.specs.values() for entry in spec
        for a in axes_of(entry))
    out = {"records": res["records"], "launches": launches,
           "requested": requested, "dry": cell.argument_bytes()["state"],
           "mesh": f"{cell.mesh.name}, {cell.step}",
           "state_bytes": res["state_bytes"], "gathers": tp.gathers,
           "fsdp": fsdp, "gathers_placement": fsdp or bool(tp.gathers),
           "peak": torch.cuda.max_memory_allocated(mesh.device),
           "device": str(mesh.device), "note": C.backend_note(mesh),
           "local": "; ".join(local),
           "routing": log.calls if log else None}
    out.update(against_one_rank(res["model"], state, tp, mesh, reference))
    out["seconds"] = {"start": t1 - t0, "train.run": t2 - t1,
                      "checks": time.monotonic() - t2}
    return out


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
    for arch in ARCHS + tuple(CUT):
        cut = (f" (cut to {CUT[arch][0]} layers, prompt {CUT[arch][1]})"
               if arch in CUT else "")
        phases.append((f"serve and trace {arch}{cut}",
                       lambda arch=arch: smoke.serve_path(arch)))
    for arch in EMBEDS:
        phases.append((f"embeds and enc-dec {arch}",
                       lambda arch=arch: smoke.embeds_path(arch)))
    phases.append(("train", smoke.phase_train))
    served = "; ".join(
        f"{arch} {layers} of {registry_depth(arch)} layers on "
        f"{', '.join(map(str, shapes))}" + "".join(
            f" (cut to {n} decode steps on {shape})"
            for cut in cuts for shape, n in cut.items())
        for arch, layers, shapes, *cuts in MESH_SERVE_RUNS)
    phases.append((f"train (mesh; one spawn a count of ranks; the one-rank "
                   f"references' files written beside the phase, off its "
                   f"path), "
                   f"then serve in the same spawns ({served}; "
                   f"{MESH_SERVE_FSDP_STEPS} of {MESH_SERVE_STEPS} decode "
                   f"steps on (2, 2))",
                   smoke.phase_train_mesh))
    phases.append(("mlserve cores", smoke.phase_mlserve))
    phases.append(("worker node", smoke.phase_node))
    phases.append(("density", smoke.phase_density))
    phases.append(("fleet and plancheck", smoke.phase_fleet))
    phases.append(("dry run", smoke.phase_dryrun))
    phases.append(("timing (the plain scans at the training shapes only)",
                   smoke.phase_timing))
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
