"""Where the selective scan's backward spends its time, on one NVIDIA GPU.

Builds copies of ``csrc/ssm_scan_bwd.cu`` with one part of the kernel
taken out each (the loads of the next interval, the stores of d(dt) and
dx, the (dt, dt * x) pass, the recompute's recurrence, the pass that
gives R 4's second sub-chunk its entering state, the reverse walk,
the cluster's barriers and sum, the block's sum over its warps, the
shuffles of the dB | dC and of the lane sums), and times each against
the kernel as it is, at falcon-mamba-7b's and hymba-1.5b's training
shapes (B 2 x S 4096, xr bf16, the model's long-memory inputs) and at
every R the kernel takes. What a copy saves is what that part costs, to
within what the others overlap. The copies compute wrong gradients; only
their times are read. A cut whose lines the source no longer has raises.
Times are CUDA-graph replays (``chip_smoke.Smoke.time_ms``). From the
root of the repository:

    PYTHONPATH=src python3 -m repro_torch.kernels.ssm_scan.ablation

prints the card's name and power limit and one line per (shape, copy,
R). Needs the card and nvcc.
"""
from __future__ import annotations

import subprocess
import sys

#: each copy: the lines taken out (text -> replacement) of the source
CUTS = {
    "no_fetch": [("    if (c > 0) fetch(c - 1, buf ^ 1);", "")],
    "no_store": [("    store(c, buf);\n", "")],
    "no_settle": [("    settle(buf);\n", "")],
    "no_recompute": [("          step(h, av, buf, i0 + i);\n", "")],
    "no_prepass": [("        step(h, av, buf, i);\n", "")],
    "no_reverse": [("      for (int grp = L / G - 1; grp >= 0; --grp) {",
                    "      for (int grp = L / G - 1; grp >= L; --grp) {")],
    "no_cluster": [
        ("        cluster_sum(c + 1);\n", ""),
        ("    cluster_arrive();                 // the interval's rows are "
         "written\n", ""),
        ("        cluster_wait();\n", ""),
        ("  if (a.nc > 0) {\n    cluster_wait();\n    cluster_sum(0);\n  }\n",
         "")],
    "no_block_sum": [("      block_sum(q, c, i0);\n", "")],
    "no_bc_shuffle": [
        ("v[j] = keep + __shfl_xor_sync(FULL, send, w);",
         "v[j] = keep + send;"),
        ("v[0] += __shfl_xor_sync(FULL, v[0], w);", "v[0] += v[0];")],
    "no_lane_shuffle": [
        ("sa[j] = keep_a + __shfl_xor_sync(FULL, send_a, w);",
         "sa[j] = keep_a + send_a;"),
        ("sx[j] = keep_x + __shfl_xor_sync(FULL, send_x, w);",
         "sx[j] = keep_x + send_x;")],
}
SHAPES = ((2, 4096, 8192, 256, "falcon-mamba-7b"),
          (2, 4096, 3200, 100, "hymba-1.5b"))


def copies(source: str) -> dict[str, str]:
    """The source as is and each copy of ``CUTS``."""
    out = {"as is": source}
    for name, cuts in CUTS.items():
        text = source
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ops as scan_ops

    def log(line):
        print(line, flush=True)

    log(cs.nvidia_smi())
    work = _build.BUILD_DIR.parent / "ablation"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    texts = copies(_build.source(scan_ops.BWD_NAME).read_text())
    for i, (name, text) in enumerate(texts.items()):
        src = work / f"copy{i}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = lib

    smoke = cs.Smoke(torch)
    g = smoke.gen(16)
    for B, S, di, rank, arch in SHAPES:
        sets = []
        for _ in range(2):
            ins = smoke.scan_inputs(g, B, S, di, xdtype=torch.bfloat16,
                                    proj_rank=rank, long_memory=True,
                                    h0_scale=1.0)
            hs = scan_ops.selective_scan_states(*ins)[2]
            sets.append((ins, hs, smoke.randn(g, (B, S, di), torch.float32)))
        for name, lib in libs.items():
            with _build.substitute(scan_ops.BWD_NAME, lib):
                for R in scan_ops.BWD_PER_THREAD:
                    ms = smoke.time_ms(
                        lambda s, r=R: scan_ops.selective_scan_bwd(
                            *s[0][:5], s[1], s[2], R=r), sets, 10, graph=True)
                    log(f"{arch} B={B} S={S} di={di} {name:16s} R {R}: "
                        f"{ms:.4f} ms")
        del sets
    log(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
