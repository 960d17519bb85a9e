"""Calibrated ML compute costs: model analysis -> PhasePlan durations.

A copy of ``repro.core.calibrate``, both halves. The DES and the SLO
denominators price a `ComputeSegment` in Mcycles at the paper's 2.1 GHz;
for the MLServe suite those budgets come from the models themselves:

    repro_torch.models.flops (analytic FLOPs / HBM bytes per arch x
    serving shape)
        -> `MachineProfile` roofline  time = max(flops/peak, bytes/bw)
        -> Mcycles at `fabric.GHZ_MCYC_PER_S`  (the DES cycle currency)

and the result is the committed ``calibration.json`` next to this
module, byte-identical to the reference's, so `workloads.ml_suite()` is
pure data and every DES run prices the same costs.

Two scales share one set of names:

* ``full`` — the published configs, priced on ``MACHINES['full']`` and
  sized per device of an 8-device serving slice;
* ``tiny`` — the SMOKE configs on ``MACHINES['tiny']``, whose sizes are
  the exact byte counts of the payloads the serving cores read and write
  (`serving.role_sizes` over the port's meta-device structs).

Regeneration (``python -m repro_torch.core.calibrate --write``, which
rewrites this package's ``calibration.json`` only) is deterministic:
pure shape and flop arithmetic, no RNG, no timestamps;
``--check`` fails unless the committed file regenerates exactly. Every
constant has the reference's value.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass

from repro_torch.core import fabric as F

#: the committed calibration database, a copy of the reference's
CALIBRATION_PATH = os.path.join(os.path.dirname(__file__),
                                "calibration.json")

CALIBRATION_VERSION = 2

#: MLServe model roles -> registry arch ids. `full` uses the published
#: CONFIG, `tiny` the same module's SMOKE config.
ML_ROLES = {
    "llm": "llama3-8b",            # dense GQA decoder: prefill + decode
    "moe": "qwen3-moe-30b-a3b",    # expert-shard fan-in
    "emb": "granite-8b",           # batch encode
}

#: (batch, seq_len) per calibrated phase, per scale. `tiny` shapes are
#: what the cores run on the SMOKE configs; `full` are serving-realistic.
SERVING_SHAPES: dict[str, dict[str, tuple[int, int]]] = {
    "full": {"prefill": (1, 2048), "decode": (8, 2048),
             "encode": (32, 512)},
    "tiny": {"prefill": (1, 32), "decode": (1, 32), "encode": (4, 16)},
}

#: how many objects a role's weights are sharded into (LLM-COLD
#: fetches `LLM_WEIGHT_SHARDS` GETs, MOE fans in `MOE_SHARDS`: one
#: backbone + top-k expert shards). Roles absent here (emb) do not
#: shard and get no `weights_shard_bytes` entry.
ROLE_SHARDS = {"llm": 4, "moe": 3}
LLM_WEIGHT_SHARDS = ROLE_SHARDS["llm"]
MOE_SHARDS = ROLE_SHARDS["moe"]

SCALES = tuple(SERVING_SHAPES)
PHASES = ("prefill", "decode", "encode")


@dataclass(frozen=True)
class MachineProfile:
    """The serving substrate a calibration targets, as pure data.

    ``mcycles(flops, hbm_bytes)`` is a two-term roofline: compute time
    at ``mfu`` x dense peak vs HBM-streaming time, whichever binds,
    expressed in the DES's Mcycle currency (2.1 GHz host cycles) so a
    calibrated `ComputeSegment` drops into the cost model unchanged.
    """

    name: str
    peak_tflops: float              # dense bf16 peak, per device
    hbm_gbps: float                 # HBM bandwidth, per device
    mfu: float = 0.45               # achieved fraction of peak
    devices: int = 1                # serving-slice size (shards weights)
    ghz_mcyc_per_s: float = F.GHZ_MCYC_PER_S

    def seconds(self, flops: float, hbm_bytes: float) -> float:
        compute = flops / (self.peak_tflops * 1e12 * self.mfu)
        memory = hbm_bytes / (self.hbm_gbps * 1e9)
        return max(compute, memory)

    def mcycles(self, flops: float, hbm_bytes: float) -> float:
        return self.seconds(flops, hbm_bytes) * self.ghz_mcyc_per_s


#: the reference's modeled serving profiles, copied value for value: they
#: define the committed calibration the port's DES prices with, and are
#: not the rate of any device the port runs on
MACHINES: dict[str, MachineProfile] = {
    # the modeled 8-device slice of the full-scale serving deployment
    "full": MachineProfile("hbm-accel-8x", peak_tflops=275.0,
                           hbm_gbps=1200.0, mfu=0.45, devices=8),
    # one CPU core running the SMOKE configs (what handlers execute)
    "tiny": MachineProfile("cpu-smoke", peak_tflops=0.005, hbm_gbps=8.0,
                           mfu=1.0, devices=1),
}


def shard_bytes(total: int, shards: int) -> list[int]:
    """Deterministic near-even split of `total` bytes into `shards`
    contiguous chunks (every chunk non-empty; sizes sum exactly)."""
    if total < shards:
        raise ValueError(f"cannot split {total}B into {shards} shards")
    base, rem = divmod(total, shards)
    return [base + (1 if i < rem else 0) for i in range(shards)]


# ---------------------------------------------------------------- derivation

def _derive_role(scale: str, role: str) -> dict:
    """One (scale, role) calibration entry. Imports the models lazily:
    only regeneration pays for it; consumers read the committed JSON."""
    from repro_torch.configs import InputShape, registry
    from repro_torch.models import serving
    from repro_torch.models.flops import hbm_bytes_ideal, model_flops

    arch = ML_ROLES[role]
    cfg = registry.get(arch) if scale == "full" else registry.get_smoke(arch)
    machine = MACHINES[scale]
    shapes = SERVING_SHAPES[scale]

    phases = {}
    for phase in PHASES:
        B, S = shapes[phase]
        kind = "decode" if phase == "decode" else "prefill"
        ishape = InputShape(f"serve_{phase}", S, B, kind)
        flops = model_flops(cfg, ishape)["total"] / machine.devices
        hbm = hbm_bytes_ideal(cfg, ishape, devices=machine.devices)
        phases[phase] = {
            "batch": B, "seq_len": S,
            "flops_per_device": round(flops, 3),
            "hbm_bytes_per_device": round(hbm, 3),
            "seconds": round(machine.seconds(flops, hbm), 9),
            "mcycles": round(machine.mcycles(flops, hbm), 6),
        }

    # exact serialized byte sizes, per device: at tiny scale the cores'
    # payload sizes, at full scale the same shape arithmetic over the
    # published config, divided across the slice
    sizes = serving.role_sizes(cfg, devices=machine.devices)
    entry = {"arch": cfg.name, "family": cfg.family, **sizes,
             "phases": phases}
    if role in ROLE_SHARDS:
        entry["weights_shard_bytes"] = shard_bytes(
            entry["params_bytes"], ROLE_SHARDS[role])
    return entry


def derive_calibration() -> dict:
    """Recompute the whole calibration database (both scales): pure
    arithmetic over configs, the same on every invocation."""
    return {
        "version": CALIBRATION_VERSION,
        "ghz_mcyc_per_s": F.GHZ_MCYC_PER_S,
        "machines": {s: asdict(m) for s, m in MACHINES.items()},
        "serving_shapes": {s: {p: list(bs) for p, bs in sh.items()}
                           for s, sh in SERVING_SHAPES.items()},
        "models": {f"{scale}/{role}": _derive_role(scale, role)
                   for scale in SCALES for role in ML_ROLES},
    }


# ------------------------------------------------------------------- access

_cache: dict | None = None


def load_calibration() -> dict:
    """The committed calibration database (cached)."""
    global _cache
    if _cache is None:
        with open(CALIBRATION_PATH) as f:
            _cache = json.load(f)
    return _cache


def model_entry(scale: str, role: str, cal: dict | None = None) -> dict:
    cal = cal if cal is not None else load_calibration()
    try:
        return cal["models"][f"{scale}/{role}"]
    except KeyError:
        raise KeyError(
            f"no calibration for {scale}/{role} — regenerate with "
            f"`python -m repro_torch.core.calibrate --write`") from None


def dump_calibration(cal: dict, path: str | None = None) -> str:
    path = path or CALIBRATION_PATH
    with open(path, "w") as f:
        json.dump(cal, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def main(argv=None) -> bool:
    """``--write`` rewrites the committed file; otherwise print whether it
    regenerates exactly (``--check``: exit 1 unless it does). Returns
    whether it matched."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--write", action="store_true",
                    help="rewrite the committed calibration.json")
    ap.add_argument("--check", action="store_true",
                    help="fail unless the committed file regenerates "
                         "bit-identically")
    args = ap.parse_args(argv)
    cal = derive_calibration()
    if args.write:
        print(f"wrote {dump_calibration(cal)}")
        return True
    same = load_calibration() == cal
    print(json.dumps({k: v for k, v in cal.items() if k != "models"},
                     indent=1, sort_keys=True))
    print(f"models calibrated: {sorted(cal['models'])}")
    print(f"matches committed calibration.json: {same}")
    if args.check and not same:
        raise SystemExit(1)
    return same


if __name__ == "__main__":
    main()
