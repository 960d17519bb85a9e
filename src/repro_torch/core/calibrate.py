"""The MLServe calibration, read side: roles, serving shapes, shards.

A copy of the consumer half of ``repro.core.calibrate``. The reference
derives ``calibration.json`` from its analytic FLOPs model and commits
it; the port keeps a byte-identical copy next to this module and only
reads it. It never regenerates the numbers, so the derivation
(``_derive_role``, ``derive_calibration``, ``dump_calibration`` and the
command line) is left out.

Two scales share one set of names:

* ``full`` — the published configs, sized per device of the
  reference's 8-device serving slice (`MACHINES['full']`);
* ``tiny`` — the SMOKE configs, whose sizes are the exact byte counts
  of the payloads the serving cores read and write.

`MACHINES` is the reference's calibration model, copied as data: its
peak and bandwidth figures are the reference's assumptions for an
accelerator slice, not measurements of the card the port runs on.
Every constant has the reference's value.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

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
    expressed in the Mcycle currency (2.1 GHz host cycles) of the
    reference's cost model.
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


MACHINES: dict[str, MachineProfile] = {
    # the reference's 8-device accelerator slice (its per-device figures)
    "full": MachineProfile("hbm-accel-8x", peak_tflops=275.0,
                           hbm_gbps=1200.0, mfu=0.45, devices=8),
    # one CPU core running the SMOKE configs
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


# ------------------------------------------------------------------- access

_cache: dict | None = None


def load_calibration(path: str | None = None) -> dict:
    """The committed calibration database (cached)."""
    global _cache
    if path is None:
        if _cache is None:
            with open(CALIBRATION_PATH) as f:
                _cache = json.load(f)
        return _cache
    with open(path) as f:
        return json.load(f)


def model_entry(scale: str, role: str, cal: dict | None = None) -> dict:
    cal = cal if cal is not None else load_calibration()
    try:
        return cal["models"][f"{scale}/{role}"]
    except KeyError:
        raise KeyError(f"no calibration for {scale}/{role}") from None
