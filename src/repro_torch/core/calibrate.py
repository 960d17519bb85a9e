"""The MLServe calibration, read side: roles, serving shapes, shards.

A copy of the consumer half of ``repro.core.calibrate``. The reference
derives ``calibration.json`` from its analytic FLOPs model and commits
it; the port keeps a byte-identical copy next to this module and only
reads it. It never regenerates the numbers, so the derivation
(``_derive_role``, ``derive_calibration``, ``dump_calibration``, the
command line and the machine profiles they price with) is left out.

Two scales share one set of names:

* ``full`` — the published configs, sized per device of the
  reference's 8-device serving slice;
* ``tiny`` — the SMOKE configs, whose sizes are the exact byte counts
  of the payloads the serving cores read and write.

Every constant has the reference's value.
"""
from __future__ import annotations

import json
import os

#: the committed calibration database, a copy of the reference's
CALIBRATION_PATH = os.path.join(os.path.dirname(__file__),
                                "calibration.json")

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


def shard_bytes(total: int, shards: int) -> list[int]:
    """Deterministic near-even split of `total` bytes into `shards`
    contiguous chunks (every chunk non-empty; sizes sum exactly)."""
    if total < shards:
        raise ValueError(f"cannot split {total}B into {shards} shards")
    base, rem = divmod(total, shards)
    return [base + (1 if i < rem else 0) for i in range(shards)]


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
        raise KeyError(f"no calibration for {scale}/{role}") from None
