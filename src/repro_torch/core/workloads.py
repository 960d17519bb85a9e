"""vSwarm-like workload suite (paper §6) on the FaaS programming model.

A workload is a conventional serverless function: ``handler(event, ctx)``
where ``ctx.storage`` is the boto3-compatible surface the platform
injects (`frontend.S3Api`) — the handler issues its own
``get_object``/``put_object`` calls, in any number and order, and never
learns which system variant is underneath (the paper's transparency
claim, §4.2). Alongside the handler, each workload declares a
first-class `IOProfile` — the ordered GET/compute/PUT shape with sizes
and prefetchability — which is what `plan.compile_plan` turns into the
variant's phase DAG and what the DES/SLO denominator prices without
executing guest code. The profile is a *contract*: the runtime checks
the handler's observed calls against it and rejects divergence.

A copy of the I/O-profile types, `Workload` and the MLServe suite of
``repro.core.workloads``. The paper suite (``SUITE``, ``SCENARIOS``), the
arrival patterns and ``chaos_suite`` are not copied yet, so `REGISTRY`,
the deployable-by-name set, is empty: `runtime.WorkerNode.deploy` by name
raises `KeyError`, as the reference's does for an unknown name. The
MLServe handlers mirror the reference's storage call for storage call;
each also hands the core the device the node runs on (``ctx.device``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

MB = 1024 * 1024


# ------------------------------------------------------------- I/O profiles

@dataclass(frozen=True)
class Get:
    """One declared object GET. `prefetchable` marks a deterministic
    ingress hint (bucket/key/size known before the VM is up, §4.2.2).

    The SharedCache plane (`core/cache.py`) reads three more fields:
    `key` names the logical object the GET re-reads across invocations
    (``None`` -> positional, distinct per op); `shared` marks content
    identical across deployed copies of the workload (weight shards —
    dedups in the cache); `cacheable` opts a GET out of cache admission
    entirely (streaming-ish reads not worth caching)."""

    size_bytes: int
    prefetchable: bool = True
    key: str | None = None
    shared: bool = False
    cacheable: bool = True


@dataclass(frozen=True)
class Put:
    """One declared durable object PUT (the response gates on its ack).
    `key` names the logical output stream for the cache plane's
    write-allocation (``None`` -> positional)."""

    size_bytes: int
    key: str | None = None


@dataclass(frozen=True)
class ComputeSegment:
    """Guest vCPU work between I/O calls, in Mcycles at 2.1 GHz."""

    mcycles: float


Op = Get | Put | ComputeSegment


@dataclass(frozen=True)
class IOProfile:
    """Ordered I/O declaration of one handler.

    The op order is the handler's program order: the k-th ``get_object``
    call the handler makes corresponds to the k-th `Get`, and the wall
    time between consecutive I/O calls is attributed to the
    `ComputeSegment`s declared between them.
    """

    ops: tuple[Op, ...]

    def __post_init__(self):
        for op in self.ops:
            if not isinstance(op, (Get, Put, ComputeSegment)):
                raise TypeError(f"bad IOProfile op: {op!r}")

    # ------------------------------------------------------------- queries

    @property
    def gets(self) -> tuple[Get, ...]:
        return tuple(o for o in self.ops if isinstance(o, Get))

    @property
    def puts(self) -> tuple[Put, ...]:
        return tuple(o for o in self.ops if isinstance(o, Put))

    @property
    def segments(self) -> tuple[ComputeSegment, ...]:
        return tuple(o for o in self.ops if isinstance(o, ComputeSegment))

    @property
    def shape(self) -> tuple[tuple, ...]:
        """Size-free structure — the plan-compiler cache key. Only the
        *first* GET's prefetchability shapes the graph (only it may
        start at ingress), so later flags are normalized away."""
        out, seen_get = [], False
        for op in self.ops:
            if isinstance(op, Get):
                out.append(("get", op.prefetchable and not seen_get))
                seen_get = True
            elif isinstance(op, Put):
                out.append(("put",))
            else:
                out.append(("compute",))
        return tuple(out)

    @property
    def io_kinds(self) -> tuple[str, ...]:
        """The declared storage-call sequence, compute elided — what
        the runtime's contract cursor steps through and what
        `analysis.infer` matches a handler's recovered calls against."""
        return tuple("get" if isinstance(op, Get) else "put"
                     for op in self.ops
                     if not isinstance(op, ComputeSegment))

    def effective(self, input_hints) -> "IOProfile":
        """The profile this *invocation* actually runs: a declared-
        prefetchable GET whose event hint is missing or size-opaque
        falls back to guest-issued (§4.2.3)."""
        ops, gi = [], 0
        for op in self.ops:
            if isinstance(op, Get):
                hint = input_hints[gi] if gi < len(input_hints) else None
                ops.append(replace(op, prefetchable=(
                    op.prefetchable and hint is not None
                    and hint.prefetchable)))
                gi += 1
            else:
                ops.append(op)
        return IOProfile(tuple(ops))

    # --------------------------------------------------------- constructors

    @classmethod
    def single(cls, in_mb: float, out_mb: float,
               mcycles: float) -> "IOProfile":
        """The classic FaaS shape: one GET, one compute, one PUT."""
        return cls((Get(int(in_mb * MB)), ComputeSegment(mcycles),
                    Put(int(out_mb * MB))))


# ---------------------------------------------------------------- workloads

@dataclass(frozen=True)
class Workload:
    name: str
    profile: IOProfile
    extra_libs_mb: float         # resident libs beyond the base runtime
    handler: Callable[[dict, Any], Any]
    # deterministic input hint available at ingress (paper: 96% of fns)
    deterministic_input: bool = True

    @property
    def input_mb(self) -> float:
        return sum(g.size_bytes for g in self.profile.gets) / MB

    @property
    def output_mb(self) -> float:
        return sum(p.size_bytes for p in self.profile.puts) / MB

    @property
    def compute_mcycles(self) -> float:
        return sum(s.mcycles for s in self.profile.segments)

    @property
    def io_mb(self) -> float:
        return self.input_mb + self.output_mb

    @property
    def input_bytes(self) -> int:
        """Nominal total GET size — what every cost model charges for."""
        return sum(g.size_bytes for g in self.profile.gets)

    @property
    def output_bytes(self) -> int:
        return sum(p.size_bytes for p in self.profile.puts)


# ------------------------------------------------------------ MLServe suite
#
# Calibrated ML-inference workloads: the model stack wired
# into the serverless core. Profiles are pure data read from the
# committed `core/calibrate.calibration.json` — GET/PUT byte sizes are
# exact serialized tensor sizes, `ComputeSegment` budgets are
# machine-profile rooflines over the analytic per-model FLOPs/HBM
# bytes ("calibrated, not hand-picked"). Two scales share one shape
# (and therefore one compiled PhasePlan per scenario):
#
# * ``full`` — published configs on an 8-device HBM slice (weights
#   shards are hundreds of MB — the prefetch-during-restore story of
#   the paper's motivation);
# * ``tiny`` — SMOKE configs; the handlers below EXECUTE at this scale
#   under the threaded runtime: real params/KV tensors round-tripped
#   through ``ctx.storage``, durable outputs diffed byte-for-byte
#   across every system variant.
#
# The handlers keep one code object across scales: each core finds its
# scale from the payload's length (`repro_torch.models.serving`), so
# the same handler also runs the published config on one device, fed
# that config's whole payloads. Handlers import the model stack lazily:
# building the suite needs no torch. Kept out of REGISTRY, as the
# reference keeps them.

def _ml_llm_cold_handler(event, ctx):
    """Cold LLM start: fan in the weight shards, prefill the prompt,
    one decode step; durable output = the step's logits."""
    from repro_torch.models import serving
    bodies = [ctx.storage.get_object(Bucket=s["bucket"], Key=s["key"])["Body"]
              for s in event["inputs"]]
    out = serving.llm_cold(bodies[:-1], bodies[-1], device=ctx.device)
    dst = event["outputs"][0]
    ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"], Body=out)
    return {"statusCode": 200, "bytes_out": len(out)}


def _ml_llm_prefill_handler(event, ctx):
    """Prefill tier: durable output = the serialized KV cache."""
    from repro_torch.models import serving
    p, t = event["inputs"]
    params = ctx.storage.get_object(Bucket=p["bucket"], Key=p["key"])
    prompt = ctx.storage.get_object(Bucket=t["bucket"], Key=t["key"])
    kv = serving.llm_prefill(params["Body"], prompt["Body"],
                             device=ctx.device)
    dst = event["outputs"][0]
    ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"], Body=kv)
    return {"statusCode": 200, "kv_bytes": len(kv)}


def _ml_llm_decode_handler(event, ctx):
    """One decode step: GET (cache, token), advance, PUT the updated
    cache (async writeback floats it); the token rides the response."""
    from repro_torch.models import serving
    p, s = event["inputs"]
    params = ctx.storage.get_object(Bucket=p["bucket"], Key=p["key"])
    state = ctx.storage.get_object(Bucket=s["bucket"], Key=s["key"])
    kv2, token = serving.llm_decode(params["Body"], state["Body"],
                                    device=ctx.device)
    dst = event["outputs"][0]
    ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"], Body=kv2)
    return {"statusCode": 200, "token": token}


def _ml_emb_handler(event, ctx):
    """Batch encode: durable output = the embedding block."""
    from repro_torch.models import serving
    p, t = event["inputs"]
    params = ctx.storage.get_object(Bucket=p["bucket"], Key=p["key"])
    tokens = ctx.storage.get_object(Bucket=t["bucket"], Key=t["key"])
    out = serving.emb_encode(params["Body"], tokens["Body"],
                             device=ctx.device)
    dst = event["outputs"][0]
    ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"], Body=out)
    return {"statusCode": 200, "bytes_out": len(out)}


def _ml_moe_handler(event, ctx):
    """Expert-shard fan-in: reassemble router + top-k expert weights
    from the fetched shards, run the fixed batch."""
    from repro_torch.models import serving
    bodies = [ctx.storage.get_object(Bucket=s["bucket"], Key=s["key"])["Body"]
              for s in event["inputs"]]
    out = serving.moe_infer(bodies, device=ctx.device)
    dst = event["outputs"][0]
    ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"], Body=out)
    return {"statusCode": 200, "bytes_out": len(out)}


#: resident serving-stack libs beyond the base runtime, per scale (MB)
_ML_LIBS = {"full": {"llm": 300.0, "moe": 320.0, "emb": 220.0},
            "tiny": {"llm": 42.0, "moe": 46.0, "emb": 38.0}}

ML_SCENARIO_NAMES = ("LLM-COLD", "LLM-PREFILL", "LLM-DECODE", "EMB", "MOE")


def ml_suite(scale: str = "full") -> dict[str, Workload]:
    """The calibrated MLServe scenarios at one scale.

    Pure data: profiles come from the committed calibration database
    (`repro_torch.core.calibrate`), so building the suite needs no
    torch. The handlers are real model code, run by the threaded
    runtime over real tensors.
    """
    from repro_torch.core.calibrate import load_calibration, model_entry
    if scale not in _ML_LIBS:
        raise ValueError(f"unknown ml_suite scale {scale!r}; "
                         f"known: {sorted(_ML_LIBS)}")
    cal = load_calibration()
    llm = model_entry(scale, "llm", cal)
    moe = model_entry(scale, "moe", cal)
    emb = model_entry(scale, "emb", cal)
    libs = _ML_LIBS[scale]

    def mcyc(entry: dict, phase: str) -> float:
        return entry["phases"][phase]["mcycles"]

    return {w.name: w for w in (
        # cold start: weight-shard fan-in (first shard hint-prefetched
        # at ingress -> overlaps the snapshot restore), prompt, prefill
        # + one decode step, logits out.
        Workload("LLM-COLD", IOProfile((
            *[Get(s, key=f"shard{j}", shared=True)
              for j, s in enumerate(llm["weights_shard_bytes"])],
            Get(llm["prompt_bytes"], key="prompt"),
            ComputeSegment(mcyc(llm, "prefill") + mcyc(llm, "decode")),
            Put(llm["cold_out_bytes"]))), libs["llm"],
            _ml_llm_cold_handler),
        # prefill tier: params + prompt in, KV cache out (the durable
        # handoff object a decode tier consumes).
        Workload("LLM-PREFILL", IOProfile((
            Get(llm["params_bytes"], key="params", shared=True),
            Get(llm["prompt_bytes"], key="prompt"),
            ComputeSegment(mcyc(llm, "prefill")),
            Put(llm["kv_prefill_bytes"]))), libs["llm"],
            _ml_llm_prefill_handler),
        # decode tier: per-step KV GET + async KV PUT writeback — the
        # paper's state-heavy-function case. The params and KV GETs are
        # stable logical keys: after the first step on a node the whole
        # chain is served from the SharedCache.
        Workload("LLM-DECODE", IOProfile((
            Get(llm["params_bytes"], key="params", shared=True),
            Get(llm["kv_in_bytes"], key="kv"),
            ComputeSegment(mcyc(llm, "decode")),
            Put(llm["kv_out_bytes"], key="kv"))), libs["llm"],
            _ml_llm_decode_handler),
        # batch encoder: params + token batch in, embedding block out.
        Workload("EMB", IOProfile((
            Get(emb["params_bytes"], key="params", shared=True),
            Get(emb["enc_tokens_bytes"], key="tokens"),
            ComputeSegment(mcyc(emb, "encode")),
            Put(emb["emb_bytes"]))), libs["emb"],
            _ml_emb_handler),
        # MoE: expert-shard fan-in (backbone + expert shards), one
        # routed batch, logits out.
        Workload("MOE", IOProfile((
            *[Get(s, key=f"shard{j}", shared=True)
              for j, s in enumerate(moe["weights_shard_bytes"])],
            ComputeSegment(mcyc(moe, "prefill")),
            Put(moe["moe_out_bytes"]))), libs["moe"],
            _ml_moe_handler),
    )}


#: everything deployable by name: the paper suite and the multi-I/O
#: scenarios, which the port has not copied yet.
REGISTRY: dict[str, Workload] = {}
