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

`SUITE` holds the paper's ten functions (most I/O-intensive to most
compute-intensive, compute-to-I/O ratios ~10%..90%); `SCENARIOS` adds
multi-I/O shapes the old one-GET-one-PUT runtime could not represent:
scatter-gather fan-in (`SG`), a two-stage pipeline (`PIPE`), and a
fan-out writer (`FAN`). `REGISTRY` is both.

A copy of ``repro.core.workloads``, whole. The MLServe handlers mirror
the reference's storage call for storage call; each also hands the core
the device the node runs on (``ctx.device``).
"""
from __future__ import annotations

import hashlib
import zlib
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


# ---------------------------------------------------------- arrival patterns

@dataclass(frozen=True)
class ArrivalPattern:
    """How invocations of a deployed function arrive (paper §6: the
    density experiment replays Azure-like traffic; the full sweep also
    stresses the variants under heavier burst regimes and slow diurnal
    load swings).

    Pure data, like `SystemSpec`: the generator in `core.trace`
    interprets it, every stream is seeded and process-deterministic.

    * ``poisson`` — homogeneous Poisson (the classic open-loop model);
    * ``mmpp``    — Markov-modulated Poisson (calm/burst phases;
      ``burst_factor`` × rate for ``burst_fraction`` of the time);
    * ``diurnal`` — inhomogeneous Poisson with a sinusoidal rate swing
      of relative ``amplitude`` over ``period_s`` (phase-shifted per
      function so the cluster sees staggered peaks).
    """

    name: str
    kind: str = "mmpp"              # 'poisson' | 'mmpp' | 'diurnal'
    burst_factor: float = 3.0
    burst_fraction: float = 0.25
    period_s: float = 120.0         # diurnal period
    amplitude: float = 0.8          # diurnal peak-to-mean rate swing

    def __post_init__(self):
        if self.kind not in ("poisson", "mmpp", "diurnal"):
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")
        if self.burst_factor <= 0.0:
            raise ValueError("burst_factor must be > 0")
        if not 0.0 <= self.burst_fraction < 1.0:
            raise ValueError("burst_fraction must be in [0, 1)")
        if self.period_s <= 0.0:
            raise ValueError("period_s must be > 0")


#: named patterns the density sweep iterates over. `azure` is the
#: historical default (MMPP with the paper-calibrated burst mix).
ARRIVAL_PATTERNS: dict[str, ArrivalPattern] = {p.name: p for p in (
    ArrivalPattern("azure"),
    ArrivalPattern("poisson", kind="poisson"),
    ArrivalPattern("bursty", kind="mmpp",
                   burst_factor=8.0, burst_fraction=0.1),
    ArrivalPattern("diurnal", kind="diurnal"),
)}


def resolve_pattern(pattern: "str | ArrivalPattern") -> ArrivalPattern:
    if isinstance(pattern, ArrivalPattern):
        return pattern
    try:
        return ARRIVAL_PATTERNS[pattern]
    except KeyError:
        raise KeyError(f"unknown arrival pattern {pattern!r}; "
                       f"known: {sorted(ARRIVAL_PATTERNS)}") from None


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


# ----------------------------------------------------------- handler bodies
#
# Real functions over real (zero-copy) payload views, scaled so wall
# time stays in the low milliseconds. Deterministic in their inputs:
# the transparency test diffs their durable outputs byte-for-byte
# across every system variant.

def _expand(digest: bytes, out_mb: float) -> bytes:
    block = (digest * (32 * 1024 // len(digest) + 1))[:32 * 1024]
    return block * max(int(out_mb * MB) // len(block), 1)


def _digest_n(view, out_mb: float, rounds: int = 1) -> bytes:
    """Hash the payload `rounds` times, expand digest to out_mb bytes."""
    h = hashlib.sha256()
    for _ in range(rounds):
        h.update(view)
    return _expand(h.digest(), out_mb)


def _crc_reduce(view, out_mb: float) -> bytes:
    crc = zlib.crc32(view) & 0xFFFFFFFF
    return _expand(crc.to_bytes(4, "little"), out_mb)


def _single_io_handler(transform):
    """The ten paper functions share the classic one-GET-one-PUT body;
    only the pure `transform` differs. One code object per workload,
    zero platform knowledge: all I/O goes through ``ctx.storage``."""
    def handler(event, ctx):
        src, dst = event["inputs"][0], event["outputs"][0]
        obj = ctx.storage.get_object(Bucket=src["bucket"], Key=src["key"])
        body = transform(obj["Body"])
        ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"],
                               Body=body)
        return {"statusCode": 200, "bytes_out": len(body)}
    return handler


def _sg_handler(event, ctx):
    """Scatter-gather fan-in: reduce N input shards to one summary."""
    h = hashlib.sha256()
    for src in event["inputs"]:
        part = ctx.storage.get_object(Bucket=src["bucket"], Key=src["key"])
        h.update(part["Body"])
    dst = event["outputs"][0]
    out = _expand(h.digest(), 2.0)
    ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"], Body=out)
    return {"statusCode": 200, "shards": len(event["inputs"])}


def _pipe_handler(event, ctx):
    """Two-stage pipeline: get -> stage-1 -> put -> stage-2 -> put."""
    src = event["inputs"][0]
    obj = ctx.storage.get_object(Bucket=src["bucket"], Key=src["key"])
    stage1 = _digest_n(obj["Body"], 2.0)
    d0 = event["outputs"][0]
    ctx.storage.put_object(Bucket=d0["bucket"], Key=d0["key"], Body=stage1)
    stage2 = _digest_n(memoryview(stage1), 1.0, rounds=2)
    d1 = event["outputs"][1]
    ctx.storage.put_object(Bucket=d1["bucket"], Key=d1["key"], Body=stage2)
    return {"statusCode": 200, "stages": 2}


def _fan_handler(event, ctx):
    """Fan-out writer: one GET, three derived durable outputs."""
    src = event["inputs"][0]
    obj = ctx.storage.get_object(Bucket=src["bucket"], Key=src["key"])
    seed = hashlib.sha256(obj["Body"]).digest()
    for i, dst in enumerate(event["outputs"]):
        branch = hashlib.sha256(seed + i.to_bytes(2, "little")).digest()
        ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"],
                               Body=_expand(branch, 1.5))
    return {"statusCode": 200, "outputs": len(event["outputs"])}


def _wl(name, input_mb, output_mb, compute, libs, out_fn=None, **kw):
    fn = out_fn or (lambda v, o=output_mb: _digest_n(v, o))
    return Workload(name, IOProfile.single(input_mb, output_mb, compute),
                    libs, _single_io_handler(fn), **kw)


# Compute budgets in Mcycles; at 2.1 GHz, 100 Mcycles ~= 48 ms.
# I/O share decreases top to bottom (paper order: ST-R most I/O-heavy).
SUITE: dict[str, Workload] = {w.name: w for w in [
    # name      in_MB out_MB compute libs
    _wl("ST-R", 18.0, 6.0, 14.0, 55.0,
        out_fn=lambda v: _crc_reduce(v, 6.0)),          # stacking reducer
    _wl("LR-S", 9.0, 0.3, 11.0, 68.0),                  # sklearn-ish infer
    _wl("AES", 4.0, 4.0, 36.0, 28.0,
        out_fn=lambda v: _digest_n(v, 4.0, rounds=2)),  # encryption
    _wl("WEB", 1.2, 0.4, 30.0, 36.0),                   # templated web
    _wl("ST-T", 12.0, 4.0, 95.0, 55.0),                 # stacking trainer
    _wl("RNN", 0.8, 0.2, 82.0, 78.0),                   # RNN serving (torch)
    _wl("MAP", 3.0, 3.0, 88.0, 32.0),                    # JSON map
    _wl("RED", 3.0, 1.0, 92.0, 32.0),                    # JSON reduce
    _wl("CNN", 1.5, 0.1, 210.0, 82.0),                  # CNN serving (torch)
    _wl("IR", 2.5, 1.8, 185.0, 59.0),                   # image resize
]}

NAMES = list(SUITE)

#: multi-I/O shapes: unrepresentable under the old fixed
#: one-GET-one-PUT plan, now just data. Kept out of `SUITE` so the
#: paper's ten-function mix (Figs 2-13 denominators) stays untouched.
SCENARIOS: dict[str, Workload] = {w.name: w for w in [
    # scatter-gather fan-in: 4 GETs (only the first is hint-prefetched
    # at ingress; the rest are guest-issued), one reduced output.
    Workload("SG", IOProfile((
        Get(3 * MB), Get(3 * MB), Get(3 * MB), Get(3 * MB),
        ComputeSegment(60.0), Put(2 * MB))), 50.0, _sg_handler),
    # two-stage chain: the first PUT overlaps stage-2 compute under
    # async writeback; the response still gates on both acks.
    Workload("PIPE", IOProfile((
        Get(6 * MB), ComputeSegment(30.0), Put(2 * MB),
        ComputeSegment(40.0), Put(1 * MB))), 55.0, _pipe_handler),
    # fan-out: one GET, three durable outputs, release after compute.
    Workload("FAN", IOProfile((
        Get(5 * MB), ComputeSegment(45.0),
        Put(int(1.5 * MB)), Put(int(1.5 * MB)), Put(int(1.5 * MB)))),
        52.5, _fan_handler),
]}

SCENARIO_NAMES = list(SCENARIOS)

#: everything deployable: the paper suite + the multi-I/O scenarios.
REGISTRY: dict[str, Workload] = {**SUITE, **SCENARIOS}


# ----------------------------------------------------------- chaos suite
#
# Tiny-payload workloads for the FaultPlane chaos harness and the
# fault-tolerance benchmark: threaded invocations complete in
# milliseconds (the differential harness replays whole fault schedules
# in real time), and the fan-out shape exercises per-logical-write PUT
# idempotency under retries. Deliberately NOT in REGISTRY: the paper
# suite's denominators and the DES parity goldens must not move.

_CH_OUT = 64 * 1024


def _fit(digest: bytes, nbytes: int) -> bytes:
    return (digest * (nbytes // len(digest) + 1))[:nbytes]


def _chaos_handler(event, ctx):
    src, dst = event["inputs"][0], event["outputs"][0]
    obj = ctx.storage.get_object(Bucket=src["bucket"], Key=src["key"])
    body = _fit(hashlib.sha256(obj["Body"]).digest(), _CH_OUT)
    ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"], Body=body)
    return {"statusCode": 200, "bytes_out": len(body)}


def _chaos_fan_handler(event, ctx):
    src = event["inputs"][0]
    obj = ctx.storage.get_object(Bucket=src["bucket"], Key=src["key"])
    seed = hashlib.sha256(obj["Body"]).digest()
    for i, dst in enumerate(event["outputs"]):
        branch = hashlib.sha256(seed + i.to_bytes(2, "little")).digest()
        ctx.storage.put_object(Bucket=dst["bucket"], Key=dst["key"],
                               Body=_fit(branch, _CH_OUT // 2))
    return {"statusCode": 200, "outputs": len(event["outputs"])}


def chaos_suite() -> dict[str, Workload]:
    """The chaos harness's deployment mix: `CH` (the classic shape) and
    `CH-FAN` (one GET, two durable PUTs — distinct logical keys whose
    at-least-once retries must dedup per key, never cross keys)."""
    return {w.name: w for w in (
        Workload("CH", IOProfile((
            Get(96 * 1024), ComputeSegment(2.0), Put(_CH_OUT))),
            8.0, _chaos_handler),
        Workload("CH-FAN", IOProfile((
            Get(96 * 1024), ComputeSegment(1.0),
            Put(_CH_OUT // 2), Put(_CH_OUT // 2))),
            8.0, _chaos_fan_handler),
    )}


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


def compute_io_ratio(w: Workload, io_mcycles_per_mb: float = 12.0) -> float:
    """Approximate compute share of (compute + baseline-I/O) cycles."""
    io = w.io_mb * io_mcycles_per_mb
    return w.compute_mcycles / (w.compute_mcycles + io)


#: a balanced deployment mix (paper: each function contributes equally
#: to CPU utilization -> weight inversely to per-invocation cost).
def balanced_mix() -> list[str]:
    return list(NAMES)
