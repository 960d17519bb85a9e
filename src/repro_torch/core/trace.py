"""Azure-Functions-like arrival trace generation (paper §6, In-Vitro).

The paper replays sampled Azure Function traces. We generate
statistically similar arrivals: per-function mean rates drawn from a
heavy-tailed (lognormal) popularity distribution, arrivals within a
function drawn from a Markov-modulated Poisson process (bursty/idle
phases) — the defining features of production serverless traffic.
Everything is seeded and deterministic.

A copy of ``repro.core.trace``, whole. Every constant keeps the
reference's value.
"""
from __future__ import annotations

import math
import random
import zlib
from dataclasses import dataclass


def _fn_seed(seed: int, function: str) -> int:
    """Stable per-(seed, function) RNG seed. crc32, not `hash()`: str
    hashing is salted per process, which silently broke cross-process
    determinism of every arrival stream."""
    return (seed * 1_000_003) ^ zlib.crc32(function.encode())


@dataclass(frozen=True)
class ArrivalSpec:
    function: str
    mean_rate: float            # invocations / second


def sample_rates(functions: list[str], seed: int, *,
                 mean_rate: float = 1.0, sigma: float = 0.6) -> list[ArrivalSpec]:
    """Lognormal per-function rates normalized to `mean_rate` average."""
    rng = random.Random(seed)
    raw = [rng.lognormvariate(0.0, sigma) for _ in functions]
    norm = mean_rate * len(raw) / sum(raw)
    return [ArrivalSpec(f, r * norm) for f, r in zip(functions, raw)]


def generate_arrivals(spec: ArrivalSpec, duration_s: float, seed: int,
                      *, burst_factor: float = 3.0,
                      burst_fraction: float = 0.25,
                      pattern=None) -> list[float]:
    """Seeded arrival stream in [0, duration) for one function.

    With no `pattern`, Markov-modulated Poisson arrivals (two phases:
    'calm' at rate r_c and 'burst' at r_b = burst_factor * r_c, with
    mean dwell times chosen so `burst_fraction` of time is bursty and
    the long-run rate equals spec.mean_rate). A
    `workloads.ArrivalPattern` selects poisson / mmpp / diurnal
    generation instead; everything remains deterministic in
    (seed, function).
    """
    rng = random.Random(_fn_seed(seed, spec.function))
    r_mean = spec.mean_rate
    if r_mean <= 0:
        return []
    if pattern is not None:
        if pattern.kind == "poisson":
            return _poisson_arrivals(rng, r_mean, duration_s)
        if pattern.kind == "diurnal":
            return _diurnal_arrivals(rng, r_mean, duration_s,
                                     pattern.period_s, pattern.amplitude)
        burst_factor = pattern.burst_factor
        burst_fraction = pattern.burst_fraction
    # long-run rate = (1-f)*r_c + f*r_b = r_c * (1 - f + f*B)
    r_calm = r_mean / (1 - burst_fraction + burst_fraction * burst_factor)
    r_burst = r_calm * burst_factor
    dwell_calm = 20.0           # seconds, mean
    dwell_burst = dwell_calm * burst_fraction / (1 - burst_fraction)

    out: list[float] = []
    t = 0.0
    bursty = False
    phase_end = rng.expovariate(1.0 / dwell_calm)
    while t < duration_s:
        rate = r_burst if bursty else r_calm
        dt = rng.expovariate(rate) if rate > 0 else float("inf")
        if t + dt >= phase_end:
            t = phase_end
            bursty = not bursty
            phase_end = t + rng.expovariate(
                1.0 / (dwell_burst if bursty else dwell_calm))
            continue
        t += dt
        if t < duration_s:
            out.append(t)
    return out


def _poisson_arrivals(rng: random.Random, rate: float,
                      duration_s: float) -> list[float]:
    """Homogeneous Poisson process at `rate`."""
    out: list[float] = []
    t = rng.expovariate(rate)
    while t < duration_s:
        out.append(t)
        t += rng.expovariate(rate)
    return out


def _diurnal_arrivals(rng: random.Random, mean_rate: float,
                      duration_s: float, period_s: float,
                      amplitude: float) -> list[float]:
    """Inhomogeneous Poisson with rate(t) = mean * (1 + A sin(wt + phi)),
    sampled by thinning against the peak rate. `phi` is drawn per
    function so a cluster of functions peaks staggered, not in phase.
    """
    phi = rng.uniform(0.0, 2.0 * math.pi)
    r_max = mean_rate * (1.0 + amplitude)
    w = 2.0 * math.pi / period_s
    out: list[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(r_max)
        if t >= duration_s:
            return out
        accept = (1.0 + amplitude * math.sin(w * t + phi)) / (1.0 + amplitude)
        if rng.random() < accept:
            out.append(t)


def merge_streams(arrivals: dict[str, list[float]]
                  ) -> list[tuple[float, str]]:
    """Merge per-function arrival lists into one time-sorted stream.

    Equivalent to concatenating ``(t, fn)`` pairs in dict order and
    stable-sorting on time — exact-time ties across functions keep
    dict-insertion order, which is the tie rule every engine's arrival
    feed depends on.  The sort runs as a numpy stable argsort over one
    flat float64 vector; ``.tolist()`` converts back at the boundary so
    callers keep pure Python floats (np.float64 scalars would poison
    downstream arithmetic performance).  The degenerate shapes — no
    streams, all-empty streams, exactly one non-empty stream — never
    reach numpy: a single list is already time-sorted and maps straight
    through, keeping the caller's float objects untouched instead of
    round-tripping them through a float64 array.
    """
    names: list[str] = []
    lists: list[list[float]] = []
    total = 0
    for fn, times in arrivals.items():
        if times:
            names.append(fn)
            lists.append(times)
            total += len(times)
    if not total:
        return []
    if len(lists) == 1:                   # single stream: already sorted
        fn = names[0]
        return [(t, fn) for t in lists[0]]
    import numpy as np
    flat = np.empty(total, dtype=np.float64)
    owner = np.empty(total, dtype=np.intp)
    off = 0
    for i, times in enumerate(lists):
        end = off + len(times)
        flat[off:end] = times
        owner[off:end] = i
        off = end
    order = np.argsort(flat, kind="stable")
    ts = flat[order].tolist()
    fns = owner[order].tolist()
    return [(t, names[i]) for t, i in zip(ts, fns)]


def offered_load(arrivals: dict[str, list[float]],
                 duration_s: float) -> float:
    """Total offered load (invocations/s) of a per-function arrival map
    over ``[0, duration_s)`` — the x-axis of the overload sweeps."""
    if duration_s <= 0.0:
        return 0.0
    return sum(len(v) for v in arrivals.values()) / duration_s


def interarrival_cv(arrivals: list[float]) -> float:
    """Coefficient of variation of inter-arrivals (burstiness check)."""
    if len(arrivals) < 3:
        return float("nan")
    gaps = [b - a for a, b in zip(arrivals, arrivals[1:])]
    mu = sum(gaps) / len(gaps)
    var = sum((g - mu) ** 2 for g in gaps) / len(gaps)
    return math.sqrt(var) / mu if mu else float("nan")
