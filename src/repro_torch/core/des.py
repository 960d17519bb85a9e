"""Deployment-density discrete-event simulator (paper §7.1, Fig 6).

The end-to-end density experiment needs hundreds of deployed functions
served for minutes — far beyond what real threads can replay in-process,
so (exactly like the warm/cold microbenchmarks feed the paper's Fig 7/12)
this simulator executes the *same cost model* in virtual time over a
cluster of worker nodes. Structure comes from exactly one place: the
`plan.PhasePlan` compiled from the system variant and each workload's
declared `IOProfile` — lowered once per (variant, shape, coldness) into
a flat `plan.PlanProgram` whose phases are integer indices:

* ``on_core[i]`` phases occupy one of the node's FIFO cores (guest vCPU
  and backend work contend equally); backend-group heads additionally
  hold a slot of the shared daemon's finite connection pool until the
  program's ``releases_slot`` point (per the transport's kernel-bypass
  rule);
* everything else is pure virtual latency;

and the program's release/response barrier indices fire where the plan
put them. Per-invocation state is a preallocated indegree-countdown
vector plus a memoized per-(function, coldness) duration vector — no
closure graphs, no name hashing, no O(V) successor scans. The threaded
runtime drives its walker off the identical lowered program, so variant
behaviour cannot drift between the two executors; per-phase durations
come from `plan.duration_vector` — the same calibration.

Four engines share this machinery, every one pinned bit-for-bit to the
same latency streams by `tests/goldens/des_parity.json`:

* ``"legacy"``   — the pre-refactor PhasePlan-walking interpreter,
  preserved verbatim as the parity reference;
* ``"classic"``  — the fused PlanProgram loop (`_run_hot`) without
  cohort compression (historical alias: ``"program"``);
* ``"hot"``      — the default: classic plus *compressed cohorts* —
  an invocation whose node has free capacity replays its whole DAG as
  compiled straight-line arithmetic (`_form_compressed`) and collapses
  to 1–2 barrier heap events; a failed scalar grant `_materialize`s
  the node's oldest compressed runs back to event-driven execution at
  the identical floats, so contention never changes a result;
* ``"calendar"`` — hot-engine semantics driven through the `EventLoop`
  with a `CalendarQueue` (bucketed O(1)-amortized scheduling) in place
  of the binary heap.

`benchmarks/sim_throughput.py` records the engine matrix and the
deterministic event-economy counters; `find_density(fast=True)` adds a
fluid-model bracket (`repro_torch.core.fluid`) so density search spends ~5x
fewer exact probes without changing its answer.

SLO (paper): p99 latency < 5x the function's unloaded median; density =
max deployed functions whose geometric-mean slowdown meets the SLO.

A copy of ``repro.core.des``, whole: all four engines, the bundle
cache (one per process, apart from the reference's), `cache_overlay`
and `find_density`. Every constant keeps the reference's value. It
imports nothing of ``torch``: its costs are `plan.duration_vector` and
the copied ``calibration.json``.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from heapq import heappop, heappush
from time import perf_counter as _perf_counter

from repro_torch.core import fabric as F
from repro_torch.core import faults as FA
from repro_torch.core import guardrails as GR
from repro_torch.core import metrics as M
from repro_torch.core import plan as P
from repro_torch.core import workloads as W
from repro_torch.core.cache import CacheSpec, CacheState
from repro_torch.core.plan import (SYSTEMS, PlanProgram, SystemSpec, compile_plan,
                             compile_program)
from repro_torch.core.trace import (generate_arrivals, merge_streams,
                              sample_rates)
from repro_torch.core.transport import TRANSPORTS

_INF = math.inf


# ----------------------------------------------------------- calendar queue

class CalendarQueue:
    """Brown-style calendar queue over full ``(t, seq, ...)`` records.

    The scheduler behind ``engine="calendar"``: timed events hash into
    fixed-width time buckets (small heaps) and the next event is found
    by scanning forward from the current virtual day — O(1) amortized
    when event times are spread over the calendar, vs the binary heap's
    O(log n). The *monotone bulk* of events already bypasses the heap
    (arrival feed, keep-alive timer deque); the calendar replaces the
    heap for the residual — phase completions, crashes, samples.

    Exactness guarantees (what the parity goldens pin):

    * records carry the loop's shared seq counter, and every comparison
      is a full-record tuple comparison, so the (t, seq) total order —
      and therefore tie-breaking — is *identical* to the heap's;
    * the head record is extracted eagerly: ``peek`` is O(1) field
      access and a push that undercuts the head swaps into it, so the
      event loop's next-event probe costs the same as ``q[0]``;
    * a record's virtual day is computed once, with the same arithmetic
      the scan uses (``int(t * inv_width)``), so float rounding at
      bucket boundaries cannot strand an event: push and scan always
      agree on which day a record belongs to.
    """

    __slots__ = ("_buckets", "_nb", "_mask", "_width", "_inv_width",
                 "_count", "_head")

    def __init__(self, width: float = 0.002, nbuckets: int = 1024):
        # power-of-two bucket count: day -> bucket is a mask, not a mod
        nb = 1
        while nb < nbuckets:
            nb <<= 1
        self._nb = nb
        self._mask = nb - 1
        self._width = width
        self._inv_width = 1.0 / width
        self._buckets: list[list] = [[] for _ in range(nb)]
        self._count = 0
        self._head = None           # eagerly-extracted minimum record

    def __len__(self) -> int:
        return self._count + (self._head is not None)

    def push(self, rec) -> None:
        h = self._head
        if h is None:
            self._head = rec
            return
        if rec < h:                 # undercuts the head: swap in
            self._head = rec
            rec = h
        heappush(self._buckets[int(rec[0] * self._inv_width) & self._mask],
                 rec)
        self._count += 1
        if self._count > 8 * self._nb:
            self._resize(self._nb * 2)

    def peek(self):
        return self._head

    def pop(self):
        rec = self._head
        self._head = self._extract() if self._count else None
        return rec

    def _extract(self):
        """Remove and return the smallest bucketed record. Scans one
        calendar year from the head's day, taking the first bucket head
        still inside its own day of the scan; records further out wait
        for a later year (classic calendar-queue discipline). Falls
        back to a direct min scan when a whole year is empty."""
        day0 = int(self._head[0] * self._inv_width)
        buckets = self._buckets
        mask = self._mask
        inv_w = self._inv_width
        for k in range(self._nb):
            b = buckets[(day0 + k) & mask]
            if b and int(b[0][0] * inv_w) <= day0 + k:
                self._count -= 1
                return heappop(b)
        best_b = None
        for b in buckets:           # sparse year: direct min scan
            if b and (best_b is None or b[0] < best_b[0]):
                best_b = b
        self._count -= 1
        return heappop(best_b)

    def _resize(self, nb: int) -> None:
        old = self._buckets
        self._nb = nb
        self._mask = nb - 1
        self._buckets = [[] for _ in range(nb)]
        inv_w = self._inv_width
        mask = self._mask
        for b in old:
            for rec in b:
                heappush(self._buckets[int(rec[0] * inv_w) & mask], rec)


# --------------------------------------------------------------- event loop

class EventLoop:
    """Virtual-time event loop, rebuilt for throughput.

    Three queues, one shared sequence counter so the relative order of
    same-timestamp events is exactly the classic heap-only semantics:

    * a binary heap for timed events — callback records
      ``(t, seq, cb, a, b)`` dispatched as ``cb(a, b)``, or hot records
      ``(t, seq, run, code)`` (distinguished by length) handed to the
      owner's ``hot`` handler;
    * a FIFO for zero-delay events (`defer`): an O(1) deque append
      instead of an O(log n) heap push — a zero-delay event scheduled
      at ``now`` outranks every *later-scheduled* event and yields to
      any same-time heap event with a smaller sequence number, which is
      precisely what pushing it onto the heap would have done;
    * a pre-sorted arrival feed (`feed`): batched arrival scheduling —
      tens of thousands of arrivals never enter the heap at all, so the
      heap stays shallow for everything else;
    * an optional constant-delay timer deque (`timerq`): fire times are
      monotone by construction, so these timers also stay out of the
      heap.
    """

    __slots__ = ("_q", "_pending", "_seq", "now", "_feed", "_feed_cb", "_fi",
                 "hot", "timerq", "timer_cb", "classic", "cal")

    def __init__(self, classic: bool = False):
        self._q: list = []
        self._pending: deque = deque()
        self._seq = 0
        self.now = 0.0
        self._feed: list = []
        self._feed_cb = None
        self._fi = 0
        #: optional CalendarQueue replacing the binary heap for timed
        #: records (``engine="calendar"``) — same records, same shared
        #: seq counter, same (t, seq) total order
        self.cal = None
        #: handler for sentinel records (callback `None`): the owner's
        #: inlined hot path, called as ``hot(a, b)``. Callback records
        #: dispatch ``cb(a, b)`` as usual.
        self.hot = None
        #: optional constant-delay timer deque: records
        #: ``(t, seq, a, b)`` with monotone fire times, dispatched as
        #: ``timer_cb(a, b)`` in global (t, seq) order — the program
        #: engine's keep-alive retirements live here instead of the
        #: heap (both `run` and the fused `_run_hot` drain it)
        self.timerq = None
        self.timer_cb = None
        #: pre-refactor plumbing: zero-delay events go through the heap
        #: like they always did. The legacy engine runs in this mode so
        #: `benchmarks/sim_throughput.py` measures the true pre-refactor
        #: cost, not a baseline quietly sped up by the new loop. Event
        #: order is identical either way (same (t, seq) total order).
        self.classic = classic

    @property
    def events_scheduled(self) -> int:
        """Total events scheduled so far (heap + zero-delay + arrivals
        consumed) — the denominator of the events/sec throughput
        metric, maintained for free by the seq counter."""
        return self._seq + self._fi

    def at(self, t: float, cb, a=None, b=None) -> None:
        self._seq = s = self._seq + 1
        if self.cal is None:
            heappush(self._q, (t, s, cb, a, b))
        else:
            self.cal.push((t, s, cb, a, b))

    def after(self, dt: float, cb, a=None, b=None) -> None:
        if dt <= 0.0:
            self.defer(cb, a, b)
        else:
            self.at(self.now + dt, cb, a, b)

    def defer(self, cb, a=None, b=None) -> None:
        """Schedule at the current instant (after already-queued
        same-time events)."""
        self._seq = s = self._seq + 1
        if self.classic:
            heappush(self._q, (self.now, s, cb, a, b))
        else:
            self._pending.append((s, cb, a, b))

    # ------------------------------------------------- schedule choke points
    #
    # Every hot-record schedule goes through exactly these two helpers
    # (or the fused `_run_hot`, which inlines them and re-syncs the seq
    # counter around any out-of-line call): one place consumes the
    # shared seq counter and picks the queue, so tie-ordering cannot
    # drift between the method paths, the fused loop, and the calendar
    # engine.

    def sched(self, t: float, run, code: int) -> None:
        """Schedule a timed hot record ``(t, seq, run, code)``."""
        self._seq = s = self._seq + 1
        if self.cal is None:
            heappush(self._q, (t, s, run, code))
        else:
            self.cal.push((t, s, run, code))

    def sched0(self, run, code: int) -> None:
        """Schedule a hot record at the current instant (zero-delay
        FIFO: O(1), yet ordered exactly as a same-time heap push)."""
        self._seq = s = self._seq + 1
        self._pending.append((s, run, code))

    def sched_timer(self, t: float, a, b) -> None:
        """Append a constant-delay timer record — fire times are
        monotone by construction, so the deque IS the priority queue."""
        self._seq = s = self._seq + 1
        self.timerq.append((t, s, a, b))

    def feed(self, events: list, cb) -> None:
        """Attach a time-sorted ``[(t, arg), ...]`` stream delivered as
        ``cb(arg, None)`` — arrivals bypass the heap entirely."""
        self._feed = events
        self._feed_cb = cb
        self._fi = 0

    def run(self, until: float) -> None:
        if self.cal is not None:
            self._run_cal(until)
            return
        q = self._q
        pending = self._pending
        hot = self.hot
        timers = self.timerq if self.timerq is not None else ()
        tcb = self.timer_cb
        feed, fcb = self._feed, self._feed_cb
        fi, nf = self._fi, len(self._feed)
        t_f = feed[fi][0] if fi < nf else _INF
        while True:
            if pending:
                if t_f <= self.now:            # exact tie: arrivals were
                    self.now = t_f             # scheduled first -> win
                    arg = feed[fi][1]
                    fi += 1
                    t_f = feed[fi][0] if fi < nf else _INF
                    fcb(arg, None)
                    continue
                # smallest seq among same-time candidates wins
                win = pending[0][0]
                src = 0
                if q and q[0][0] <= self.now and q[0][1] < win:
                    win = q[0][1]
                    src = 1
                if timers and timers[0][0] <= self.now \
                        and timers[0][1] < win:
                    src = 2
                if src == 1:
                    e = heappop(q)
                    self.now = e[0]
                    if len(e) == 4:            # hot record (run, code)
                        hot(e[2], e[3])
                    else:
                        e[2](e[3], e[4])
                    continue
                if src == 2:
                    e = timers.popleft()
                    self.now = e[0]
                    tcb(e[2], e[3])
                    continue
                e = pending.popleft()
                if len(e) == 3:                # hot record
                    hot(e[1], e[2])
                else:
                    e[1](e[2], e[3])
                continue
            t_q = q[0][0] if q else _INF
            t_r = timers[0][0] if timers else _INF
            if t_f <= t_q and t_f <= t_r:      # arrivals win exact ties
                if t_f > until:
                    break
                self.now = t_f
                arg = feed[fi][1]
                fi += 1
                t_f = feed[fi][0] if fi < nf else _INF
                fcb(arg, None)
                continue
            if t_q < t_r or (t_q == t_r and q[0][1] < timers[0][1]):
                if t_q > until:
                    break
                e = heappop(q)
                self.now = e[0]
                if len(e) == 4:                # hot record (run, code)
                    hot(e[2], e[3])
                else:
                    e[2](e[3], e[4])
                continue
            if t_r > until:
                break
            e = timers.popleft()
            self.now = e[0]
            tcb(e[2], e[3])
        self._fi = fi
        self.now = until

    def _run_cal(self, until: float) -> None:
        """`run`, with the binary heap swapped for the calendar queue.
        Event-source arbitration is identical — the calendar's eager
        head makes the next-timed-event probe the same O(1) field read
        as ``q[0]``, and records carry the same shared seq counter."""
        cal = self.cal
        pending = self._pending
        hot = self.hot
        timers = self.timerq if self.timerq is not None else ()
        tcb = self.timer_cb
        feed, fcb = self._feed, self._feed_cb
        fi, nf = self._fi, len(self._feed)
        t_f = feed[fi][0] if fi < nf else _INF
        while True:
            h = cal._head
            if pending:
                if t_f <= self.now:            # exact tie: arrivals were
                    self.now = t_f             # scheduled first -> win
                    arg = feed[fi][1]
                    fi += 1
                    t_f = feed[fi][0] if fi < nf else _INF
                    fcb(arg, None)
                    continue
                # smallest seq among same-time candidates wins
                win = pending[0][0]
                src = 0
                if h is not None and h[0] <= self.now and h[1] < win:
                    win = h[1]
                    src = 1
                if timers and timers[0][0] <= self.now \
                        and timers[0][1] < win:
                    src = 2
                if src == 1:
                    e = cal.pop()
                    self.now = e[0]
                    if len(e) == 4:            # hot record (run, code)
                        hot(e[2], e[3])
                    else:
                        e[2](e[3], e[4])
                    continue
                if src == 2:
                    e = timers.popleft()
                    self.now = e[0]
                    tcb(e[2], e[3])
                    continue
                e = pending.popleft()
                if len(e) == 3:                # hot record
                    hot(e[1], e[2])
                else:
                    e[1](e[2], e[3])
                continue
            t_q = h[0] if h is not None else _INF
            t_r = timers[0][0] if timers else _INF
            if t_f <= t_q and t_f <= t_r:      # arrivals win exact ties
                if t_f > until:
                    break
                self.now = t_f
                arg = feed[fi][1]
                fi += 1
                t_f = feed[fi][0] if fi < nf else _INF
                fcb(arg, None)
                continue
            if t_q < t_r or (t_q == t_r and h[1] < timers[0][1]):
                if t_q > until:
                    break
                e = cal.pop()
                self.now = e[0]
                if len(e) == 4:                # hot record (run, code)
                    hot(e[2], e[3])
                else:
                    e[2](e[3], e[4])
                continue
            if t_r > until:
                break
            e = timers.popleft()
            self.now = e[0]
            tcb(e[2], e[3])
        self._fi = fi
        self.now = until


# --------------------------------------------------------------- resources

class CorePool:
    """FIFO slot scheduler (cores, backend connection pool, ...) — the
    legacy engine's resource model, preserved verbatim (closure per
    hold, per-transition `_account` integrals). The program engine
    bypasses it entirely: its pool state is the `SimNode.cpu_hot` /
    `be_hot` lists plus waiter deques, manipulated inline by the hot
    path with clipped-hold-time accounting.
    """

    __slots__ = ("loop", "cores", "busy", "_wait", "busy_integral", "_last")

    def __init__(self, loop: EventLoop, slots: int):
        self.loop = loop
        self.cores = slots
        self.busy = 0
        self._wait: deque = deque()
        self.busy_integral = 0.0          # slot-seconds consumed
        self._last = 0.0

    def _account(self):
        now = self.loop.now
        self.busy_integral += self.busy * (now - self._last)
        self._last = now

    def acquire(self, granted_cb) -> None:
        self._account()
        if self.busy < self.cores:
            self.busy += 1
            self.loop.defer(granted_cb)
        else:
            self._wait.append(granted_cb)

    def release(self) -> None:
        self._account()
        self.busy -= 1
        if self._wait:
            self.busy += 1
            self.loop.defer(self._wait.popleft())

    def request(self, duration: float, done_cb) -> None:
        def _go(_a=None, _b=None):
            self.loop.after(duration, _done)

        def _done(_a=None, _b=None):
            self.release()
            done_cb()

        self.acquire(_go)

    def utilization(self, horizon: float) -> float:
        return self.busy_integral / (self.cores * horizon) if horizon else 0.0


@dataclass
class SimInstance:
    fn: str
    node: int
    rss_mb: float
    state: str = "warm"               # warm | busy
    expire_seq: int = 0               # keep-alive generation


class SimNode:
    __slots__ = ("cpu", "mem_cap", "mem_used", "mem_peak", "vms", "backend",
                 "cpu_hot", "cpu_wait", "be_hot", "be_wait", "cruns")

    def __init__(self, loop: EventLoop, cores: int, mem_mb: float,
                 backend_base_mb: float, backend_workers: int):
        self.cpu = CorePool(loop, cores)
        self.mem_cap = mem_mb
        self.mem_used = backend_base_mb
        self.mem_peak = self.mem_used
        self.vms = 0
        # the shared backend daemon multiplexes I/O through a finite
        # worker pool — a real contention point at high density (§7.2.1
        # notes host-user cycles rise 71% as work moves into it).
        self.backend = CorePool(loop, backend_workers)
        # program-engine pool state: [busy, slots, busy_integral, node]
        # plus a FIFO of (run, phase) waiters — list indexing beats
        # attribute dispatch at hot-path rates. The trailing node
        # backref lets a failed grant find the node's compressed runs
        # to materialize. The legacy engine keeps the CorePool objects
        # above; one simulator uses exactly one of the two
        # representations.
        self.cpu_hot = [0, cores, 0.0, self]
        self.cpu_wait: deque = deque()
        self.be_hot = [0, backend_workers, 0.0, self]
        self.be_wait: deque = deque()
        #: live cohort-compressed invocations on this node (their core/
        #: slot needs are reserved in the pool counters above; a failed
        #: scalar grant materializes them back to event-driven runs)
        self.cruns: list = []


# --------------------------------------------- program-engine hot records
#
# One in-flight invocation is a flat list (no attribute protocol on the
# hot path); event payloads are (run, phase_index | flags). Slot layout:

_R_NEED = 0        # indegree countdown (preallocated, one copy per run)
_R_DURS = 1        # duration vector, program-index aligned
_R_SUCC = 2        # successor *code* lists (+ virtual root entry)
_R_OPS = 3         # per-phase opcode at ready time (see _OP_*)
_R_OPS2 = 4        # per-phase opcode after its slot grant
_R_CPU = 5         # node cpu_hot [busy, slots, busy_integral]
_R_CPUW = 6        # node cpu waiter FIFO
_R_BE = 7          # node be_hot [busy, slots, busy_integral]
_R_BEW = 8         # node backend waiter FIFO
_R_LATS = 9        # the function's latency list (appended at respond)
_R_INST = 10       # SimInstance
_R_T = 11          # arrival time
_R_OWN = 12        # owning DensitySimulator (shared-loop hot routing)

# Event codes: phase index | static flags. The per-phase *code* is
# precomputed in the template (`base_code`), so barrier and slot-drop
# tests are single bit-tests on the event word instead of array
# lookups; _EXEC/_CORE are the only bits set at runtime.
_PI_MASK = (1 << 20) - 1
_EXEC = 1 << 20    # backend slot already held: run the execute step
_CORE = 1 << 21    # phase finished on a node core: release it first
_SLOTREL = 1 << 22  # phase drops its backend-group slot when done
_RELB = 1 << 23    # release barrier fires when this phase completes
_RESPB = 1 << 24   # respond barrier fires when this phase completes

# attempt stamp (faulted interpreter only): bits above the flag field
# carry the phase's attempt number at schedule time — a crash abort
# bumps the attempt, lazily invalidating every event of the dead try.
_ATT_SHIFT = 25
_CODE_MASK = (1 << _ATT_SHIFT) - 1

# compressed-run event (fault-free hot/calendar engines only, so the
# bit cannot collide with the attempt stamp above): the record slot
# carries a crun list, not a run list, and _RELB/_RESPB say which
# barrier(s) fire. A whole uncontended invocation is 1-2 such events.
_CRUN = 1 << 25

# crun layout: one cohort-compressed invocation. The solo schedule
# (ready/end per phase) is replayed at formation; only the barrier
# events are real. `dead` lazily invalidates the barrier events after
# a materialization converted the run back to event-driven execution.
_C_INST = 0        # SimInstance
_C_T = 1           # arrival time
_C_LATS = 2        # the function's latency list
_C_NODE = 3        # SimNode (reservation release, cruns membership)
_C_WC = 4          # reserved cores
_C_WB = 5          # reserved backend slots
_C_DEAD = 6        # materialized or completed: barrier events are stale
_C_ENDS = 7        # per-phase completion times (solo replay)
_C_READY = 8       # per-phase ready times (= max parent end, or t_arr)
_C_BND = 9         # (prog, tmpl) bundle
_C_RELDONE = 10    # release barrier already fired
_C_OWN = 11        # owning DensitySimulator (shared-loop hot routing)

# phase opcodes: what starting a ready phase does. Folded statically
# per (program, duration vector) — the zero-duration test, the resource
# class, and the group-head test all vanish from the hot path.
_OP_SLOT = 0       # backend-group head: take a slot, then _EXEC
_OP_ZERO = 1       # zero duration: complete via the zero-delay FIFO
_OP_CORE = 2       # timed, on a node core
_OP_WIRE = 3       # timed, pure latency
_OP_CACHE = 4      # timed, pure latency, SharedCache-eligible GET wire
                   # phase: a hit shrinks its duration to the arena
                   # service time (event discipline identical to _WIRE)

# compression template (tmpl[9]): the static inputs of the solo-
# schedule replay, built once per (variant, workload, coldness):
_CT_PRED = 0       # predecessor index tuples (PlanProgram.pred)
_CT_DURS = 1       # duration vector (== tmpl[2])
_CT_CORE = 2       # indices of timed on-core phases (integral/width)
_CT_WC = 3         # max concurrent cores of the solo schedule
_CT_WB = 4         # max concurrent backend slots of the solo schedule
_CT_REL = 5        # release barrier phase index
_CT_RESP = 6       # respond barrier phase index
_CT_N = 7          # phase count
_CT_GROUPS = 8     # (head, slot-release phase) per backend group
_CT_ONCORE = 9     # per-phase: timed and on a core (holds a core slot)
_CT_SOLO = 10      # compiled solo replay: t0 -> (ready, ends, max end)
_CT_CORESUM = 11   # sum of core-phase durations (prepaid busy integral)

# per-function record (one dict hit per arrival instead of five):
_F_IDLE = 0        # warm instances
_F_BACKLOG = 1     # queued arrival times (cluster memory-full)
_F_WARM = 2        # warm (prog, template) bundle, resolved lazily
_F_COLD = 3        # cold bundle, resolved lazily
_F_LATS = 4        # recorded latencies
_F_BASE = 5        # workload name (fn minus the #i suffix)


class _FaultedRun:
    """One in-flight invocation under the FaultPlane interpreter.

    Same information as the hot engine's flat run record plus the
    recovery state a crash abort needs: per-phase attempt counters
    (lazy event invalidation), the in-flight map, held daemon slots,
    and the delivery ledger sets. Shares the node's ``cpu_hot`` /
    ``be_hot`` pool state and waiter FIFOs with every other run.
    """

    __slots__ = ("prog", "durs", "succ", "ops", "ops2", "codes", "intra",
                 "need", "cpu", "cpu_wait", "be", "be_wait", "inst", "fn",
                 "t_arr", "key", "attempt", "inflight", "slots_held",
                 "delivered", "acked", "dead")

    def __init__(self, prog: PlanProgram, tmpl: tuple, node: "SimNode",
                 inst: "SimInstance", fn: str, t_arr: float):
        self.prog = prog
        self.need = list(tmpl[0])
        self.durs = tmpl[2]
        self.succ = tmpl[3]
        self.ops = tmpl[4]
        self.ops2 = tmpl[5]
        self.codes = tmpl[7]
        self.intra = tmpl[8]
        self.cpu = node.cpu_hot
        self.cpu_wait = node.cpu_wait
        self.be = node.be_hot
        self.be_wait = node.be_wait
        self.inst = inst
        self.fn = fn
        self.t_arr = t_arr
        self.key = (fn, t_arr)
        self.attempt = [0] * len(prog.names)
        self.inflight: dict[int, int] = {}
        self.slots_held: set[int] = set()
        self.delivered: set[int] = set()
        self.acked: set[int] = set()
        self.dead = False


# -------------------------------------------------------------- simulator

@dataclass
class SimResult:
    system: str
    n_functions: int
    latencies: dict[str, list[float]]
    unloaded: dict[str, float]
    cpu_util: float
    mem_util: float
    cold_starts: int
    completed: int
    rejected: int
    # FaultPlane outputs (None unless the run had a FaultSchedule):
    # per-kind recovery counters, the retry cycle books, and the
    # chaos-harness delivery ledgers — (fn, t_arr) -> delivered logical
    # PUT ordinals / response count (exactly-once is ledger == plan).
    fault_stats: dict | None = None
    retry_cycles: dict | None = None
    put_ledger: dict | None = None
    responses: dict | None = None
    # GuardRails outputs (None/0 unless the run had a GuardrailPolicy):
    # completions inside their deadline, completions past it, arrivals
    # paced through the admission queue, per-reason shed counts, and
    # the typed-rejection ledger (fn, t_arr) -> reason — the overload
    # chaos harness asserts outcome coverage against `responses`.
    goodput: int = 0
    slo_violations: int = 0
    queued: int = 0
    shed: dict | None = None
    rejections: dict | None = None
    # SharedCache outputs (None unless the run had a CacheSpec): the
    # CacheState counter snapshot — hits/misses/evictions are the
    # cross-executor count-parity contract with the threaded node.
    cache_stats: dict | None = None

    def slowdowns(self) -> dict[str, float]:
        out = {}
        for fn, xs in self.latencies.items():
            if not xs:
                continue
            xs = sorted(xs)
            p99 = xs[min(int(0.99 * len(xs)), len(xs) - 1)]
            out[fn] = p99 / self.unloaded[fn]
        return out

    def geomean_slowdown(self) -> float:
        s = [v for v in self.slowdowns().values() if v > 0]
        if not s:
            return float("inf")
        return math.exp(sum(math.log(v) for v in s) / len(s))

    def meets_slo(self, factor: float = 5.0) -> bool:
        return self.completed > 0 and self.geomean_slowdown() < factor


# ---------------------------------------------------- shared bundle cache

#: process-wide (PlanProgram, template) bundles, keyed on
#: (variant name, Workload, coldness, kernel-bypass) — Workloads are
#: frozen dataclasses, so equal declarations hit the same entry across
#: simulator instances: a density search compiles each template once.
_BUNDLES: dict = {}
_BUNDLE_STATS = {"hits": 0, "misses": 0, "compile_s": 0.0}


def bundle_cache_stats(reset: bool = False) -> dict:
    """Snapshot (optionally reset) the shared template-cache counters:
    hits/misses across every DensitySimulator in the process plus the
    wall-clock seconds spent compiling on misses."""
    out = dict(_BUNDLE_STATS)
    if reset:
        _BUNDLE_STATS.update(hits=0, misses=0, compile_s=0.0)
    return out


def _hold_width(items, anc) -> int:
    """Max simultaneous holds the event engine can observe for one
    run's solo resource intervals. `items` are (start, end,
    start_phase, end_phase); `anc` is a per-phase ancestor bitmask.

    Two holds that merely touch at a boundary count as concurrent
    *unless* the releasing phase is an ancestor of the acquiring one:
    a phase cannot become ready until every ancestor's completion
    event has been processed, and the event engine frees a resource
    before cascading successors, so a dependency-ordered handoff never
    overlaps. Unrelated boundary coincidences keep the conservative
    closed-interval reading — over-reserving only sends an invocation
    down the scalar path, while under-reserving would let a run
    proceed where the event-driven engine could have queued it."""
    best = 0
    for idx, (s, _e, si, _ei) in enumerate(items):
        c = 1                       # the hold starting here
        for jdx, (s2, e2, _sp2, ep2) in enumerate(items):
            if jdx == idx:
                continue
            if s2 <= s and (e2 > s or
                            (e2 == s and not (anc[si] >> ep2) & 1)):
                c += 1
        if c > best:
            best = c
    return best


def _build_bundle(spec: SystemSpec, w: "W.Workload", cold: bool,
                  kernel_bypass: bool):
    """(PlanProgram, run-record template) for one (variant, workload,
    coldness): the program engines' whole structural + cost input.

    The template is the invariant prefix of the flat run record (the
    ``_R_*`` layout): (indegree, virtual_root_idx, durs, succ+,
    on_core, acquires_slot, releases_slot+, release_idx, respond_idx,
    roots). The successor/slot arrays carry one extra *virtual* phase
    whose successors are the roots: an arrival "completes" it, so
    invocation start reuses the hot block's successor machinery
    verbatim. Trailing slots: [7]/[8] FaultPlane lowering, [9] the
    cohort-compression template (``_CT_*`` layout)."""
    prog = compile_program(spec, w.profile, cold=cold,
                           kernel_bypass=kernel_bypass)
    durs = P.duration_vector(spec, w, cold)
    timed = [(_OP_ZERO if d <= 0.0 else
              (_OP_CORE if oc else _OP_WIRE))
             for d, oc in zip(durs, prog.on_core)]
    ops = tuple(_OP_SLOT if acq else t
                for acq, t in zip(prog.acquires_slot, timed))
    code = [i
            | (_SLOTREL if prog.releases_slot[i] else 0)
            | (_RELB if i == prog.release_idx else 0)
            | (_RESPB if i == prog.respond_idx else 0)
            for i in range(len(prog.names))]
    roots = set(prog.roots)
    # FaultPlane extras (trailing slots; the hot path reads only
    # 0..6): the full static code array, and each phase's
    # intra-backend-group indegree — what an aborted group's members
    # reset their countdown to before the re-drive.
    intra = [0] * len(prog.names)
    for i, succs in enumerate(prog.succ):
        gi = prog.bgroup_of[i]
        if gi >= 0:
            for s in succs:
                if prog.bgroup_of[s] == gi:
                    intra[s] += 1
    # ---- cohort-compression template: solo-schedule replay at t0=0
    # gives each phase's ready/end offsets; the core/slot interval
    # overlaps bound the run's concurrent resource use (its
    # reservation). Durations are per-template constants, so the
    # widths are too.
    n = len(durs)
    pred = prog.pred
    ready0 = [0.0] * n
    ends0 = [0.0] * n
    for i in range(n):
        m = 0.0
        for p in pred[i]:
            e = ends0[p]
            if e > m:
                m = e
        ready0[i] = m
        ends0[i] = m + durs[i]
    core_idx = tuple(i for i in range(n) if timed[i] == _OP_CORE)
    groups = tuple(
        (members[0],
         next(m for m in members if prog.releases_slot[m]))
        for members in prog.bgroup_members)
    anc = [0] * n                   # index order is topological
    for i in range(n):
        a = 0
        for p in pred[i]:
            a |= anc[p] | (1 << p)
        anc[i] = a
    w_cpu = _hold_width([(ready0[i], ends0[i], i, i) for i in core_idx],
                        anc)
    w_be = _hold_width([(ready0[h], ends0[r], h, r) for h, r in groups],
                       anc)
    # ---- compiled solo replay: the per-arrival DAG walk unrolled to
    # straight-line code with durations constant-folded (repr() is an
    # exact float round-trip), performing the *same IEEE adds and
    # maxes* as the interpreted loop — bit-parity is preserved while
    # the per-invocation cost drops to one small function call.
    src = ["def _solo(t0):"]
    for i in range(n):
        ps = pred[i]
        if not ps:
            src.append(f"    r{i} = t0")
        else:
            src.append(f"    r{i} = e{ps[0]}")
            for p in ps[1:]:
                src.append(f"    if e{p} > r{i}: r{i} = e{p}")
        src.append(f"    e{i} = r{i} + {durs[i]!r}")
    src.append("    m = e0")
    for i in range(1, n):
        src.append(f"    if e{i} > m: m = e{i}")
    src.append("    return ("
               + "".join(f"r{i}, " for i in range(n)) + "), ("
               + "".join(f"e{i}, " for i in range(n)) + "), m")
    ns: dict = {}
    exec("\n".join(src), ns)            # noqa: S102 - self-generated
    core_sum = 0.0                      # prepaid busy integral for a
    for i in core_idx:                  # run fully inside the horizon
        core_sum += durs[i]             # (same add order as the clip
    ct = (pred, durs, core_idx, w_cpu, w_be,    # loop)
          prog.release_idx, prog.respond_idx, n, groups,
          tuple(t == _OP_CORE for t in timed),
          ns["_solo"], core_sum)
    tmpl = (tuple(1 if i in roots else d
                  for i, d in enumerate(prog.indegree)),
            len(prog.names), durs,
            tuple(tuple(code[s] for s in succs)
                  for succs in prog.succ)
            + (tuple(code[r] for r in prog.roots),),
            ops, tuple(timed),
            tuple(code[r] for r in prog.roots),
            tuple(code), tuple(intra), ct)
    return (prog, tmpl)


def cache_overlay(prog: PlanProgram, ops: tuple, ops2: tuple,
                  profile: "W.IOProfile"):
    """The SharedCache overlay for one compiled bundle: fresh opcode
    arrays with `_OP_CACHE` patched over `_OP_WIRE` at every
    cache-consulting GET's ``fetch_net[i]`` position (each array only
    where it holds the wire opcode — a group-head ``fetch_net`` keeps
    `_OP_SLOT` at ready time and patches its post-grant opcode), plus
    the per-invocation access list the twin `CacheState` replays:

    * ``("g", lk_suffix, ck_suffix|None, size, hinted, net_pi, cpu_pi)``
      per consulted GET — ``lk_suffix`` names the logical object
      (`Get.key` or positional), ``ck_suffix`` is set when the content
      is `shared` across deployed copies (weight shards — dedups);
      ``hinted`` is the GET's prefetch-hint promotion (admission);
    * ``("p", lk_suffix, size)`` per PUT (write-allocation).

    A `Get` with ``cacheable=False`` is fully transparent: no entry, no
    opcode patch — both executors bypass the plane for it.
    `scripts/regen_goldens.py --check` re-verifies every overlay via
    `analysis.verify.verify_cache_overlay`."""
    cvec = P.cache_vector(prog.names)
    net_pi = {gi: i for i, gi in enumerate(cvec) if gi >= 0}
    cpu_pi: dict[int, int] = {}
    for i, nm in enumerate(prog.names):
        base, _, idx = nm.partition("[")
        if base == "fetch_cpu":
            cpu_pi[int(idx.rstrip("]"))] = i
    cops, cops2 = list(ops), list(ops2)
    accesses: list[tuple] = []
    gi = pk = 0
    for op in profile.ops:
        if isinstance(op, W.Get):
            if op.cacheable:
                pi = net_pi[gi]
                if cops[pi] == _OP_WIRE:
                    cops[pi] = _OP_CACHE
                if cops2[pi] == _OP_WIRE:
                    cops2[pi] = _OP_CACHE
                lks = op.key or f"g{gi}"
                accesses.append(("g", lks, lks if op.shared else None,
                                 op.size_bytes, op.prefetchable, pi,
                                 cpu_pi.get(gi, -1)))
            gi += 1
        elif isinstance(op, W.Put):
            accesses.append(("p", op.key or f"p{pk}", op.size_bytes))
            pk += 1
    return tuple(cops), tuple(cops2), tuple(accesses)


#: selectable DES engines (see README "Engines"):
#: * ``legacy``   — pre-refactor PhasePlan walker (parity reference);
#: * ``classic``  — PR-3 fused PlanProgram loop, every phase an event;
#: * ``hot``      — classic + cohort compression (default);
#: * ``calendar`` — hot's semantics on a CalendarQueue scheduler.
ENGINES = ("hot", "classic", "calendar", "legacy")
_ENGINE_ALIASES = {"program": "classic"}


class DensitySimulator:
    """One run: `n_functions` deployed on a cluster for `duration_s`."""

    KEEPALIVE_S = 60.0

    def __init__(self, system: str, n_functions: int, *, seed: int = 0,
                 nodes: int = 4, cores: int = 28, mem_gb: float = 128.0,
                 duration_s: float = 90.0, warmup_s: float = 15.0,
                 mean_rate: float = 1.6, backend_workers: int = 64,
                 rate_sigma: float = 1.0, max_vms_per_node: int = 280,
                 suite: dict[str, W.Workload] | None = None,
                 arrival_pattern: str | W.ArrivalPattern = "azure",
                 engine: str = "hot",
                 faults: "FA.FaultSchedule | None" = None,
                 guardrails: "GR.GuardrailPolicy | None" = None,
                 cache: "CacheSpec | None" = None,
                 verify_plans: bool = False,
                 loop: "EventLoop | None" = None,
                 gen_arrivals: bool = True):
        # "program" is the PR-3 name of the uncompressed PlanProgram
        # engine, kept as an alias so existing callers measure exactly
        # what they always measured.
        engine = _ENGINE_ALIASES.get(engine, engine)
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        self.spec: SystemSpec = SYSTEMS[system]
        self.engine = engine
        #: cohort compression on (hot/calendar): uncontended invocations
        #: collapse to 1-2 barrier events via the solo-schedule replay
        self._compress = engine in ("hot", "calendar")
        self.compressed_invocations = 0
        self.materializations = 0
        #: SharedCache: one `CacheState` for this sim's node group (a
        #: cluster member == one host, so each member owns its own).
        #: A spec routes every invocation through the faulted
        #: PlanProgram interpreter — synthesizing an EMPTY FaultSchedule
        #: when none was given, which is pinned bit-for-bit against the
        #: fault-free engines — so all four engines drive the one
        #: CacheState in identical virtual-time order and hit/miss/
        #: eviction counts cannot depend on the engine. ``None``
        #: disables everything: the fault-free paths are untouched.
        self._cache_spec = cache
        self._cache = CacheState(cache) if cache is not None else None
        self._cprogs: dict = {}     # (base, cold) -> (tmpl', accesses)
        if cache is not None and faults is None:
            faults = FA.FaultSchedule.empty()
        #: FaultPlane: a schedule routes every invocation through the
        #: faulted PlanProgram interpreter (both engines — the event
        #: discipline mirrors `_start`/`_hot` exactly, so an *empty*
        #: schedule reproduces the fault-free engines bit-for-bit).
        self._faults = faults
        self._outage_until = 0.0
        self._live: list = []
        #: GuardRails: a policy routes every run through the
        #: event-driven method path (like faults do) and puts one
        #: admission decision in front of `_arrive` — an *empty*
        #: policy decides "admit" for everything, consumes no event
        #: seq, and reproduces all four engines bit-for-bit (pinned
        #: by the des_parity golden gate).
        self._guardrails = guardrails
        self._guard = (None if guardrails is None
                       else GR.GuardState(guardrails,
                                          clock=lambda: self.loop.now))
        if (self._guard is not None and self._guard.breaker is not None
                and guardrails.breaker.open_on_slow and faults is not None):
            self._guard.breaker.set_slow_windows(
                faults.windows(FA.STORAGE_SLOW))
        self.shed = {r: 0 for r in GR.SHED_REASONS}
        self.rejections: dict = {}
        self._unloaded_cache: dict[str, float] = {}
        self.acct = M.CycleAccount()
        self.fault_stats = {"crashes": 0, "aborted_groups": 0,
                            "killed_invocations": 0, "storage_retries": 0,
                            "delayed_acks": 0, "restore_retries": 0,
                            "alloc_stalls": 0}
        self.put_ledger: dict = {}
        self.responses: dict = {}
        self.n_functions = n_functions
        self.duration_s = duration_s
        self.warmup_s = warmup_s
        #: shared-loop mode (ClusterSimulator): several sims multiplex
        #: one EventLoop/virtual clock. The owner routes hot records to
        #: each sim via the _R_OWN/_C_OWN slot; keep-alive retirements
        #: go through the heap (identical (t, seq) order — the timer
        #: deque is a single-sim perf shortcut, not a semantic).
        self._ext_loop = loop is not None
        if self._ext_loop:
            if engine == "legacy":
                raise ValueError(
                    "legacy engine cannot share an external loop")
            self.loop = loop
        else:
            self.loop = EventLoop(classic=(engine == "legacy"))
            if engine == "calendar":
                self.loop.cal = CalendarQueue()
        #: events after this instant can never run (`run` drains up to
        #: it); the program engine skips scheduling beyond it
        self._horizon = _INF
        self.max_vms_per_node = max_vms_per_node
        backend_mb = (0.0 if self.spec.coupled else F.BACKEND_BASE_MB)
        self.nodes = [SimNode(self.loop, cores, mem_gb * 1024, backend_mb,
                              backend_workers)
                      for _ in range(nodes)]
        self.transport = TRANSPORTS[self.spec.transport]
        # one structural source of truth: the plan compiled from each
        # workload's declared IOProfile, per coldness — lowered to a
        # PlanProgram + duration vector per (workload, coldness), built
        # once and interpreted by every invocation. Workloads sharing
        # an I/O shape share the program (compile caches on the shape).
        self._suite = suite if suite is not None else W.SUITE
        self._progs: dict[tuple[str, bool], tuple[PlanProgram, tuple]] = {}
        self._walk: dict[tuple[str, bool], tuple] = {}
        self._durs: dict[tuple[str, bool], dict[str, float]] = {}
        #: verify-on-compile (PlanCheck): run the full `analysis.verify`
        #: invariant pass over each (workload, coldness) bundle the
        #: first time this sim resolves it — including bundles served
        #: from the process-wide cache, so a corrupted cached template
        #: cannot slip into a run that asked for verification.
        self._verify_plans = bool(verify_plans)
        self._verified: set[tuple[str, bool]] = set()

        # one deployed function = (name, workload); suite cycles round-robin
        names = list(self._suite)
        self.functions = [f"{names[i % len(names)]}#{i}"
                          for i in range(n_functions)]
        self._base = {f: f.split("#")[0] for f in self.functions}
        self.workload = {f: self._suite[self._base[f]]
                         for f in self.functions}

        self.pattern = W.resolve_pattern(arrival_pattern)
        if gen_arrivals:
            specs = sample_rates(self.functions, seed, mean_rate=mean_rate,
                                 sigma=rate_sigma)
            self.arrivals = {s.function: generate_arrivals(
                                 s, duration_s, seed, pattern=self.pattern)
                             for s in specs}
        else:   # externally driven (cluster member): no local stream
            self.arrivals = {}

        self.idle: dict[str, list[SimInstance]] = {f: []
                                                   for f in self.functions}
        self.backlog: dict[str, deque] = {f: deque()
                                          for f in self.functions}
        self.latencies: dict[str, list[float]] = {f: [] for f in
                                                  self.functions}
        #: per-function hot record (see the _F_* layout) — shares the
        #: idle/backlog/latency containers above
        self._fnrec = {f: [self.idle[f], self.backlog[f], None, None,
                           self.latencies[f], self._base[f]]
                       for f in self.functions}
        #: keep-alive retirements: the delay is one constant, so fire
        #: times are monotone in schedule order — a deque IS the timer
        #: wheel, and tens of thousands of 60s timers stay out of the
        #: event heap (they used to dominate its depth)
        self._retq: deque = deque()
        self._free_runs: list = []         # recycled run records
        self.cold_starts = 0
        self.completed = 0
        self.rejected = 0
        self.mem_samples: list[float] = []

        self._rss = {f: F.instance_memory(self.workload[f].extra_libs_mb,
                                          self.spec.memory_variant).total()
                     + (0.0 if self.spec.coupled
                        else F.BACKEND_PER_INSTANCE_MB)
                     for f in self.functions}

        # sentinel-record handler + keep-alive timer source: the loop
        # dispatches hot events and retirements identically to _run_hot
        # (a shared loop keeps the owner's router instead)
        if not self._ext_loop:
            self.loop.hot = self._hot
            self.loop.timerq = self._retq
            self.loop.timer_cb = self._retire

    # ----------------------------------------------------------- cost model

    def _program(self, base_name: str, cold: bool):
        """(PlanProgram, run-record template) for one workload — the
        program engine's whole structural + cost input. Two-level
        cache: a per-sim dict in front of the process-wide
        `_BUNDLES` table keyed on (variant, workload, coldness,
        kernel-bypass) — a density search builds each template exactly
        once across all its probes instead of once per probe
        (`bundle_cache_stats` reports the hit rate and compile-time
        share; `benchmarks/sim_throughput.py` prints it)."""
        key = (base_name, cold)
        bundle = self._progs.get(key)
        if bundle is None:
            w = self._suite[base_name]
            gkey = (self.spec.name, w, cold, self.transport.kernel_bypass)
            bundle = _BUNDLES.get(gkey)
            if bundle is None:
                t0 = _perf_counter()
                bundle = _build_bundle(self.spec, w, cold,
                                       self.transport.kernel_bypass)
                _BUNDLE_STATS["compile_s"] += _perf_counter() - t0
                _BUNDLE_STATS["misses"] += 1
                _BUNDLES[gkey] = bundle
            else:
                _BUNDLE_STATS["hits"] += 1
            if self._verify_plans and key not in self._verified:
                from repro_torch.core.analysis.verify import verify_program
                verify_program(
                    bundle[0],
                    durations=P.duration_vector(self.spec, w, cold),
                    subject=f"{self.spec.name}/{base_name}/"
                            f"{'cold' if cold else 'warm'}")
                self._verified.add(key)
            self._progs[key] = bundle
        return bundle

    def _cache_bundle(self, base_name: str, cold: bool):
        """Cache-enabled (prog, template, accesses) for one workload:
        the shared bundle with the `_OP_CACHE` overlay patched into
        fresh opcode arrays — the per-sim `_cprogs` dict keeps the
        process-wide `_BUNDLES` templates pristine for cache-disabled
        runs (bit-for-bit golden safety)."""
        key = (base_name, cold)
        rec = self._cprogs.get(key)
        if rec is None:
            prog, tmpl = self._program(base_name, cold)
            w = self._suite[base_name]
            cops, cops2, accesses = cache_overlay(prog, tmpl[4], tmpl[5],
                                                  w.profile)
            tmpl = tmpl[:4] + (cops, cops2) + tmpl[6:]
            rec = (prog, tmpl, accesses)
            self._cprogs[key] = rec
        return rec

    def _cache_access(self, fn: str, base: str, t_arr: float,
                      accesses: tuple, durs: tuple) -> tuple:
        """Replay one invocation's declared GET/PUT trace against the
        sim's `CacheState` at arrival, in virtual-time service order —
        the same serial order the threaded node's trace drives the twin
        machine, so the counters are its replay-verified prediction.
        SERIAL-TRACE PRECONDITION: the whole trace lands at arrival,
        while the threaded node fills only after the remote fetch
        completes — under concurrent first GETs of one key the DES
        scores 1 miss + 1 hit where the threaded node scores 2 misses.
        Cross-executor count parity is only asserted on serial traces
        (`tests/test_cache.py::TestCountParity`); concurrent
        cache-enabled runs (e.g. the chaos matrix) compare DES engines
        to each other instead.
        Returns the run's duration vector with each hit's
        ``fetch_net[i]`` shrunk to the arena hit service time and its
        SDK cpu cost zeroed — exactly what the threaded hit path skips.
        Logical keys are per *deployed function* (a node caches what
        its tenants re-read); content keys collapse to the workload
        base for `shared` GETs and per-put output streams (dedup)."""
        st = self._cache
        spec = self._cache_spec
        patched = None
        for a in accesses:
            if a[0] == "g":
                _, lks, cks, size, hinted, net_pi, cpu_pi = a
                lk = f"{fn}/{lks}"
                ck = f"{base}/{cks}" if cks is not None else lk
                if st.lookup(lk) is not None:
                    if patched is None:
                        patched = list(durs)
                    patched[net_pi] = spec.hit_duration_s(size)
                    if cpu_pi >= 0:
                        patched[cpu_pi] = 0.0
                else:
                    st.fill(lk, ck, size, hinted=hinted)
            else:
                _, lks, size = a
                st.write(f"{fn}/{lks}@{t_arr!r}", f"{base}/{lks}", size)
        return durs if patched is None else tuple(patched)

    def _durations(self, base_name: str, cold: bool) -> dict[str, float]:
        key = (base_name, cold)
        if key not in self._durs:
            self._durs[key] = P.phase_durations(
                self.spec, self._suite[base_name], cold)
        return self._durs[key]

    def _plan_walk(self, base_name: str, cold: bool) -> tuple:
        """(plan, group-head lookup, slot-release lookup) for one
        workload's compiled plan — the legacy walker's structural input."""
        key = (base_name, cold)
        if key not in self._walk:
            p = compile_plan(self.spec, self._suite[base_name].profile,
                             cold=cold)
            groups = p.backend_groups()
            bypass = self.transport.kernel_bypass
            self._walk[key] = (
                p,
                {members[0]: g for g, members in groups.items()},
                {g: p.slot_release_phase(g, bypass) for g in groups})
        return self._walk[key]

    def unloaded_latency(self, fn: str) -> float:
        """Warm, zero-contention critical path (the SLO denominator) —
        the warm plan's critical path, by construction."""
        return P.unloaded_latency(self.spec, self.workload[fn])

    # ------------------------------------------------------------ placement

    def _place(self, rss_mb: float) -> int | None:
        best, best_free = None, -1.0
        for i, n in enumerate(self.nodes):
            if n.vms >= self.max_vms_per_node:       # overcommit cap (§6)
                continue
            free = n.mem_cap - n.mem_used
            if free >= rss_mb and free > best_free:
                best, best_free = i, free
        return best

    # ------------------------------------------------------------ lifecycle

    def _spawn(self, fn: str) -> SimInstance | None:
        rss = self._rss[fn]
        node = self._place(rss)
        if node is None:
            return None
        self.nodes[node].mem_used += rss
        self.nodes[node].vms += 1
        self.nodes[node].mem_peak = max(self.nodes[node].mem_peak,
                                        self.nodes[node].mem_used)
        self.cold_starts += 1
        return SimInstance(fn, node, rss)

    def _retire(self, inst: SimInstance, seq: int) -> None:
        if inst.state == "warm" and inst.expire_seq == seq \
                and inst in self.idle[inst.fn]:
            self.idle[inst.fn].remove(inst)
            self.nodes[inst.node].mem_used -= inst.rss_mb
            self.nodes[inst.node].vms -= 1

    def _release(self, inst: SimInstance) -> None:
        """Instance finishes guest work; serve backlog or go idle."""
        if self.backlog[inst.fn]:
            t_arr = self.backlog[inst.fn].popleft()
            self._execute(inst, t_arr, cold=False)
            return
        inst.state = "warm"
        inst.expire_seq += 1
        self.idle[inst.fn].append(inst)
        loop = self.loop
        if self.engine != "legacy":
            t = loop.now + self.KEEPALIVE_S
            if t > self._horizon:
                return  # unobservable: the loop drains before it fires
            if self._ext_loop:
                # shared loop: the timer deque belongs to no single sim,
                # so retirements ride the heap — one seq either way, so
                # the global (t, seq) event order is unchanged
                loop.at(t, self._retire, inst, inst.expire_seq)
            else:
                loop.sched_timer(t, inst, inst.expire_seq)
        else:           # pre-refactor: keep-alive timers in the heap
            loop.after(self.KEEPALIVE_S, self._retire, inst,
                       inst.expire_seq)

    # ------------------------------------------------------------ invocation

    def _arrive(self, fn: str, _=None) -> None:
        if self._guard is not None and not self._admit(fn):
            return
        self._dispatch(fn, self.loop.now)

    def _dispatch(self, fn: str, t_arr: float) -> None:
        idle = self.idle[fn]
        if idle:
            inst = idle.pop()
            inst.state = "busy"
            inst.expire_seq += 1
            self._execute(inst, t_arr, cold=False)
            return
        inst = self._spawn(fn)
        if inst is None:
            # cluster memory-full: queue for a warm instance
            self.backlog[fn].append(t_arr)
            return
        inst.state = "busy"
        self._execute(inst, t_arr, cold=True)

    # ------------------------------------------------------------ guardrails
    #
    # One admission decision in front of every arrival (guarded runs
    # only — `_run_hot`'s fused loop is never taken with a policy, so
    # the inline arrival block stays untouched). The decision machine
    # is `guardrails.GuardState` over the loop's virtual clock — the
    # SAME state machine the threaded node drives with a real clock,
    # which is what makes DES shed counts a *prediction* of the
    # threaded node's. Backlog service (`_release`) and fault redrives
    # (`_f_rearrive`) bypass admission: those requests were already
    # admitted once.

    def _admit(self, fn: str) -> bool:
        """True to dispatch now. Queued arrivals re-enter through a
        timed event at their paced admission instant (latency accrues
        from the ORIGINAL arrival — the caller waited in the queue);
        sheds record a typed rejection in the `rejections` ledger,
        atomically — no instance, no events, no partial work."""
        g = self._guard
        now = self.loop.now
        u = self._unloaded_cache.get(fn)
        if u is None:
            u = self._unloaded_cache[fn] = self.unloaded_latency(fn)
        d = g.decide(fn, self._base[fn], u)
        if d.action == "admit":
            return True
        if d.action == "queue":
            t = now + d.delay_s
            if t <= self._horizon:
                self.loop.at(t, self._dispatch, fn, now)
            # past the horizon the loop drains first: the outcome is
            # unobservable either way (same rule as keep-alive timers)
            return False
        self.shed[d.reason] += 1
        self.rejected += 1
        self.rejections[(fn, now)] = d.reason
        self.acct.cross(M.SHED)
        return False

    def _execute(self, inst: SimInstance, t_arr: float, cold: bool) -> None:
        if self._faults is not None:
            self._execute_faulted(inst, t_arr, cold)
        elif self.engine != "legacy":
            rec = self._fnrec[inst.fn]
            bundle = rec[_F_COLD] if cold else rec[_F_WARM]
            if bundle is None:
                bundle = self._program(rec[_F_BASE], cold)
                rec[_F_COLD if cold else _F_WARM] = bundle
            tmpl = bundle[1]
            node = self.nodes[inst.node]
            if self._compress:
                ct = tmpl[9]
                cpu = node.cpu_hot
                be = node.be_hot
                if not node.cpu_wait and not node.be_wait \
                        and cpu[0] + ct[_CT_WC] <= cpu[1] \
                        and be[0] + ct[_CT_WB] <= be[1]:
                    # replay base is *now* (service start), not t_arr:
                    # backlog serves start when the instance frees up
                    self._form_compressed(inst, t_arr, self.loop.now,
                                          bundle, node, rec[_F_LATS])
                    return
            run = [list(tmpl[0]), tmpl[2], tmpl[3], tmpl[4], tmpl[5],
                   node.cpu_hot, node.cpu_wait, node.be_hot, node.be_wait,
                   rec[_F_LATS], inst, t_arr, self]
            for c in tmpl[6]:              # root codes: zero-indegree
                self._start(run, c)
        else:
            self._execute_legacy(inst, t_arr, cold)

    # -------------------------------------- cohort-compressed fast path
    #
    # An uncontended invocation's whole event cascade is determined at
    # arrival: with its maximum core/slot concurrency reserved up
    # front, no grant inside the run can ever queue, so its phase
    # end-times are exactly the solo schedule's —
    # ``end[i] = max(parent ends, t_arr) + d[i]`` in topological order,
    # the *same IEEE adds and maxes* the event engine performs (its
    # `now` at a phase grant IS the max parent end, carried as a float
    # through the heap). The run collapses to its observable events —
    # the release and respond barriers — and every internal phase event
    # is elided. The whole same-timestamp cohort of each arrival is
    # thereby drained as one batch over the program's predecessor
    # arrays instead of one heap event per phase.
    #
    # Reservations are deliberately conservative (`_hold_width` counts
    # unrelated boundary-adjacent holds as concurrent): an over-reserved run just
    # falls back to the scalar path, while under-reserving could let a
    # compressed run proceed where the event engine would have queued
    # it. If a scalar grant later finds a pool full while reservations
    # exist, `_materialize` converts the node's compressed runs back to
    # event-driven execution at the stored schedule times — contended
    # cohorts stay event-for-event equal to the scalar engine.

    def _form_compressed(self, inst: SimInstance, t_arr: float, t0: float,
                         bundle: tuple, node: SimNode, lats: list) -> None:
        """Admit one invocation to the compressed path: replay the solo
        schedule from service-start time `t0`, reserve its widths,
        schedule only its barriers. `t_arr` is kept for latency."""
        tmpl = bundle[1]
        ct = tmpl[9]
        durs = ct[1]
        ready, ends, emax = ct[_CT_SOLO](t0)
        hz = self._horizon
        cpu = node.cpu_hot
        if emax <= hz:                 # granted core-time, clipped at
            cpu[2] += ct[_CT_CORESUM]  # the horizon (mirrors _start)
        else:
            acc = 0.0
            for i in ct[2]:
                e = ends[i]
                if e <= hz:
                    acc += durs[i]
                else:
                    s0 = ready[i]
                    if s0 < hz:
                        acc += hz - s0
            cpu[2] += acc
        cpu[0] += ct[3]
        node.be_hot[0] += ct[4]
        crun = [inst, t_arr, lats, node, ct[3], ct[4], False,
                ends, ready, bundle, False, self]
        node.cruns.append(crun)
        self.compressed_invocations += 1
        loop = self.loop
        rel, resp = ct[5], ct[6]
        if rel == resp:
            if ends[resp] <= hz:
                loop.sched(ends[resp], crun, _CRUN | _RELB | _RESPB)
        else:
            if ends[rel] <= hz:
                loop.sched(ends[rel], crun, _CRUN | _RELB)
            if ends[resp] <= hz:
                loop.sched(ends[resp], crun, _CRUN | _RESPB)

    def _materialize(self, node: SimNode, state: list | None = None) -> None:
        """Convert compressed runs on `node` back to event-driven
        execution at their stored schedules, correcting the pool
        counters from reservations to actual holds. Done phases are
        dropped, in-flight phases get completion events at their solo
        end-times (the same floats the scalar engine would carry),
        future phases get indegree countdowns over their unfinished
        parents. Called only from a failed scalar grant, with loop
        state synced.

        With `state` (the pool the grant failed on), conversion is
        *partial*: oldest runs convert until the pool has room, so one
        contended grant doesn't forfeit the whole node's compression —
        which runs stay compressed is free policy, since compressed
        and scalar timing are identical by construction. If every run
        converts and the pool is still full, the caller enqueues a
        waiter — preserving the invariant that waiters only exist on
        crun-free nodes. Pool corrections for all converted runs land
        before any barrier fires: a barrier's `_release` can re-enter
        `_execute`, which must see consistent pools."""
        loop = self.loop
        now = loop.now
        hz = self._horizon
        cpu = node.cpu_hot
        be = node.be_hot
        self.materializations += 1
        cruns = node.cruns
        due = []
        while cruns and (state is None or state[0] >= state[1]):
            crun = cruns.pop(0)  # oldest first; re-entrant formations
                                 # append behind and survive
            crun[_C_DEAD] = True
            prog, tmpl = crun[_C_BND]
            ct = tmpl[9]
            pred = ct[0]
            durs = ct[1]
            oncore = ct[9]
            codes = tmpl[7]
            ends = crun[_C_ENDS]
            ready = crun[_C_READY]
            n = ct[7]
            need = [0] * n
            run = [need, tmpl[2], tmpl[3], tmpl[4], tmpl[5],
                   cpu, node.cpu_wait, be, node.be_wait,
                   crun[_C_LATS], crun[_C_INST], crun[_C_T], self]
            cores_held = 0
            for i in range(n):
                e = ends[i]
                if e <= now:                # done
                    continue
                if ready[i] <= now:         # in-flight: real event now
                    if oncore[i]:
                        cores_held += 1
                        loop.sched(e, run, codes[i] | _CORE)
                    else:
                        loop.sched(e, run, codes[i])
                else:                       # future: countdown resumes
                    c = 0
                    for p in pred[i]:
                        if ends[p] > now:
                            c += 1
                    need[i] = c
                    if oncore[i]:           # roll back the prepaid
                        if e <= hz:         # integral (re-added at its
                            cpu[2] -= durs[i]   # real grant)
                        elif ready[i] < hz:
                            cpu[2] -= hz - ready[i]
            slots_held = 0
            for h, r in ct[8]:
                if ready[h] <= now < ends[r]:
                    slots_held += 1
            cpu[0] += cores_held - crun[_C_WC]
            be[0] += slots_held - crun[_C_WB]
            due.append(crun)
        for crun in due:
            # a barrier due exactly `now` may still sit in the queue
            # behind the triggering event — its record is dead, so it
            # fires here (a strictly-earlier barrier already fired)
            prog, tmpl = crun[_C_BND]
            ct = tmpl[9]
            ends = crun[_C_ENDS]
            if not crun[_C_RELDONE] and ends[ct[5]] <= now:
                crun[_C_RELDONE] = True
                self._release(crun[_C_INST])
            if ends[ct[6]] <= now:
                t0 = crun[_C_T]
                if t0 >= self.warmup_s:
                    crun[_C_LATS].append(now - t0)
                self.completed += 1

    # ------------------------------------------- PlanProgram engine (hot)
    #
    # Every dispatch discipline here mirrors the legacy walker exactly —
    # that equivalence is what the bit-for-bit parity goldens pin:
    # backend-slot *grants* are deferred one beat through the zero-delay
    # FIFO (the slot itself moves synchronously), zero-duration phases
    # complete through the FIFO, and a freed core goes to the oldest
    # waiter whose completion is scheduled immediately.

    def _start(self, run: list, code: int) -> None:
        """Phase `code` (index | static flags) became ready: take its
        backend-group slot if it heads one, then execute. Kept in
        lockstep with the inlined blocks of `_run_hot`.

        Pool accounting differs from the legacy `CorePool._account`
        discipline in form, not substance: a granted core contributes
        its hold time (clipped at the run horizon) to `busy_integral`
        up front — one add per grant instead of an integral update on
        every transition — and the backend pool tracks only occupancy
        (its integral was write-only)."""
        loop = self.loop
        now = loop.now
        op = run[_R_OPS][code & _PI_MASK]
        if op == _OP_CORE:
            # guest vCPU and backend work contend on node cores
            state = run[_R_CPU]
            if state[0] >= state[1] and state[3].cruns:
                self._materialize(state[3], state)
            if state[0] < state[1]:
                state[0] += 1
                d = run[_R_DURS][code & _PI_MASK]
                end = now + d
                hz = self._horizon
                state[2] += d if end <= hz else hz - now
                loop.sched(end, run, code | _CORE)
            else:
                run[_R_CPUW].append((run, code))
        elif op == _OP_WIRE:               # pure latency
            loop.sched(now + run[_R_DURS][code & _PI_MASK], run, code)
        elif op == _OP_SLOT:               # backend-group head
            state = run[_R_BE]
            if state[0] >= state[1] and state[3].cruns:
                self._materialize(state[3], state)
            if state[0] < state[1]:
                state[0] += 1
                loop.sched0(run, code | _EXEC)
            else:
                run[_R_BEW].append((run, code))
        else:                              # zero duration
            loop.sched0(run, code)

    def _hot(self, run: list, code: int) -> None:
        """Dispatch one hot event record — the whole per-phase state
        machine: EXEC (slot granted, start the work), CORE (phase
        finished holding a core: free it, grant the oldest waiter),
        then the phase-done logic (slot drop, barriers, indegree
        countdown over the successor indices). `_run_hot` inlines this
        same machine; the engine-parity test pins the two."""
        loop = self.loop
        now = loop.now
        if code & _CRUN:                   # compressed-run barrier event
            if not run[_C_DEAD]:           # (`run` is a crun record)
                if code & _RELB:
                    run[_C_RELDONE] = True
                    self._release(run[_C_INST])
                # re-check dead: `_release` can re-enter `_materialize`,
                # which may convert THIS crun and fire its due respond
                # barrier itself
                if code & _RESPB and not run[_C_DEAD]:
                    t_arr = run[_C_T]
                    if t_arr >= self.warmup_s:
                        run[_C_LATS].append(now - t_arr)
                    self.completed += 1
                    node = run[_C_NODE]
                    node.cpu_hot[0] -= run[_C_WC]
                    node.be_hot[0] -= run[_C_WB]
                    run[_C_DEAD] = True
                    node.cruns.remove(run)
            return
        pi = code & _PI_MASK
        if code & _EXEC:
            op = run[_R_OPS2][pi]
            if op == _OP_CORE:
                state = run[_R_CPU]
                if state[0] >= state[1] and state[3].cruns:
                    self._materialize(state[3], state)
                if state[0] < state[1]:
                    state[0] += 1
                    d = run[_R_DURS][pi]
                    end = now + d
                    hz = self._horizon
                    state[2] += d if end <= hz else hz - now
                    loop.sched(end, run, (code ^ _EXEC) | _CORE)
                else:
                    run[_R_CPUW].append((run, code ^ _EXEC))
            elif op == _OP_WIRE:
                loop.sched(now + run[_R_DURS][pi], run, code ^ _EXEC)
            else:                          # zero duration
                loop.sched0(run, code ^ _EXEC)
            return
        if code & _CORE:
            state = run[_R_CPU]
            state[0] -= 1
            wait = run[_R_CPUW]
            if wait:                       # hand the core to the oldest
                state[0] += 1              # waiter, FIFO
                run2, c2 = wait.popleft()
                d = run2[_R_DURS][c2 & _PI_MASK]
                end = now + d
                hz = self._horizon
                state[2] += d if end <= hz else hz - now
                loop.sched(end, run2, c2 | _CORE)
        # ---------------------------------------------------- phase done
        if code & _SLOTREL:
            state = run[_R_BE]
            state[0] -= 1
            wait = run[_R_BEW]
            if wait:
                state[0] += 1
                run2, c2 = wait.popleft()
                loop.sched0(run2, c2 | _EXEC)
        if code & _RELB:
            self._release(run[_R_INST])
        if code & _RESPB:
            t_arr = run[_R_T]
            if t_arr >= self.warmup_s:
                run[_R_LATS].append(now - t_arr)
            self.completed += 1
        need = run[_R_NEED]
        for sc in run[_R_SUCC][pi]:
            si = sc & _PI_MASK
            n = need[si] - 1
            need[si] = n
            if n == 0:                     # ready
                self._start(run, sc)

    def _run_hot(self, until: float) -> None:
        """`EventLoop.run` + `_hot` + the arrival and release paths,
        fused into one frame with queue, clock, and sequence state in
        locals — the program engine's main loop (at this event rate the
        attribute traffic of the split methods is the dominant cost).
        Semantics are identical to driving `EventLoop.run` with
        ``hot = self._hot``: the engine-parity test pins the two paths
        against each other, and the goldens pin both against the
        pre-refactor walker. Around any non-inlined call (generic
        callbacks, the rare tie paths, backlog service) the local
        seq/clock are synced back to the loop and reloaded.

        Event sources, consumed in global (t, seq) order exactly as if
        all shared one heap: the zero-delay FIFO (entries at `now`),
        the heap, the keep-alive deque (constant delay => monotone fire
        times), and the arrival feed (wins exact-time ties — arrivals
        were scheduled first pre-refactor)."""
        loop = self.loop
        q = loop._q
        pending = loop._pending
        retq = self._retq
        push, pop = heappush, heappop
        now = loop.now
        seq = loop._seq
        feed = loop._feed
        fi, nf = loop._fi, len(loop._feed)
        inf = _INF
        t_f = feed[fi][0] if fi < nf else inf
        t_r = retq[0][0] if retq else inf   # cached retire-head time
        fnrec = self._fnrec
        nodes = self.nodes
        spawn = self._spawn
        warmup = self.warmup_s
        keepalive = self.KEEPALIVE_S
        hz = self._horizon
        compress = self._compress
        crr = _CRUN | _RELB | _RESPB
        crel = _CRUN | _RELB
        cresp = _CRUN | _RESPB
        ncomp = 0
        completed = 0
        run = None
        while True:
            # ----- pick the next event (smallest (t, seq) across sources)
            if pending:
                # FIFO entries sit at `now`; only a same-time heap or
                # retire record with a smaller seq, or an arrival at
                # `now`, outranks the head (all ~never paths)
                if t_f <= now:
                    fn = feed[fi][1]
                    fi += 1
                    t_f = feed[fi][0] if fi < nf else inf
                    loop._seq, loop.now = seq, now
                    self._arrive(fn)
                    seq = loop._seq
                    t_r = retq[0][0] if retq else inf
                    continue
                # smallest seq among same-time candidates wins
                win = pending[0][0]
                src = 0
                if q and q[0][0] <= now and q[0][1] < win:
                    win = q[0][1]
                    src = 1
                if t_r <= now and retq[0][1] < win:
                    src = 2
                if src == 1:
                    e = pop(q)
                    now = e[0]
                    if len(e) == 4:
                        run, code = e[2], e[3]
                    else:
                        loop._seq, loop.now = seq, now
                        e[2](e[3], e[4])
                        seq = loop._seq
                        t_r = retq[0][0] if retq else inf
                        continue
                elif src == 2:
                    e = retq.popleft()
                    t_r = retq[0][0] if retq else inf
                    self._retire(e[2], e[3])
                    continue
                else:
                    e = pending.popleft()
                    if len(e) == 3:
                        run, code = e[1], e[2]
                    else:
                        loop._seq, loop.now = seq, now
                        e[1](e[2], e[3])
                        seq = loop._seq
                        t_r = retq[0][0] if retq else inf
                        continue
            else:
                t_q = q[0][0] if q else inf
                if t_f <= t_q and t_f <= t_r:
                    if t_f > until:
                        break
                    now = t_f
                    # ------------------- arrival: _arrive, inlined
                    fn = feed[fi][1]
                    fi += 1
                    t_f = feed[fi][0] if fi < nf else inf
                    rec = fnrec[fn]
                    idle = rec[0]
                    if idle:
                        inst = idle.pop()
                        inst.state = "busy"
                        inst.expire_seq += 1
                        bundle = rec[2]
                        if bundle is None:
                            bundle = rec[2] = self._program(rec[5], False)
                    else:
                        inst = spawn(fn)
                        if inst is None:   # memory-full: backlog
                            rec[1].append(now)
                            continue
                        inst.state = "busy"
                        bundle = rec[3]
                        if bundle is None:
                            bundle = rec[3] = self._program(rec[5], True)
                    tmpl = bundle[1]
                    node = nodes[inst.node]
                    if compress:           # cohort-compressed fast path
                        # (inlined `_form_compressed` — kept in
                        # lockstep, like the `_start`/`_hot` blocks)
                        ct = tmpl[9]
                        cstate = node.cpu_hot
                        bstate = node.be_hot
                        if not node.cpu_wait and not node.be_wait \
                                and cstate[0] + ct[3] <= cstate[1] \
                                and bstate[0] + ct[4] <= bstate[1]:
                            ready, ends, emax = ct[10](now)
                            if emax <= hz:
                                cstate[2] += ct[11]
                            else:
                                acc = 0.0
                                cds = ct[1]
                                for i in ct[2]:
                                    e = ends[i]
                                    if e <= hz:
                                        acc += cds[i]
                                    else:
                                        s0 = ready[i]
                                        if s0 < hz:
                                            acc += hz - s0
                                cstate[2] += acc
                            cstate[0] += ct[3]
                            bstate[0] += ct[4]
                            crun = [inst, now, rec[4], node, ct[3],
                                    ct[4], False, ends, ready, bundle,
                                    False, self]
                            node.cruns.append(crun)
                            ncomp += 1
                            rel, resp = ct[5], ct[6]
                            e_resp = ends[resp]
                            if rel == resp:
                                if e_resp <= hz:
                                    seq += 1
                                    push(q, (e_resp, seq, crun, crr))
                            else:
                                e_rel = ends[rel]
                                if e_rel <= hz:
                                    seq += 1
                                    push(q, (e_rel, seq, crun, crel))
                                if e_resp <= hz:
                                    seq += 1
                                    push(q, (e_resp, seq, crun, cresp))
                            continue
                    run = [list(tmpl[0]), tmpl[2], tmpl[3], tmpl[4],
                           tmpl[5], node.cpu_hot, node.cpu_wait,
                           node.be_hot, node.be_wait, rec[4], inst, now,
                           self]
                    code = tmpl[1]         # "complete" the virtual root
                    # falls through to the hot block: the virtual
                    # phase's successors are the roots
                elif t_q < t_r or (t_q == t_r and q[0][1] < retq[0][1]):
                    if t_q > until:
                        break
                    e = pop(q)
                    now = e[0]
                    if len(e) == 4:
                        run, code = e[2], e[3]
                    else:                  # generic callback event
                        loop._seq, loop.now = seq, now
                        e[2](e[3], e[4])
                        seq = loop._seq
                        t_r = retq[0][0] if retq else inf
                        continue
                else:
                    if t_r > until:
                        break
                    e = retq.popleft()
                    t_r = retq[0][0] if retq else inf
                    now = e[0]
                    # --------------------- keep-alive retire, inlined
                    inst = e[2]
                    if inst.state == "warm" and inst.expire_seq == e[3]:
                        idle = fnrec[inst.fn][0]
                        if inst in idle:
                            idle.remove(inst)
                            node = nodes[inst.node]
                            node.mem_used -= inst.rss_mb
                            node.vms -= 1
                    continue

            # ----- hot block: one phase event (kept in lockstep with
            # `_start`/`_hot`); run + code = phase index | flag bits
            if code & _CRUN:               # compressed-run barrier event
                if not run[6]:             # (`run` is a crun record)
                    if code & _RELB:
                        run[10] = True
                        inst = run[0]
                        rec = fnrec[inst.fn]
                        bl = rec[1]
                        if bl:
                            t_arr = bl.popleft()
                            loop._seq, loop.now = seq, now
                            self._execute(inst, t_arr, False)
                            seq = loop._seq
                            t_r = retq[0][0] if retq else inf
                        else:
                            inst.state = "warm"
                            inst.expire_seq += 1
                            rec[0].append(inst)
                            t_ret = now + keepalive
                            if t_ret <= hz:
                                seq += 1
                                if not retq:
                                    t_r = t_ret
                                retq.append((t_ret, seq, inst,
                                             inst.expire_seq))
                    # re-check dead: serving the backlog can re-enter
                    # `_materialize`, which may convert THIS crun and
                    # fire its due respond barrier itself
                    if code & _RESPB and not run[6]:
                        t_arr = run[1]
                        if t_arr >= warmup:
                            run[2].append(now - t_arr)
                        completed += 1
                        node = run[3]
                        node.cpu_hot[0] -= run[4]
                        node.be_hot[0] -= run[5]
                        run[6] = True
                        node.cruns.remove(run)
                continue
            pi = code & _PI_MASK
            if code & _EXEC:               # backend slot granted
                op = run[4][pi]
                if op == 2:                # _OP_CORE
                    state = run[5]
                    if state[0] >= state[1] and state[3].cruns:
                        loop._seq, loop.now = seq, now
                        self._materialize(state[3], state)
                        seq = loop._seq
                        t_r = retq[0][0] if retq else inf
                    if state[0] < state[1]:
                        state[0] += 1
                        d = run[1][pi]
                        end = now + d
                        state[2] += d if end <= hz else hz - now
                        seq += 1
                        push(q, (end, seq, run, (code ^ _EXEC) | _CORE))
                    else:
                        run[6].append((run, code ^ _EXEC))
                elif op == 3:              # _OP_WIRE
                    seq += 1
                    push(q, (now + run[1][pi], seq, run, code ^ _EXEC))
                else:                      # _OP_ZERO
                    seq += 1
                    pending.append((seq, run, code ^ _EXEC))
                continue
            if code & _CORE:               # free the core, grant oldest
                state = run[5]
                state[0] -= 1
                wait = run[6]
                if wait:
                    state[0] += 1
                    run2, c2 = wait.popleft()
                    d = run2[1][c2 & _PI_MASK]
                    end = now + d
                    state[2] += d if end <= hz else hz - now
                    seq += 1
                    push(q, (end, seq, run2, c2 | _CORE))
            # ------------------------------------------------ phase done
            if code & _SLOTREL:            # drop the backend-group slot
                state = run[7]
                state[0] -= 1
                wait = run[8]
                if wait:
                    state[0] += 1
                    run2, c2 = wait.popleft()
                    seq += 1
                    pending.append((seq, run2, c2 | _EXEC))
            if code & _RELB:               # release barrier (_release,
                inst = run[10]             # inlined)
                rec = fnrec[inst.fn]
                bl = rec[1]
                if bl:
                    t_arr = bl.popleft()   # serve backlog, stay busy
                    loop._seq, loop.now = seq, now
                    self._execute(inst, t_arr, False)
                    seq = loop._seq
                    t_r = retq[0][0] if retq else inf
                else:
                    inst.state = "warm"
                    inst.expire_seq += 1
                    rec[0].append(inst)
                    t_ret = now + keepalive
                    if t_ret <= hz:        # else: unobservable
                        seq += 1
                        if not retq:
                            t_r = t_ret
                        retq.append((t_ret, seq, inst, inst.expire_seq))
            if code & _RESPB:              # respond barrier
                t_arr = run[11]
                if t_arr >= warmup:
                    run[9].append(now - t_arr)
                completed += 1
            need = run[0]
            for sc in run[2][pi]:
                si = sc & _PI_MASK
                n = need[si] - 1
                need[si] = n
                if n == 0:                 # ready: `_start`, inlined
                    op = run[3][si]
                    if op == 2:            # _OP_CORE
                        state = run[5]
                        if state[0] >= state[1] and state[3].cruns:
                            loop._seq, loop.now = seq, now
                            self._materialize(state[3], state)
                            seq = loop._seq
                            t_r = retq[0][0] if retq else inf
                        if state[0] < state[1]:
                            state[0] += 1
                            d = run[1][si]
                            end = now + d
                            state[2] += d if end <= hz else hz - now
                            seq += 1
                            push(q, (end, seq, run, sc | _CORE))
                        else:
                            run[6].append((run, sc))
                    elif op == 3:          # _OP_WIRE
                        seq += 1
                        push(q, (now + run[1][si], seq, run, sc))
                    elif op == 0:          # _OP_SLOT: backend-group head
                        state = run[7]
                        if state[0] >= state[1] and state[3].cruns:
                            loop._seq, loop.now = seq, now
                            self._materialize(state[3], state)
                            seq = loop._seq
                            t_r = retq[0][0] if retq else inf
                        if state[0] < state[1]:
                            state[0] += 1
                            seq += 1
                            pending.append((seq, run, sc | _EXEC))
                        else:
                            run[8].append((run, sc))
                    else:                  # _OP_ZERO
                        seq += 1
                        pending.append((seq, run, sc))
        self.completed += completed
        self.compressed_invocations += ncomp
        loop._seq = seq
        loop._fi = fi
        loop.now = until

    # -------------------------------------- legacy PhasePlan walker
    #
    # The pre-refactor interpreter, preserved verbatim as the parity
    # reference and the sim_throughput baseline: per-invocation closure
    # graph, name-keyed dicts, O(V) successor scans on the shared plan.

    def _execute_legacy(self, inst: SimInstance, t_arr: float,
                        cold: bool) -> None:
        fn = inst.fn
        base = self._base[fn]
        p, group_head, slot_release = self._plan_walk(base, cold)
        durs = self._durations(base, cold)
        node = self.nodes[inst.node]
        loop = self.loop
        remaining = {ph.name: len(ph.after) for ph in p.phases}

        def finish_response():
            lat = loop.now - t_arr
            if t_arr >= self.warmup_s:
                self.latencies[fn].append(lat)
            self.completed += 1

        def phase_done(name: str, _=None) -> None:
            ph = p.phase(name)
            g = ph.backend_group
            if g is not None and slot_release[g] == name:
                node.backend.release()
            if name == p.release_after:
                self._release(inst)
            if name == p.respond_after:
                finish_response()
            for succ in tuple(n2.name for n2 in p.phases
                              if name in n2.after):   # O(V) scan, as before
                remaining[succ] -= 1
                if remaining[succ] == 0:
                    start(succ)

        def start(name: str) -> None:
            ph = p.phase(name)
            d = durs.get(name, 0.0)

            def execute(_a=None, _b=None):
                if d <= 0.0:
                    loop.after(0.0, phase_done, name)
                elif ph.resource in (P.GUEST_CORE, P.BACKEND_WORKER):
                    # guest vCPU and backend work contend on node cores
                    node.cpu.request(d, lambda: phase_done(name))
                else:                      # WIRE / NONE: pure latency
                    loop.after(d, phase_done, name)

            if group_head.get(name) is not None:
                node.backend.acquire(execute)   # slot held across group
            else:
                execute()

        for ph in p.phases:
            if remaining[ph.name] == 0:
                start(ph.name)

    # ------------------------------------ FaultPlane PlanProgram engine
    #
    # Recovery semantics in the PlanProgram interpreter (paper §5, one
    # source of truth with the threaded runtime's FaultInjector). The
    # event discipline deliberately mirrors `_start`/`_hot` — same
    # scheduling order, same seq consumption — so an EMPTY schedule is
    # bit-for-bit the fault-free engines (pinned by tests), and the
    # faulted goldens pin both engine modes against each other.
    #
    # Per-variant failure semantics:
    # * offloaded fabric: a crash aborts only the in-flight
    #   backend-group phases; each aborted group re-drives from its
    #   head behind `restart_delay_s` (idempotent PUTs re-execute) and
    #   the redo work is charged to the `CycleAccount` books;
    # * coupled fabric (baseline/wasm): the fabric crashes *inside*
    #   the guest — any invocation mid-fabric-op dies whole, its
    #   instance is lost, and the caller re-drives it from scratch.

    def _execute_faulted(self, inst: SimInstance, t_arr: float,
                         cold: bool) -> None:
        if self._cache is not None:
            # SharedCache: resolve the overlay bundle (separate cache —
            # never the shared unpatched `rec`/_BUNDLES templates),
            # replay the invocation's GET/PUT trace against the twin
            # CacheState at arrival, and give the run a per-invocation
            # duration vector with its hits shrunk. A crash re-drive
            # (`_f_rearrive`) passes through here again and re-consults
            # the cache — exactly like the threaded node's retry.
            prog, tmpl, accesses = self._cache_bundle(
                self._fnrec[inst.fn][_F_BASE], cold)
            durs = self._cache_access(inst.fn,
                                      self._fnrec[inst.fn][_F_BASE],
                                      t_arr, accesses, tmpl[2])
            node = self.nodes[inst.node]
            frun = _FaultedRun(prog, tmpl, node, inst, inst.fn, t_arr)
            frun.durs = durs
            self.put_ledger.setdefault(frun.key, set())
            self._live.append(frun)
            for c in tmpl[6]:              # root codes: zero-indegree
                self._f_start(frun, c)
            return
        rec = self._fnrec[inst.fn]
        bundle = rec[_F_COLD] if cold else rec[_F_WARM]
        if bundle is None:
            bundle = self._program(rec[_F_BASE], cold)
            rec[_F_COLD if cold else _F_WARM] = bundle
        prog, tmpl = bundle
        node = self.nodes[inst.node]
        frun = _FaultedRun(prog, tmpl, node, inst, inst.fn, t_arr)
        self.put_ledger.setdefault(frun.key, set())
        self._live.append(frun)
        for c in tmpl[6]:                  # root codes: zero-indegree
            self._f_start(frun, c)

    def _f_start(self, frun: "_FaultedRun", code: int) -> None:
        """Phase became ready (mirror of `_start` + fault gates).
        `code` is the static phase code; the current attempt is stamped
        into every scheduled event, so aborts invalidate lazily."""
        loop = self.loop
        now = loop.now
        pi = code & _PI_MASK
        prog = frun.prog
        sched = self._faults
        op = frun.ops[pi]
        d = frun.durs[pi]
        if op == _OP_SLOT:
            gid = prog.bgroup_of[pi]
            if gid in frun.slots_held:
                # a re-driven group whose slot survived the fault (TCP
                # holds it to the wire's end): skip the re-acquire
                ev = code | (frun.attempt[pi] << _ATT_SHIFT)
                loop.defer(self._f_exec, frun, ev | _EXEC)
                return
            gate = self._outage_until if now < self._outage_until else 0.0
            if sched.specs:
                w = sched.window_at(FA.ARENA_EXHAUST, now)
                if w is not None:
                    # no slot allocatable: stall until reclaim (the
                    # threaded analogue is `TenantArena.alloc_wait`)
                    self.fault_stats["alloc_stalls"] += 1
                    gate = max(gate, w[1])
            if gate > now:
                loop.at(gate, self._f_start_cb, frun, code)
                return
        elif sched.specs and d > 0.0:
            if pi == prog.restore_idx:
                if sched.window_at(FA.RESTORE_FAIL, now) is not None:
                    # the failed attempt costs a full extra restore
                    self.fault_stats["restore_retries"] += 1
                    self.acct.charge(M.HOST_KERNEL,
                                     d * F.GHZ_MCYC_PER_S)
                    self.acct.cross(M.RETRY)
                    d = 2.0 * d
            elif prog.fabric[pi] and not prog.on_core[pi]:
                if sched.window_at(FA.STORAGE_ERROR, now) is not None:
                    self._f_storage_retry(frun, pi, now)
                    return
                w = sched.window_at(FA.STORAGE_SLOW, now)
                if w is not None:
                    d *= w[2]
        ev = code | (frun.attempt[pi] << _ATT_SHIFT)
        if op == _OP_CORE:
            state = frun.cpu
            if state[0] < state[1]:
                state[0] += 1
                end = now + d
                hz = self._horizon
                state[2] += d if end <= hz else hz - now
                frun.inflight[pi] = 1          # running on a core
                loop.at(end, self._f_done, frun, ev | _CORE)
            else:
                frun.inflight[pi] = 3          # queued for a core
                frun.cpu_wait.append((frun, ev))
        elif op == _OP_WIRE or op == _OP_CACHE:
            frun.inflight[pi] = 2              # on the wire (a cache
            loop.at(now + d, self._f_done, frun, ev)   # hit: short wire)
        elif op == _OP_SLOT:
            state = frun.be
            if state[0] < state[1]:
                state[0] += 1
                frun.slots_held.add(prog.bgroup_of[pi])
                loop.defer(self._f_exec, frun, ev | _EXEC)
            else:
                frun.inflight[pi] = 4          # queued for a daemon slot
                frun.be_wait.append((frun, ev))
        else:                                  # zero duration
            loop.defer(self._f_done, frun, ev)

    def _f_start_cb(self, frun: "_FaultedRun", code: int) -> None:
        """Deferred/re-driven start (outage end, retry, window end)."""
        if not frun.dead:
            self._f_start(frun, code)

    def _f_exec(self, frun: "_FaultedRun", ev: int) -> None:
        """Backend slot granted (mirror of `_hot`'s EXEC block)."""
        pi = ev & _PI_MASK
        if (ev >> _ATT_SHIFT) != frun.attempt[pi]:
            return                             # aborted between grant+run
        loop = self.loop
        now = loop.now
        op = frun.ops2[pi]
        d = frun.durs[pi]
        ev ^= _EXEC
        if op == _OP_CORE:
            state = frun.cpu
            if state[0] < state[1]:
                state[0] += 1
                end = now + d
                hz = self._horizon
                state[2] += d if end <= hz else hz - now
                frun.inflight[pi] = 1
                loop.at(end, self._f_done, frun, ev | _CORE)
            else:
                frun.inflight[pi] = 3
                frun.cpu_wait.append((frun, ev))
        elif op == _OP_WIRE or op == _OP_CACHE:
            frun.inflight[pi] = 2
            loop.at(now + d, self._f_done, frun, ev)
        else:
            loop.defer(self._f_done, frun, ev)

    def _f_done(self, frun: "_FaultedRun", ev: int) -> None:
        """Phase completion (mirror of `_hot`'s done block + ledgers)."""
        pi = ev & _PI_MASK
        if (ev >> _ATT_SHIFT) != frun.attempt[pi]:
            return                             # stale: attempt aborted
        loop = self.loop
        now = loop.now
        prog = frun.prog
        sched = self._faults
        frun.inflight.pop(pi, None)
        if ev & _CORE:
            self._f_core_release(frun)
        if ev & _SLOTREL:
            gid = prog.bgroup_of[pi]
            if gid in frun.slots_held:
                frun.slots_held.discard(gid)
                self._f_slot_release(frun)
        po = prog.put_ordinal[pi]
        if po >= 0 and not frun.dead:
            if po not in frun.delivered:
                frun.delivered.add(po)
                self.put_ledger[frun.key].add(po)
                if sched.specs and pi not in frun.acked \
                        and sched.window_at(FA.ACK_DROP, now) is not None:
                    # the write IS durable; only its ack died. The
                    # frontend times out and re-drives; the idempotency
                    # record resolves the retry — barriers (and the
                    # caller's response) wait out the redrive.
                    frun.acked.add(pi)
                    self.fault_stats["delayed_acks"] += 1
                    self.acct.charge(M.HOST_USER, FA.RETRY_OVERHEAD_MCYC)
                    self.acct.cross(M.RETRY)
                    loop.at(now + sched.ack_retry_s, self._f_done, frun,
                            ev & ~(_SLOTREL | _CORE))
                    return
        if ev & _RELB and not frun.dead:
            self._release(frun.inst)
        if ev & _RESPB and not frun.dead:
            if frun.t_arr >= self.warmup_s:
                self.latencies[frun.fn].append(now - frun.t_arr)
            self.completed += 1
            self.responses[frun.key] = self.responses.get(frun.key, 0) + 1
            frun.dead = True                   # terminal: reply is last
            try:
                self._live.remove(frun)
            except ValueError:
                pass
        need = frun.need
        for sc in frun.succ[pi]:
            si = sc & _PI_MASK
            n = need[si] - 1
            need[si] = n
            if n == 0:
                self._f_start(frun, sc)

    def _f_core_release(self, frun: "_FaultedRun") -> None:
        """Free a node core; grant the oldest *live* waiter (mirror of
        `_hot`'s CORE block — stale queued entries are skipped without
        consuming the core)."""
        state = frun.cpu
        state[0] -= 1
        wait = frun.cpu_wait
        loop = self.loop
        while wait:
            run2, ev2 = wait.popleft()
            pi2 = ev2 & _PI_MASK
            if (ev2 >> _ATT_SHIFT) != run2.attempt[pi2]:
                continue
            state[0] += 1
            d2 = run2.durs[pi2]
            now = loop.now
            end = now + d2
            hz = self._horizon
            state[2] += d2 if end <= hz else hz - now
            run2.inflight[pi2] = 1
            loop.at(end, self._f_done, run2, ev2 | _CORE)
            return

    def _f_slot_release(self, frun: "_FaultedRun") -> None:
        """Free a daemon connection-pool slot; grant the oldest live
        waiter. During a crash outage the grant is *held back* to the
        restart instant — the daemon must exist to accept work."""
        state = frun.be
        state[0] -= 1
        wait = frun.be_wait
        loop = self.loop
        while wait:
            run2, ev2 = wait.popleft()
            pi2 = ev2 & _PI_MASK
            if (ev2 >> _ATT_SHIFT) != run2.attempt[pi2]:
                continue
            state[0] += 1
            run2.slots_held.add(run2.prog.bgroup_of[pi2])
            run2.inflight.pop(pi2, None)
            if loop.now < self._outage_until:
                loop.at(self._outage_until, self._f_exec, run2,
                        ev2 | _EXEC)
            else:
                loop.defer(self._f_exec, run2, ev2 | _EXEC)
            return

    def _f_storage_retry(self, frun: "_FaultedRun", pi: int,
                         now: float) -> None:
        """A wire transfer hit a storage-error window: the frontend
        re-drives the whole fetch/write group from its head once the
        window clears (idempotent; §5), charging the redo work."""
        sched = self._faults
        prog = frun.prog
        w = sched.window_at(FA.STORAGE_ERROR, now)
        t_retry = max(w[1] if w is not None else now,
                      now + sched.retry_backoff_s)
        self.fault_stats["storage_retries"] += 1
        gid = prog.bgroup_of[pi]
        domain = M.HOST_USER if self.spec.offload_sdk else M.GUEST_USER
        if gid >= 0:
            head = prog.bgroup_head[pi]
            redo = self._f_reset_group(frun, gid, free_cores=False)
            self.acct.charge(domain,
                             redo * F.GHZ_MCYC_PER_S
                             + FA.RETRY_OVERHEAD_MCYC)
            self.acct.cross(M.RETRY)
            self.loop.at(t_retry, self._f_start_cb, frun,
                         frun.codes[head])
        else:
            self.acct.charge(domain, FA.RETRY_OVERHEAD_MCYC)
            self.acct.cross(M.RETRY)
            self.loop.at(t_retry, self._f_start_cb, frun, frun.codes[pi])

    def _f_reset_group(self, frun: "_FaultedRun", gid: int, *,
                       free_cores: bool) -> float:
        """Invalidate a backend group's current attempt and rewind its
        intra-group countdowns so the head can re-drive the chain.
        Returns the group's on-core redo seconds (the retry work the
        books charge). Members' extra-group deps completed before the
        group ever ran — compiled chains only re-fire in-group edges."""
        prog = frun.prog
        members = prog.bgroup_members[gid]
        head = members[0]
        redo = 0.0
        for m in members:
            kind = frun.inflight.pop(m, None)
            frun.attempt[m] += 1
            if kind == 1 and free_cores:       # was running on a core
                self._f_core_release(frun)
            if m != head:
                frun.need[m] = frun.intra[m]
            if prog.on_core[m]:
                redo += frun.durs[m]
        return redo

    def _crash_cb(self, _a=None, _b=None) -> None:
        """A `backend_crash` FaultSpec fires (scheduled by `run`)."""
        sched = self._faults
        loop = self.loop
        now = loop.now
        self.fault_stats["crashes"] += 1
        if self._guard is not None and self._guard.breaker is not None:
            # GuardRails: the crash signal opens the circuit breaker —
            # arrivals during the open window shed instead of piling
            # onto the restarting daemon
            self._guard.breaker.on_crash()
        if self.spec.offload_sdk:
            # crash-only shared daemon: abort every in-flight backend
            # group; re-drive each from its head behind the restart
            self._outage_until = max(self._outage_until,
                                     now + sched.restart_delay_s)
            for frun in list(self._live):
                prog = frun.prog
                gids = sorted({prog.bgroup_of[pi]
                               for pi in frun.inflight
                               if prog.bgroup_of[pi] >= 0})
                for gid in gids:
                    redo = self._f_reset_group(frun, gid, free_cores=True)
                    if gid in frun.slots_held:
                        # the daemon's pool died with it; the re-drive
                        # re-acquires once the fresh daemon is up
                        frun.slots_held.discard(gid)
                        self._f_slot_release(frun)
                    self.fault_stats["aborted_groups"] += 1
                    self.acct.charge(M.HOST_USER,
                                     redo * F.GHZ_MCYC_PER_S
                                     + FA.RETRY_OVERHEAD_MCYC)
                    self.acct.cross(M.RETRY)
                    head = prog.bgroup_members[gid][0]
                    loop.at(self._outage_until, self._f_start_cb, frun,
                            frun.codes[head])
        else:
            # coupled design: the fabric crashed inside the guest — any
            # invocation mid-fabric-op dies whole and re-arrives
            t_retry = now + sched.restart_delay_s
            for frun in list(self._live):
                prog = frun.prog
                if not any(prog.fabric[pi] for pi in frun.inflight):
                    continue
                running_cores = sum(1 for k in frun.inflight.values()
                                    if k == 1)
                # blanket invalidation FIRST: pending events (zero-delay
                # completions, queued grants) must not fire on the
                # corpse, and the freed cores below must not be granted
                # back to it
                for i in range(len(frun.attempt)):
                    frun.attempt[i] += 1
                frun.inflight.clear()
                for _ in range(running_cores):
                    self._f_core_release(frun)
                frun.dead = True
                self._live.remove(frun)
                inst = frun.inst
                node = self.nodes[inst.node]
                node.mem_used -= inst.rss_mb
                node.vms -= 1
                inst.state = "dead"
                self.fault_stats["killed_invocations"] += 1
                redo = sum(frun.durs[i]
                           for i in range(len(frun.attempt))
                           if prog.on_core[i])
                self.acct.charge(M.GUEST_USER,
                                 redo * F.GHZ_MCYC_PER_S
                                 + FA.RETRY_OVERHEAD_MCYC)
                self.acct.cross(M.RETRY)
                loop.at(t_retry, self._f_rearrive, frun.fn, frun.t_arr)

    def _f_rearrive(self, fn: str, t_arr: float) -> None:
        """Caller re-drives a killed invocation from scratch; latency
        keeps accruing from the ORIGINAL arrival (the caller saw one
        long invocation, not two)."""
        idle = self.idle[fn]
        if idle:
            inst = idle.pop()
            inst.state = "busy"
            inst.expire_seq += 1
            self._execute_faulted(inst, t_arr, cold=False)
            return
        inst = self._spawn(fn)
        if inst is None:
            self.backlog[fn].append(t_arr)
            return
        inst.state = "busy"
        self._execute_faulted(inst, t_arr, cold=True)

    # ---------------------------------------------------------------- run

    def _arm(self, until: float, feed: bool = True) -> None:
        """Schedule everything a run needs before the loop is driven:
        the arrival stream (unless `feed=False` — an external frontend
        owns it), fault crash events, and the memory sampler. Split out
        of `run()` so a ClusterSimulator can arm each member on one
        shared loop and drive them together."""
        faulted = self._faults is not None
        if self.engine != "legacy":
            # batched arrivals: one time-sorted stream, fed to the loop
            # outside the heap (stable merge keeps the per-function
            # scheduling order on exact time ties, like the heap did)
            self._horizon = until
            if feed:
                self.loop.feed(merge_streams(self.arrivals), self._arrive)
        else:                              # pre-refactor path: heap-load
            if faulted:
                self._horizon = until
            for fn, times in self.arrivals.items():
                for t in times:
                    self.loop.at(t, self._arrive, fn)
        if faulted:
            # crash events enter the heap as generic callbacks — after
            # the arrivals, so exact-time ties resolve arrival-first on
            # both engines (the feed's tie rule)
            for t in self._faults.crashes():
                self.loop.at(t, self._crash_cb)

        # memory sampling
        def sample(_a=None, _b=None):
            used = sum(n.mem_used for n in self.nodes)
            cap = sum(n.mem_cap for n in self.nodes)
            self.mem_samples.append(used / cap)
            if self.loop.now < self.duration_s - 1.0:
                self.loop.after(1.0, sample)
        self.loop.after(self.warmup_s, sample)

    def run(self) -> SimResult:
        until = self.duration_s + 30.0          # drain tail
        faulted = self._faults is not None
        self._arm(until)
        if faulted or self._guard is not None \
                or self.engine in ("legacy", "calendar"):
            # the faulted interpreter is event-driven on every engine,
            # guarded runs need the `_arrive` admission seam (the fused
            # loop inlines arrivals), and the calendar engine exercises
            # the method-dispatch loop (`EventLoop._run_cal`); only
            # fault-free unguarded classic/hot runs take the fused loop
            self.loop.run(until)
        else:
            self._run_hot(until)
        return self.collect()

    def collect(self) -> SimResult:
        """Assemble the SimResult from post-run state (the tail of
        `run()`, callable on its own by an external driver)."""
        faulted = self._faults is not None
        horizon = self.duration_s + 30.0
        if self.engine != "legacy" or faulted:
            # granted core-time clipped at the horizon (see `_start`)
            cpu_busy = sum(n.cpu_hot[2] for n in self.nodes)
        else:
            cpu_busy = sum(n.cpu.busy_integral for n in self.nodes)
        cpu_util = cpu_busy / sum(n.cpu.cores for n in self.nodes) / horizon
        mem_util = (sum(self.mem_samples) / len(self.mem_samples)
                    if self.mem_samples else 0.0)
        unloaded = {f: self.unloaded_latency(f) for f in self.functions}
        # GuardRails accounting: goodput = measured-window completions
        # (arrivals past warmup, same population as the latency
        # streams) inside their class deadline — all of them when no
        # deadline is set. Derived post-hoc from the latency streams,
        # so the hot-path completion sites stay untouched.
        guarded = self._guard is not None
        goodput = slo_bad = 0
        if guarded:
            for f, xs in self.latencies.items():
                dl = self._guard.deadline_for(self._base[f], unloaded[f])
                if dl is None:
                    goodput += len(xs)
                    continue
                bad = sum(1 for x in xs if x > dl)
                slo_bad += bad
                goodput += len(xs) - bad
            self._guard.slo_violations = slo_bad
        return SimResult(
            system=self.spec.name, n_functions=self.n_functions,
            latencies={f: v for f, v in self.latencies.items() if v},
            unloaded=unloaded,
            cpu_util=cpu_util, mem_util=mem_util,
            cold_starts=self.cold_starts, completed=self.completed,
            rejected=self.rejected,
            fault_stats=dict(self.fault_stats) if faulted else None,
            retry_cycles=self.acct.snapshot() if faulted else None,
            put_ledger=dict(self.put_ledger) if faulted else None,
            responses=dict(self.responses) if faulted else None,
            goodput=goodput, slo_violations=slo_bad,
            queued=self._guard.queued if guarded else 0,
            shed=dict(self.shed) if guarded else None,
            rejections=dict(self.rejections) if guarded else None,
            cache_stats=(self._cache.snapshot()
                         if self._cache is not None else None))


def find_density(system: str, *, lo: int = 20, hi: int = 800,
                 step: int = 20, slo: float = 5.0, seed: int = 0,
                 refine_to: int = 1, fast: bool = False,
                 **kw) -> tuple[int, list[SimResult]]:
    """Max deployed-function count meeting the SLO, plus every probe.

    Coarse upward sweep in `step` increments until the first SLO
    failure, then binary search between the last pass and the first
    fail down to `refine_to` granularity — the reported density is no
    longer quantized to `step`.

    With ``fast=True`` the fluid model (`repro_torch.core.fluid`) predicts
    the failing grid point, and the exact engine only walks from there
    to the true pass/fail boundary before running the identical binary
    refinement. The returned density equals the exact search's
    whenever pass/fail is monotone along the grid — the assumption the
    coarse sweep itself rests on — while running ~5x fewer exact
    probes (``len(results)`` counts them).
    """
    results: list[SimResult] = []

    def probe(n: int) -> SimResult:
        r = DensitySimulator(system, n, seed=seed, **kw).run()
        results.append(r)
        return r

    best = 0
    first_fail = None
    if fast:
        from repro_torch.core.fluid import fluid_first_fail
        est = fluid_first_fail(system, lo=lo, hi=hi, step=step,
                               slo=slo, seed=seed, **kw)
        last = lo + ((hi - lo) // step) * step
        g = min(max(est if est is not None else last, lo), last)
        if probe(g).meets_slo(slo):
            best = g
            n = g + step           # walk up to the first failure
            while n <= hi:
                if probe(n).meets_slo(slo):
                    best = n
                    n += step
                else:
                    first_fail = n
                    break
        else:
            first_fail = g
            n = g - step           # walk down to the last pass
            while n >= lo:
                if probe(n).meets_slo(slo):
                    best = n
                    break
                first_fail = n
                n -= step
    else:
        n = lo
        while n <= hi:
            if probe(n).meets_slo(slo):
                best = n
                n += step
            else:
                first_fail = n
                break

    if first_fail is not None:
        lo_b, hi_b = best, first_fail
        gran = max(refine_to, 1)
        while hi_b - lo_b > gran:
            mid = (lo_b + hi_b) // 2
            if probe(mid).meets_slo(slo):
                best, lo_b = mid, mid
            else:
                hi_b = mid
    return best, results
