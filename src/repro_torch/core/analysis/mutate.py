"""Seeded corruptor: deliberate damage classes for mutation-testing
PlanVerify.

A verifier is only as trustworthy as the bugs it has been shown to
catch. Each `Corruption` here applies one well-typed class of damage
to a compiled `PlanProgram` (or to its source `PhasePlan`, re-lowering
afterwards) while keeping every *other* invariant intact, so the test
suite can assert that `verify.verify_program` rejects it with exactly
the expected diagnostic code — no silent passes, no masking by an
earlier check.

Program-level damage uses ``dataclasses.replace`` plus `_relink`,
which rebuilds ``succ``/``succ_flat``/``succ_off``/``indegree``/
``roots`` consistently from a tampered ``pred`` so that only the
targeted invariant trips. Plan-level damage builds a mutated
`PhasePlan` (construction-time validation still passes — these are
exactly the defects validation alone cannot see) and re-lowers it.

A corruption raises `Ineligible` when the given program lacks the
feature it damages (e.g. no backend groups under a coupled variant);
the test matrix picks an eligible config per class.

A copy of ``repro.core.analysis.mutate``, whole, over the port's
``plan``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, replace
from typing import Callable

from repro_torch.core.plan import (
    SYSTEMS,
    Phase,
    PhasePlan,
    PlanProgram,
    lower_program,
)

from . import diag


class Ineligible(Exception):
    """This program lacks the feature this corruption damages."""


Durations = tuple[float, ...]
Mutated = tuple[PlanProgram, Durations]


@dataclass(frozen=True)
class Corruption:
    name: str
    code: str                    # the diagnostic verify must raise
    doc: str
    fn: Callable[[PlanProgram, Durations, random.Random], Mutated]


def _relink(prog: PlanProgram, pred: list[tuple[int, ...]]) -> PlanProgram:
    """Rebuild every edge-derived array from a tampered ``pred`` so the
    program stays *internally* consistent — only cross-checks against
    the plan (or the explicit target) should fire."""
    n = len(prog.names)
    succ: list[list[int]] = [[] for _ in range(n)]
    for i, ps in enumerate(pred):
        for p in ps:
            succ[p].append(i)
    succ_t = tuple(tuple(s) for s in succ)
    flat: list[int] = []
    off = [0]
    for row in succ_t:
        flat.extend(row)
        off.append(len(flat))
    return replace(
        prog,
        pred=tuple(tuple(ps) for ps in pred),
        succ=succ_t,
        succ_flat=tuple(flat),
        succ_off=tuple(off),
        indegree=tuple(len(ps) for ps in pred),
        roots=tuple(i for i in range(n) if not pred[i]),
    )


def _replan(plan: PhasePlan, new_after: dict[str, tuple[str, ...]],
            **barriers) -> PhasePlan:
    """A copy of ``plan`` with selected phases' dependency sets (and
    optionally the barriers) replaced; construction re-validates."""
    phases = tuple(
        Phase(p.name, p.resource, new_after.get(p.name, p.after),
              p.backend_group)
        for p in plan.phases)
    return PhasePlan(
        system=plan.system, cold=plan.cold, phases=phases,
        release_after=barriers.get("release_after", plan.release_after),
        respond_after=barriers.get("respond_after", plan.respond_after))


def _spec(prog: PlanProgram):
    spec = SYSTEMS.get(prog.plan.system)
    if spec is None:
        raise Ineligible(f"unknown system {prog.plan.system!r}")
    return spec


# ------------------------------------------------------- damage classes


def _cycle_edge(prog, durs, rng):
    n = len(prog.names)
    pred = [list(p) for p in prog.pred]
    pred[0].append(n - 1)               # reply -> restore: a back edge
    return _relink(prog, [tuple(p) for p in pred]), durs


def _succ_row_tamper(prog, durs, rng):
    n = len(prog.names)
    for i in rng.sample(range(n), n):
        row = prog.succ[i]
        spare = [j for j in range(i + 1, n) if j not in row]
        if row and spare:
            new_row = (rng.choice(spare),) + row[1:]
            succ = list(prog.succ)
            succ[i] = new_row
            flat: list[int] = []
            off = [0]
            for r in succ:
                flat.extend(r)
                off.append(len(flat))
            return replace(prog, succ=tuple(succ),
                           succ_flat=tuple(flat),
                           succ_off=tuple(off)), durs
    raise Ineligible("no successor row can be retargeted")


def _csr_off_by_one(prog, durs, rng):
    if not prog.succ_flat:
        raise Ineligible("program has no edges")
    off = (0,) + tuple(o + 1 for o in prog.succ_off[1:])
    return replace(prog, succ_off=off), durs


def _stale_indegree(prog, durs, rng):
    i = rng.choice([j for j in range(len(prog.names))])
    deg = list(prog.indegree)
    deg[i] += 1
    return replace(prog, indegree=tuple(deg)), durs


def _roots_drop(prog, durs, rng):
    if len(prog.roots) < 2:
        raise Ineligible("single-root program")
    keep = list(prog.roots)
    keep.remove(rng.choice(keep))
    return replace(prog, roots=tuple(keep)), durs


def _edge_delete(prog, durs, rng):
    edges = [(p, i) for i in range(len(prog.names))
             for p in prog.pred[i]]
    if not edges:
        raise Ineligible("program has no edges")
    p, i = edges[rng.randrange(len(edges))]
    pred = [list(ps) for ps in prog.pred]
    pred[i].remove(p)
    return _relink(prog, [tuple(ps) for ps in pred]), durs


def _tred_redundant_edge(prog, durs, rng):
    plan = prog.plan
    for p in plan.phases:
        for d in p.after:
            for a in sorted(plan.ancestors(d)):
                if a not in p.after:
                    mutated = _replan(plan, {p.name: p.after + (a,)})
                    return lower_program(
                        mutated, prog.kernel_bypass), durs
    raise Ineligible("no transitively-implied edge can be added")


def _slot_release_clear(prog, durs, rng):
    if not any(prog.releases_slot):
        raise Ineligible("no backend groups (coupled variant)")
    rel = list(prog.releases_slot)
    rel[rel.index(True)] = False
    return replace(prog, releases_slot=tuple(rel)), durs


def _slot_acquire_shift(prog, durs, rng):
    for members in prog.bgroup_members:
        if len(members) >= 2:
            acq = list(prog.acquires_slot)
            acq[members[0]] = False
            acq[members[1]] = True
            return replace(prog, acquires_slot=tuple(acq)), durs
    raise Ineligible("no multi-member backend group")


def _slot_release_misplaced(prog, durs, rng):
    for members in prog.bgroup_members:
        rel_at = [i for i in members if prog.releases_slot[i]]
        others = [i for i in members if i not in rel_at]
        if rel_at and others:
            rel = list(prog.releases_slot)
            rel[rel_at[0]] = False
            rel[rng.choice(others)] = True
            return replace(prog, releases_slot=tuple(rel)), durs
    raise Ineligible("no multi-member backend group")


def _barriers_swapped(prog, durs, rng):
    if prog.release_idx == prog.respond_idx:
        raise Ineligible("release and respond coincide (sync plan)")
    return replace(prog, release_idx=prog.respond_idx,
                   respond_idx=prog.release_idx), durs


def _respond_skips_put(prog, durs, rng):
    if not _spec(prog).async_writeback:
        raise Ineligible("sync variant: PUTs gate the reply transitively")
    plan = prog.plan
    reply = plan.phases[-1]
    nets = [d for d in reply.after if d.startswith("write_net")]
    if not nets:
        raise Ineligible("reply lists no direct durable PUT")
    dropped = rng.choice(nets)
    mutated = _replan(plan, {
        reply.name: tuple(d for d in reply.after if d != dropped)})
    return lower_program(mutated, prog.kernel_bypass), durs


def _release_before_restore(prog, durs, rng):
    if not _spec(prog).async_writeback:
        raise Ineligible("sync variant releases at the reply")
    plan = prog.plan
    for i, nm in enumerate(prog.names):
        if i != prog.respond_idx and "restore" not in plan.ancestors(nm) \
                and nm != "restore":
            return replace(prog, release_idx=i), durs
    raise Ineligible("every candidate phase postdates the restore")


def _async_blocking_write(prog, durs, rng):
    if not _spec(prog).async_writeback:
        raise Ineligible("variant has no floating write-back")
    plan = prog.plan
    order = {p.name: i for i, p in enumerate(plan.phases)}
    for p in plan.phases:
        if not p.name.startswith("write_net"):
            continue
        w = p.name
        later_compute = next(
            (q for q in plan.phases
             if q.name.startswith("compute") and order[q.name] > order[w]),
            None)
        if later_compute is None:
            continue
        # Chain the guest's next compute behind the write ack; deps now
        # implied through the write chain are dropped so only the
        # async-float invariant — not transitive reduction — trips.
        w_anc = plan.ancestors(w)
        new_after = {later_compute.name: (w,) + tuple(
            d for d in later_compute.after
            if d not in w_anc and d != w)}
        reply = plan.phases[-1]
        if w in reply.after:
            new_after[reply.name] = tuple(d for d in reply.after if d != w)
        mutated = _replan(plan, new_after)
        return lower_program(mutated, prog.kernel_bypass), durs
    raise Ineligible("no compute segment follows a durable PUT")


def _fabric_mask_flip(prog, durs, rng):
    i = rng.randrange(len(prog.names))
    fab = list(prog.fabric)
    fab[i] = not fab[i]
    return replace(prog, fabric=tuple(fab)), durs


def _bgroup_head_shift(prog, durs, rng):
    for o, members in enumerate(prog.bgroup_members):
        if len(members) >= 2:
            head = list(prog.bgroup_head)
            for i in members:
                head[i] = members[1]
            return replace(prog, bgroup_head=tuple(head)), durs
    raise Ineligible("no multi-member backend group")


def _put_ordinal_wrong(prog, durs, rng):
    puts = [i for i, o in enumerate(prog.put_ordinal) if o >= 0]
    if not puts:
        raise Ineligible("profile has no durable PUT")
    ords = list(prog.put_ordinal)
    if len(puts) >= 2:
        a, b = puts[0], puts[-1]
        ords[a], ords[b] = ords[b], ords[a]
    else:
        ords[puts[0]] += 1
    return replace(prog, put_ordinal=tuple(ords)), durs


def _restore_idx_wrong(prog, durs, rng):
    return replace(prog, restore_idx=prog.restore_idx + 1), durs


def _group_succ_tamper(prog, durs, rng):
    gs = [list(row) for row in prog.group_succ]
    for i, row in enumerate(gs):
        spare = [j for j in range(len(gs)) if j != i and j not in row]
        if spare:
            gs[i] = sorted(row + [rng.choice(spare)])
            return replace(
                prog, group_succ=tuple(tuple(r) for r in gs)), durs
    raise Ineligible("group DAG is complete")


def _duration_truncated(prog, durs, rng):
    if not durs:
        raise Ineligible("no duration vector supplied")
    return prog, durs[:-1]


CORRUPTIONS: tuple[Corruption, ...] = (
    Corruption("cycle_edge", diag.V_TOPO,
               "back edge reply->restore creates a cycle", _cycle_edge),
    Corruption("succ_row_tamper", diag.V_EDGE,
               "a successor row points at a phase whose pred disagrees",
               _succ_row_tamper),
    Corruption("csr_off_by_one", diag.V_CSR,
               "CSR offsets shifted by one against succ_flat",
               _csr_off_by_one),
    Corruption("stale_indegree", diag.V_INDEGREE,
               "an indegree entry disagrees with the pred list",
               _stale_indegree),
    Corruption("roots_drop", diag.V_ROOTS,
               "a zero-indegree phase is missing from roots",
               _roots_drop),
    Corruption("edge_delete", diag.V_XEDGE,
               "an edge removed consistently from every program array "
               "(only the plan cross-check can see it)", _edge_delete),
    Corruption("tred_redundant_edge", diag.V_TRED,
               "a transitively-implied edge added to the plan",
               _tred_redundant_edge),
    Corruption("slot_release_clear", diag.V_SLOT,
               "a backend group never releases its pool slot",
               _slot_release_clear),
    Corruption("slot_acquire_shift", diag.V_SLOT_HEAD,
               "a slot acquired mid-group instead of at the head",
               _slot_acquire_shift),
    Corruption("slot_release_misplaced", diag.V_SLOT_REL,
               "a slot released at a member that violates the "
               "transport's kernel-bypass rule", _slot_release_misplaced),
    Corruption("barriers_swapped", diag.V_BARRIER_RESPOND,
               "release_idx and respond_idx exchanged",
               _barriers_swapped),
    Corruption("respond_skips_put", diag.V_BARRIER_PUTGATE,
               "the reply no longer gates on a durable PUT",
               _respond_skips_put),
    Corruption("release_before_restore", diag.V_BARRIER_RELEASE,
               "the instance releases at a phase that does not "
               "postdate the restore", _release_before_restore),
    Corruption("async_blocking_write", diag.V_BARRIER_ASYNC,
               "an async write-back chained in front of a guest "
               "compute segment", _async_blocking_write),
    Corruption("fabric_mask_flip", diag.V_FABRIC,
               "a phase's fabric (crash blast radius) bit flipped",
               _fabric_mask_flip),
    Corruption("bgroup_head_shift", diag.V_BGROUP,
               "crash recovery would re-drive a group from a "
               "non-head member", _bgroup_head_shift),
    Corruption("put_ordinal_wrong", diag.V_PUTORD,
               "logical PUT ordinals swapped/shifted against the "
               "exactly-once ledger", _put_ordinal_wrong),
    Corruption("restore_idx_wrong", diag.V_RESTORE,
               "restore_idx points past the restore phase",
               _restore_idx_wrong),
    Corruption("group_succ_tamper", diag.V_GROUPS,
               "a breakdown-group successor row gains a phantom edge",
               _group_succ_tamper),
    Corruption("duration_truncated", diag.V_DUR,
               "duration vector shorter than the phase list",
               _duration_truncated),
)

BY_NAME = {c.name: c for c in CORRUPTIONS}


def corrupt(program: PlanProgram, durations: Durations,
            name: str, seed: int = 0) -> Mutated:
    """Apply one named damage class (seeded) and return the mutated
    (program, durations) pair to feed `verify.verify_program`."""
    return BY_NAME[name].fn(program, durations, random.Random(seed))
