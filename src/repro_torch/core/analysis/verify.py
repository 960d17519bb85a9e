"""PlanVerify: full invariant checker for PhasePlan/PlanProgram pairs.

`plan.lower_program` compiles the authoring DAG (named phases, string
edges) into the flat integer arrays both executors actually run — CSR
successor lists, indegree countdowns, slot acquire/release masks,
barrier indices, fault-lowering geometry. Until now the only evidence
those arrays were mutually consistent was that the executors didn't
crash. This module re-derives every structural property independently
and raises a typed `PlanCheckError` on the first violation, in a fixed
check order so each corruption class maps to a distinct diagnostic
(the mutation suite in ``tests/test_plancheck.py`` pins that mapping):

1.  plan structure (`V-PLAN`) and transitive reduction (`V-TRED`);
2.  program ↔ plan name agreement (`V-XNAME`);
3.  topological index order / acyclicity (`V-TOPO`), pred/succ edge
    symmetry (`V-EDGE`), CSR layout (`V-CSR`), indegree (`V-INDEGREE`),
    roots (`V-ROOTS`);
4.  program ↔ plan edge set (`V-XEDGE`) and core mask (`V-XCORE`);
5.  slot balance per backend group under the transport's
    kernel-bypass rule (`V-SLOT-HEAD` / `V-SLOT` / `V-SLOT-REL`);
6.  barrier legality (`V-BARRIER-RESPOND` / `-PUTGATE` / `-RELEASE` /
    `-ASYNC`);
7.  fault lowering (`V-FABRIC` / `V-BGROUP` / `V-PUTORD` /
    `V-RESTORE`);
8.  breakdown-group arrays (`V-GROUPS`) and, when a duration vector is
    supplied, its alignment (`V-DUR`);
9.  SharedCache opcode overlays, when one is supplied to
    `verify_cache_overlay` (`V-CACHE-OP` / `V-CACHE-WIRE` /
    `V-CACHE-COVER`).

A copy of ``repro.core.analysis.verify``, whole. The reference's
`verify_cache_overlay` reads the DES's wire and cache opcodes from
``repro.core.des``; the port has no DES yet, so it keeps its own copy of
the two constants (`_OP_WIRE`, `_OP_CACHE`) at the DES's values, and
nothing in the port builds an overlay for it to check yet.
"""
from __future__ import annotations

from repro_torch.core.plan import (
    BACKEND_WORKER,
    GUEST_CORE,
    RESOURCES,
    SYSTEMS,
    PhasePlan,
    PlanProgram,
    cache_vector,
    phase_group,
)
from repro_torch.core.workloads import Get, IOProfile, Put

from .diag import (
    V_BARRIER_ASYNC,
    V_BARRIER_PUTGATE,
    V_BARRIER_RELEASE,
    V_BARRIER_RESPOND,
    V_BGROUP,
    V_CACHE_COVER,
    V_CACHE_OP,
    V_CACHE_WIRE,
    V_CSR,
    V_DUR,
    V_EDGE,
    V_FABRIC,
    V_GROUPS,
    V_INDEGREE,
    V_PLAN,
    V_PUTORD,
    V_RESTORE,
    V_ROOTS,
    V_SLOT,
    V_SLOT_HEAD,
    V_SLOT_REL,
    V_TOPO,
    V_TRED,
    V_XCORE,
    V_XEDGE,
    V_XNAME,
    PlanCheckError,
)

_FABRIC_BASES = ("fetch_cpu", "fetch_net", "write_cpu", "write_net")

#: the DES's phase opcodes a SharedCache overlay patches: the wire
#: opcode of a GET's ``fetch_net`` becomes the cache opcode
_OP_WIRE = 3       # timed, pure latency
_OP_CACHE = 4      # timed, pure latency, SharedCache-eligible GET wire


def _fail(code: str, subject: str, msg: str) -> None:
    raise PlanCheckError(code, msg, subject=subject)


def verify_plan(plan: PhasePlan, *, subject: str | None = None) -> None:
    """Structural invariants of the authoring DAG itself."""
    who = subject or f"{plan.system}/{'cold' if plan.cold else 'warm'}"

    seen: set[str] = set()
    for p in plan.phases:
        if p.name in seen:
            _fail(V_PLAN, who, f"duplicate phase {p.name!r}")
        if p.resource not in RESOURCES:
            _fail(V_PLAN, who,
                  f"phase {p.name!r} has unknown resource {p.resource!r}")
        for d in p.after:
            if d not in seen:
                _fail(V_PLAN, who,
                      f"phase {p.name!r} depends on {d!r} which is "
                      "absent or declared later (cycle or dangling edge)")
        seen.add(p.name)
    for barrier in (plan.release_after, plan.respond_after):
        if barrier not in seen:
            _fail(V_PLAN, who, f"barrier on unknown phase {barrier!r}")
    group_runs: set[str] = set()
    last = None
    for p in plan.phases:
        g = phase_group(p.name)
        if g != last:
            if g in group_runs:
                _fail(V_PLAN, who,
                      f"breakdown group {g!r} is not a contiguous run")
            group_runs.add(g)
            last = g

    # Transitive reduction: no declared edge may be implied by a path
    # through another declared edge (golden graphs stay minimal and the
    # group-level DAG readable).
    for p in plan.phases:
        for d in p.after:
            for e in p.after:
                if e != d and d in plan.ancestors(e):
                    _fail(V_TRED, who,
                          f"edge {d!r} -> {p.name!r} is redundant: "
                          f"already implied via {e!r}")


def verify_program(program: PlanProgram,
                   durations: tuple[float, ...] | None = None,
                   *, subject: str | None = None) -> None:
    """Every structural invariant of one lowered PlanProgram, checked
    against its source PhasePlan and the variant's SystemSpec rules.
    Raises `PlanCheckError` (with a stable ``code``) on the first
    violation; returns None when the program is sound."""
    plan = program.plan
    spec = SYSTEMS.get(plan.system)
    who = subject or (f"{plan.system}/{'cold' if plan.cold else 'warm'}"
                      f"/kb={program.kernel_bypass}")

    verify_plan(plan, subject=who)

    names = program.names
    n = len(names)
    if names != plan.phase_names:
        _fail(V_XNAME, who,
              f"program names {names} != plan phases {plan.phase_names}")

    # --- index-space sanity: declaration order must be topological.
    for i in range(n):
        for p in program.pred[i]:
            if not 0 <= p < n:
                _fail(V_TOPO, who, f"pred of {names[i]!r} out of range: {p}")
            if p >= i:
                _fail(V_TOPO, who,
                      f"edge {names[p % n]!r} -> {names[i]!r} violates "
                      "topological index order (cycle or misordered "
                      "lowering)")
        for s in program.succ[i]:
            if not 0 <= s < n or s <= i:
                _fail(V_TOPO, who,
                      f"successor {s} of {names[i]!r} violates "
                      "topological index order")

    pred_edges = {(p, i) for i in range(n) for p in program.pred[i]}
    succ_edges = {(i, s) for i in range(n) for s in program.succ[i]}
    if pred_edges != succ_edges:
        odd = pred_edges.symmetric_difference(succ_edges)
        _fail(V_EDGE, who,
              f"pred/succ arrays disagree on edges: {sorted(odd)}")

    if len(program.succ_off) != n + 1 or program.succ_off[0] != 0:
        _fail(V_CSR, who,
              f"succ_off must have {n + 1} entries starting at 0, got "
              f"{len(program.succ_off)} starting at "
              f"{program.succ_off[:1]}")
    for i in range(n):
        row = program.succ_flat[program.succ_off[i]:program.succ_off[i + 1]]
        if tuple(row) != program.succ[i]:
            _fail(V_CSR, who,
                  f"CSR row for {names[i]!r} is {tuple(row)} but succ "
                  f"declares {program.succ[i]}")

    for i in range(n):
        if program.indegree[i] != len(program.pred[i]):
            _fail(V_INDEGREE, who,
                  f"indegree[{names[i]!r}] = {program.indegree[i]} but "
                  f"{len(program.pred[i])} predecessors exist")

    true_roots = tuple(i for i in range(n) if not program.pred[i])
    if program.roots != true_roots:
        _fail(V_ROOTS, who,
              f"roots {program.roots} != zero-indegree set {true_roots}")

    # --- cross-check the program's graph against the authoring plan.
    idx = {nm: i for i, nm in enumerate(names)}
    for i, p in enumerate(plan.phases):
        want = tuple(idx[d] for d in p.after)
        if tuple(sorted(program.pred[i])) != tuple(sorted(want)):
            _fail(V_XEDGE, who,
                  f"program pred of {p.name!r} is "
                  f"{tuple(names[q] for q in program.pred[i])} but the "
                  f"plan declares {p.after}")
    for i, p in enumerate(plan.phases):
        want_core = p.resource in (GUEST_CORE, BACKEND_WORKER)
        if program.on_core[i] != want_core:
            _fail(V_XCORE, who,
                  f"on_core[{p.name!r}] = {program.on_core[i]} but "
                  f"resource {p.resource!r} implies {want_core}")

    # --- slot acquire/release balance per backend group, under the
    # transport's kernel-bypass release rule (re-derived independently:
    # completion-driven transports drop the pool slot after the group's
    # last CPU slice; blocking transports hold it across the wire).
    groups = plan.backend_groups()
    grouped: set[int] = set()
    for g, members in groups.items():
        midx = [idx[m] for m in members]
        grouped.update(midx)
        acq = [i for i in midx if program.acquires_slot[i]]
        if acq != [midx[0]]:
            _fail(V_SLOT_HEAD, who,
                  f"backend group {g!r} must acquire its slot exactly at "
                  f"its head {members[0]!r}; acquire flags sit on "
                  f"{[names[i] for i in acq]}")
        rel = [i for i in midx if program.releases_slot[i]]
        if len(rel) != 1:
            _fail(V_SLOT, who,
                  f"backend group {g!r} must release its slot exactly "
                  f"once; release flags sit on {[names[i] for i in rel]}")
        if program.kernel_bypass:
            cpu = [i for i in midx
                   if plan.phase(names[i]).resource == BACKEND_WORKER]
            expected = cpu[-1] if cpu else midx[-1]
        else:
            expected = midx[-1]
        if rel[0] != expected:
            _fail(V_SLOT_REL, who,
                  f"backend group {g!r} releases at {names[rel[0]]!r} "
                  f"but kernel_bypass={program.kernel_bypass} requires "
                  f"{names[expected]!r}")
    for i in range(n):
        if i not in grouped and (program.acquires_slot[i]
                                 or program.releases_slot[i]):
            _fail(V_SLOT, who,
                  f"{names[i]!r} carries a slot flag but belongs to no "
                  "backend group")

    # --- barrier legality. Ancestor sets over program indices, built
    # from pred (already proven topological above).
    anc = [0] * n
    for i in range(n):
        a = 0
        for p in program.pred[i]:
            a |= anc[p] | (1 << p)
        anc[i] = a

    r = program.respond_idx
    if not (0 <= r < n) or names[r] != "reply" or r != n - 1:
        _fail(V_BARRIER_RESPOND, who,
              f"respond barrier must be the final 'reply' phase; "
              f"respond_idx={r} "
              f"({names[r] if 0 <= r < n else 'out of range'})")

    base = [nm.partition("[")[0] for nm in names]
    for i in range(n):
        if base[i] == "write_net" and not (anc[r] >> i) & 1:
            _fail(V_BARRIER_PUTGATE, who,
                  f"durable PUT {names[i]!r} is not an ancestor of the "
                  "reply — the response could outrun the write-back")

    rel_i = program.release_idx
    if not 0 <= rel_i <= r:
        _fail(V_BARRIER_RELEASE, who,
              f"release_idx {rel_i} out of range (respond at {r})")
    if rel_i != r:
        if spec is not None and not spec.async_writeback:
            _fail(V_BARRIER_RELEASE, who,
                  f"{plan.system} is synchronous but the instance "
                  f"releases early at {names[rel_i]!r}")
        restore_i = names.index("restore")
        if not (anc[rel_i] >> restore_i) & 1:
            _fail(V_BARRIER_RELEASE, who,
                  f"release at {names[rel_i]!r} does not postdate the "
                  "restore — the instance would be released before it "
                  "exists")

    if spec is not None and spec.async_writeback:
        for i in range(n):
            if base[i] != "write_net":
                continue
            stray = [s for s in program.succ[i] if s != r]
            if stray:
                _fail(V_BARRIER_ASYNC, who,
                      f"async write-back {names[i]!r} blocks "
                      f"{[names[s] for s in stray]} — the write chain "
                      "must float past the release and gate only the "
                      "reply")

    # --- fault lowering (FaultPlane geometry).
    for i in range(n):
        if program.fabric[i] != (base[i] in _FABRIC_BASES):
            _fail(V_FABRIC, who,
                  f"fabric[{names[i]!r}] = {program.fabric[i]} but the "
                  f"fetch/write chains imply {base[i] in _FABRIC_BASES}")

    bg_names = sorted(groups, key=lambda g: idx[groups[g][0]])
    want_members = tuple(tuple(idx[m] for m in groups[g]) for g in bg_names)
    if program.bgroup_members != want_members:
        _fail(V_BGROUP, who,
              f"bgroup_members {program.bgroup_members} != plan backend "
              f"groups {want_members}")
    bg_ord = {g: o for o, g in enumerate(bg_names)}
    for i, p in enumerate(plan.phases):
        want_of = bg_ord[p.backend_group] if p.backend_group else -1
        if program.bgroup_of[i] != want_of:
            _fail(V_BGROUP, who,
                  f"bgroup_of[{p.name!r}] = {program.bgroup_of[i]}, "
                  f"expected {want_of}")
        want_head = want_members[want_of][0] if want_of >= 0 else -1
        if program.bgroup_head[i] != want_head:
            _fail(V_BGROUP, who,
                  f"bgroup_head[{p.name!r}] = {program.bgroup_head[i]}, "
                  f"expected {want_head} — crash recovery would re-drive "
                  "the wrong phase")

    for i in range(n):
        if base[i] == "write_net":
            want_ord = int(names[i].partition("[")[2].rstrip("]"))
        else:
            want_ord = -1
        if program.put_ordinal[i] != want_ord:
            _fail(V_PUTORD, who,
                  f"put_ordinal[{names[i]!r}] = {program.put_ordinal[i]}, "
                  f"expected {want_ord} — the exactly-once ledger would "
                  "mis-account this PUT")

    if program.restore_idx != names.index("restore"):
        _fail(V_RESTORE, who,
              f"restore_idx = {program.restore_idx}, expected "
              f"{names.index('restore')}")

    # --- breakdown-group arrays (the threaded walker's index space).
    want_gnames = plan.group_names()
    gidx = {g: i for i, g in enumerate(want_gnames)}
    gdeps = plan.group_deps()
    want_gsucc: list[list[int]] = [[] for _ in want_gnames]
    for g, ds in gdeps.items():
        for d in ds:
            want_gsucc[gidx[d]].append(gidx[g])
    ok = (program.group_names == want_gnames
          and program.group_succ == tuple(tuple(sorted(s))
                                          for s in want_gsucc)
          and program.group_indegree == tuple(len(gdeps[g])
                                              for g in want_gnames)
          and program.group_roots == tuple(i for i, g
                                           in enumerate(want_gnames)
                                           if not gdeps[g]))
    if not ok:
        _fail(V_GROUPS, who,
              "breakdown-group arrays disagree with the plan's group "
              f"DAG: names {program.group_names} vs {want_gnames}, "
              f"succ {program.group_succ} vs {want_gsucc}")

    # --- duration-vector alignment (optional: callers that have the
    # cost model handy pass `duration_vector(spec, w, cold)`).
    if durations is not None:
        if len(durations) != n:
            _fail(V_DUR, who,
                  f"duration vector has {len(durations)} entries for "
                  f"{n} phases")
        for i, d in enumerate(durations):
            if d < 0.0:
                _fail(V_DUR, who, f"negative duration at {names[i]!r}")
        if not plan.cold and durations[names.index("restore")] != 0.0:
            _fail(V_DUR, who,
                  "warm plan carries a nonzero restore duration")


def verify_cache_overlay(program: PlanProgram,
                         base_ops: tuple, base_ops2: tuple,
                         ops: tuple, ops2: tuple,
                         accesses: tuple, profile: IOProfile, *,
                         subject: str | None = None) -> None:
    """Invariants of one SharedCache opcode overlay
    (`des.cache_overlay` output) against its base bundle + profile.

    Independently re-derives — via `plan.cache_vector` and the phase
    names, never the overlay code itself — where the cache opcode may
    legally appear, and checks:

    * `V-CACHE-WIRE`: every patched position is the ``fetch_net`` of a
      *cacheable* GET and the transition is exactly wire -> cache (a
      group-head ``fetch_net`` keeps its slot opcode in ``ops`` and
      patches only the post-grant array);
    * `V-CACHE-COVER`: no cacheable GET's wire opcode is left
      unpatched in either array;
    * `V-CACHE-OP`: the replayed access list matches the profile in
      order, keys, sizes, hint promotion, and phase indices — the twin
      `CacheState`'s input, so both executors consult the cache
      identically.
    """
    who = subject if subject is not None else "<program>"
    names = program.names
    n = len(names)
    for label, arr in (("base ops", base_ops), ("base ops2", base_ops2),
                       ("ops", ops), ("ops2", ops2)):
        if len(arr) != n:
            _fail(V_CACHE_OP, who,
                  f"{label} has {len(arr)} entries for {n} phases")
    cvec = cache_vector(names)
    net_pi = {gi: i for i, gi in enumerate(cvec) if gi >= 0}
    cpu_pi: dict[int, int] = {}
    for i, nm in enumerate(names):
        base, _, idx = nm.partition("[")
        if base == "fetch_cpu":
            cpu_pi[int(idx.rstrip("]"))] = i
    legal: set[int] = set()
    want: list[tuple] = []
    gi = pk = 0
    for op in profile.ops:
        if isinstance(op, Get):
            if op.cacheable:
                pi = net_pi.get(gi)
                if pi is None:
                    _fail(V_CACHE_COVER, who,
                          f"cacheable GET {gi} has no fetch_net phase")
                legal.add(pi)
                lks = op.key or f"g{gi}"
                want.append(("g", lks, lks if op.shared else None,
                             op.size_bytes, op.prefetchable, pi,
                             cpu_pi.get(gi, -1)))
            gi += 1
        elif isinstance(op, Put):
            want.append(("p", op.key or f"p{pk}", op.size_bytes))
            pk += 1
    for label, base_arr, arr in (("ops", base_ops, ops),
                                 ("ops2", base_ops2, ops2)):
        for i in range(n):
            if arr[i] != base_arr[i]:
                if i not in legal:
                    _fail(V_CACHE_WIRE, who,
                          f"{label}[{i}] ({names[i]!r}) patched outside "
                          f"a cacheable GET's fetch_net")
                if base_arr[i] != _OP_WIRE or arr[i] != _OP_CACHE:
                    _fail(V_CACHE_WIRE, who,
                          f"{label}[{i}] ({names[i]!r}): illegal patch "
                          f"{base_arr[i]} -> {arr[i]}")
            elif i in legal and base_arr[i] == _OP_WIRE:
                _fail(V_CACHE_COVER, who,
                      f"{label}[{i}] ({names[i]!r}) holds the wire "
                      f"opcode but was not patched for the cache")
    if tuple(accesses) != tuple(want):
        _fail(V_CACHE_OP, who,
              f"cache access list disagrees with the profile: "
              f"{tuple(accesses)} vs expected {tuple(want)}")
