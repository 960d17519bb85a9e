"""FaultPlane taps (paper §5): the hooks one worker node owns.

The paper's reliability story is *crash-only*: the shared backend is
stateless, a host supervisor restarts it on fault, frontend stubs
transparently retry, and per-logical-write PUT idempotency keys keep
at-least-once semantics. The backend, the instance lifecycle and the
coupled client read the `FaultHooks` below at call time.

A copy of the threaded side of ``repro.core.faults``: `FaultHooks` only.
The fault vocabulary, `FaultSchedule` and the `FaultInjector` that arms
these hooks from a schedule are not copied yet; unarmed hooks (every
field ``None``) inject nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass
class FaultHooks:
    """Mutable fault taps one `runtime.WorkerNode` owns.

    Components read these *at call time* (not at construction), so a
    backend recreated by the supervisor after a crash stays armed, and
    disarming is one attribute store. ``None`` means: no fault.
    """

    #: ack_drop(dedup_key) -> True to lose this durable write's ack
    ack_drop: Callable[[str], bool] | None = None
    #: restore_fail() -> True to fail the current restore attempt
    restore_fail: Callable[[], bool] | None = None
    #: guest_crash() -> True while the in-guest fabric is crashed
    #: (coupled variants only: kills the whole invocation)
    guest_crash: Callable[[], bool] | None = None
