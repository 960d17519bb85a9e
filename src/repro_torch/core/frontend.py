"""Guest-side clients: the boto3-compatible surface handlers program to.

`S3Api` is the programming model: every workload is a conventional
``handler(event, ctx)`` function whose only storage access is
``ctx.storage`` — an object satisfying this protocol. The runtime
injects the per-variant implementation; the handler never learns which
one it got. That is the paper's transparency claim (§4.2) as an
executed property: the same handler bytes run under every variant.

`NexusClient` mirrors the boto3 S3 surface (`get_object` / `put_object`)
in ~100 LoC of guest logic: marshal parameters, one control-plane round
trip, return a zero-copy view into the tenant arena. All SDK heavy
lifting (connection pooling, signing, HTTP formatting) happens in the
backend — the guest never links the cloud SDK, the RPC framework, or a
TCP stack, and never sees a credential (only the opaque handle).

`BaselineClient` is the coupled design: the full SDK executes in-guest
(Python), every byte traverses the virtualized network path, and the
instance blocks on its own writes.

A copy of ``repro.core.frontend``, but for two additions.
`HandlerContext` carries one field the reference's lacks: ``device``,
the torch device the node runs its handlers' tensors on. `NexusClient`
takes one keyword the reference's lacks: ``prefetch_timeout_s``, how
long the guest's first GET waits for the ingress prefetch to land (the
reference waits a fixed 30 s, its node's default prefetch deadline; the
port's node passes its ``connect_timeout_s``, so a payload whose
modeled fetch outlasts 30 s can still land).
"""
from __future__ import annotations

import threading
from concurrent.futures import TimeoutError as _FutureTimeout
from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

from repro_torch.core import fabric as F
from repro_torch.core import metrics as M
from repro_torch.core.backend import (BackendCrashed, LostWriteError, NexusBackend,
                                PrefetchHandle, PutTicket)
from repro_torch.core.guardrails import RetrySpec, backoff_delays
from repro_torch.core.hints import OutputHint
from repro_torch.core.storage import RemoteStorage
from repro_torch.core.streaming import CircularBuffer


@runtime_checkable
class S3Api(Protocol):
    """The variant-independent storage surface a handler receives.

    ``get_object`` returns at least ``{"Body": <buffer>,
    "ContentLength": int}``; ``put_object`` returns ``{"ETag": ...}``
    (``None`` while an asynchronous write is still in flight — the
    platform, not the handler, gates the response on the ack).
    """

    def get_object(self, Bucket: str, Key: str) -> dict: ...

    def put_object(self, Bucket: str, Key: str, Body) -> dict: ...


@runtime_checkable
class PlatformS3Api(S3Api, Protocol):
    """The platform-internal storage surface: `S3Api` plus the
    opaque-payload streaming fallback the runtime's interception layer
    routes size-unhinted GETs through. `NexusClient` satisfies it;
    `BaselineClient` deliberately does not — the coupled path never
    streams through the backend ring."""

    def get_object_streaming(self, Bucket: str, Key: str,
                             chunk: int = 256 * 1024): ...


#: The complete storage-call surface, as *data*: `analysis.infer`
#: recognizes exactly these method names on any alias of
#: ``ctx.storage``, so the declared surface and the static analyzer
#: cannot drift apart.
S3_METHODS = frozenset(
    {"get_object", "get_object_streaming", "put_object"})


@dataclass
class HandlerContext:
    """The FaaS ``context`` argument: everything the platform injects.

    ``storage`` is the only I/O capability a handler holds — the same
    `S3Api` surface under every system variant.
    """

    storage: S3Api
    invocation_id: str = ""
    function_name: str = ""
    cold_start: bool = False
    state: dict = field(default_factory=dict)
    #: where the handler's tensors live (`runtime.WorkerNode`'s device)
    device: Any = None


@dataclass
class GuestContext:
    """What the guest is allowed to hold: opaque identifiers only.

    `admission` carries the SharedCache per-GET flags: (bucket, key)
    -> list of (hinted, cacheable) pairs in declared-profile order,
    where `hinted` marks a GET promoted into RPC metadata at ingress
    and `cacheable` is the per-GET cache opt-out header. The list is
    consumed per occurrence (the interception contract matches the
    handler's k-th GET to the k-th declared `Get`), so duplicate-key
    profiles keep each GET's own flags — a set keyed on the pair would
    collapse them and diverge from the DES's per-op admission."""

    tenant: str
    cred_handle: str
    invocation_id: str = ""
    prefetch: PrefetchHandle | None = None
    admission: dict = field(default_factory=dict)
    state: dict = field(default_factory=dict)


class NexusClient:
    """boto3-compatible frontend stub (paper: 645 LoC Python)."""

    def __init__(self, ctx: GuestContext, backend_ref, acct: M.CycleAccount,
                 *, max_retries: int = 3, ack_timeout_s: float = 30.0,
                 retry: RetrySpec | None = None, breaker=None,
                 prefetch_timeout_s: float = 30.0):
        self._ctx = ctx
        # `backend_ref` is a callable returning the *current* backend —
        # after a crash the supervisor swaps in a fresh one and the stub
        # transparently retries (§5).
        self._backend_ref = backend_ref
        self._acct = acct
        #: the bounded retry budget every loop below draws from
        #: (GuardRails plane); `max_retries` alone keeps the legacy
        #: fixed-attempt shape with exponential backoff defaults.
        self._retry_spec = (retry if retry is not None
                            else RetrySpec(max_attempts=max_retries))
        #: optional `guardrails.CircuitBreaker` over the shared backend:
        #: every retried RPC reports failure/success so a failure burst
        #: opens admission upstream.
        self._breaker = breaker
        #: how long a blocking PUT waits for the durable ack before the
        #: invocation is failed (overridable per WorkerNode).
        self.ack_timeout_s = ack_timeout_s
        #: how long the first GET waits for the ingress prefetch to land
        self.prefetch_timeout_s = prefetch_timeout_s
        self.pending_puts: list = []

    @property
    def _backend(self) -> NexusBackend:
        return self._backend_ref()

    def _charge_stub_call(self, sdk: str, nbytes: int) -> None:
        nominal = int(nbytes * self._backend.remote.cost_scale)
        F.remoted_op_cost(sdk, nominal).charge(self._acct)

    def _retry(self, fn, key: str = ""):
        """Transparent retry across backend crashes AND transient
        storage errors (§5): both surface as `ConnectionError`s, both
        are converted into latency by re-driving the request against
        the (possibly restarted) current backend. Attempts and sleeps
        draw from the bounded `RetrySpec` budget — exponential backoff
        with deterministic per-key jitter, never an unbounded loop."""
        delays = backoff_delays(self._retry_spec,
                                key or self._ctx.invocation_id)
        last: BaseException | None = None
        for i, d in enumerate(delays):
            try:
                out = fn()
            except LostWriteError:
                raise                           # needs the payload again
            except ConnectionError as e:        # crash or transient
                if self._breaker is not None:
                    self._breaker.record_failure()
                last = e
                if i + 1 < len(delays):
                    threading.Event().wait(d)   # backoff before redrive
                continue
            if self._breaker is not None:
                self._breaker.record_success()
            return out
        raise last if last else RuntimeError("retry budget exhausted")

    def wait_ack(self, ticket: PutTicket, timeout_s: float | None = None):
        """Block until a durable write's ack arrives. A lost ack (the
        write completed but the response died with the daemon) is
        re-driven idempotently: the retry carries no payload and the
        backend's per-logical-write dedup record resolves it (§5). A
        write that FAILED (transient storage error, crash mid-write)
        has no dedup record — the redrive then raises `LostWriteError`
        and the caller must re-submit the payload."""
        timeout = self.ack_timeout_s if timeout_s is None else timeout_s
        key = f"{ticket.invocation_id}:ack"
        delays = backoff_delays(self._retry_spec, key)
        last: BaseException | None = None
        for d in delays:
            try:
                out = ticket.future.result(timeout=timeout)
            except LostWriteError:
                raise                        # needs the payload again
            except (_FutureTimeout, TimeoutError, ConnectionError) as e:
                if self._breaker is not None:
                    self._breaker.record_failure()
                last = e
                if isinstance(e, BackendCrashed):
                    threading.Event().wait(d)    # restart window
                t = ticket
                ticket = self._retry(lambda: self._backend.redrive_put(
                    t.tenant, t.cred, t.out, t.invocation_id), key)
                continue
            if self._breaker is not None:
                self._breaker.record_success()
            return out
        raise last if last else RuntimeError("ack retry budget exhausted")

    def _admission(self, bucket: str, key: str) -> tuple[bool, bool]:
        """Next (hinted, cacheable) flags for a GET on (bucket, key).
        Each pair's queue holds its GETs' flags in declared-profile
        order and is consumed per call, so duplicate-key GETs with
        differing flags stay per-ordinal (matching the DES overlay's
        per-op admission bits). The final entry sticks for calls past
        the declared count (direct client use carries no profile);
        a pair with no declared GET is unhinted but cacheable."""
        q = self._ctx.admission.get((bucket, key))
        if not q:
            return False, True
        return q.pop(0) if len(q) > 1 else q[0]

    # ------------------------------------------------------------- boto3 API

    def get_object(self, Bucket: str, Key: str) -> dict:
        """S3 GET. Fast path: the hinted prefetch already landed the
        payload in the arena — return the view with zero network work
        (§4.2.4). Otherwise remote a synchronous fetch to the backend."""
        pf = self._ctx.prefetch
        if (pf is not None and pf.hint.bucket == Bucket
                and pf.hint.key == Key):
            self._ctx.prefetch = None            # single-use: consumed
            # the ingress prefetch already spent this ordinal's flags
            # (it fetched with the hint's own bits) — consume them so
            # later same-key GETs keep their per-op alignment
            self._admission(Bucket, Key)
            slot = pf.wait(self.prefetch_timeout_s)
            self._charge_stub_call("aws", 0)     # pointer return: no bytes move
            return {"Body": slot.view(), "ContentLength": slot.used,
                    "_slot": slot}
        hinted, cacheable = self._admission(Bucket, Key)
        slot = self._retry(lambda: self._backend.fetch_sync(
            self._ctx.tenant, self._ctx.cred_handle, Bucket, Key,
            hinted=hinted, cacheable=cacheable))
        self._charge_stub_call("aws", slot.used)
        return {"Body": slot.view(), "ContentLength": slot.used,
                "_slot": slot}

    def get_object_streaming(self, Bucket: str, Key: str,
                             chunk: int = 256 * 1024) -> CircularBuffer:
        """Opaque-payload fallback: bounded ring, no prefetch overlap.

        The stub's per-MB cycles can only be charged once the size is
        known — the ring's close hook fires after the backend pumped
        the last byte, so the full streamed count is billed (not 0)."""
        self._admission(Bucket, Key)    # consume: keeps queues ordinal-aligned
        buf = CircularBuffer(capacity=max(chunk * 4, 1 << 20))
        buf.on_close = lambda b: self._charge_stub_call("aws", b.total_in)
        self._retry(lambda: self._backend.fetch_stream(
            self._ctx.tenant, self._ctx.cred_handle, Bucket, Key, buf, chunk))
        return buf

    def put_object(self, Bucket: str, Key: str, Body, *,
                   wait: bool = True):
        """S3 PUT. Copies the output once into an arena slot (the only
        copy on the whole path), then delegates to the backend. With
        ``wait=False`` (Nexus-Async) control returns immediately and the
        ticket is recorded so the invocation response can gate on it."""
        def _submit():
            be = self._backend
            slot = be.arenas.get(self._ctx.tenant).alloc_wait(
                max(len(Body), 1), timeout_s=be.alloc_timeout_s)
            slot.write(Body)
            return be.submit_put(
                self._ctx.tenant, self._ctx.cred_handle,
                OutputHint(Bucket, Key), slot, self._ctx.invocation_id)

        ticket = self._retry(_submit)
        self._charge_stub_call("aws", len(Body))
        if wait:
            try:
                return self.wait_ack(ticket)
            except LostWriteError:
                # daemon died mid-write, dedup record lost: the payload
                # is still in hand — at-least-once demands a resubmit.
                return self.wait_ack(self._retry(_submit))
        self.pending_puts.append(ticket)
        return ticket


class BaselineClient:
    """Coupled design: the full SDK executes with the handler (§2.2).

    The SDK's cycles execute on the instance's 1 vCPU and therefore sit
    squarely on the invocation's latency path — they are slept (at the
    paper's 2.1 GHz) as well as accounted. With ``virtualized=False``
    (the Faasm/WASM reference point) the fabric is compiled in-process:
    native cycles, no VM amplification, no exits.
    """

    def __init__(self, remote: RemoteStorage, acct: M.CycleAccount,
                 lang: str = "py", sleep=None, *, sdk: str = "aws",
                 virtualized: bool = True, fault=None):
        import time
        self._remote = remote
        self._acct = acct
        self._lang = lang
        self._sdk = sdk
        self._virtualized = virtualized
        self._sleep = sleep or time.sleep
        #: FaultPlane tap (coupled variants): the fabric runs *inside*
        #: the guest, so a fabric crash kills the whole invocation —
        #: there is no supervisor underneath to hide it (§5).
        self._fault = fault

    def _check_fault(self) -> None:
        if self._fault is not None and self._fault():
            raise BackendCrashed("in-guest fabric crashed (coupled design)")

    def _run_fabric(self, nbytes: int) -> None:
        nominal = int(nbytes * self._remote.cost_scale)
        if self._virtualized:
            cost = F.in_guest_op_cost(self._sdk, self._lang, nominal)
        else:
            cost = F.in_process_op_cost(self._sdk, self._lang, nominal)
        cost.charge(self._acct)
        self._sleep(cost.total() / F.GHZ_MCYC_PER_S)

    def get_object(self, Bucket: str, Key: str) -> dict:
        self._check_fault()
        data = self._remote.get(Bucket, Key)
        self._run_fabric(len(data))
        # the guest SDK deserializes into its own buffers: one extra copy
        body = bytearray(data)
        return {"Body": memoryview(body), "ContentLength": len(data)}

    def put_object(self, Bucket: str, Key: str, Body):
        self._check_fault()
        self._run_fabric(len(Body))
        return self._remote.put(Bucket, Key, bytes(Body))
