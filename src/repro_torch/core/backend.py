"""Nexus backend: the shared, trusted host I/O service (paper §4).

One backend process multiplexes I/O for every co-resident instance:

* terminates the invocation RPC natively (host Go server, §4.2.1);
* prefetches hinted inputs into exactly-sized arena slots, overlapped
  with instance restore (§4.2.2);
* streams opaque payloads through bounded circular buffers (§4.2.3);
* executes SDK GET/PUT on behalf of guests over TCP or RDMA (§4.3.2);
* drives asynchronous output writes, releasing the VM early while
  withholding the caller's response until the write is acked (§4.2.5);
* holds the only copy of provider credentials (§4.3.3);
* enforces per-client token-bucket rate limits (§4.4);
* is stateless + crash-only: a supervisor restarts it, frontends retry,
  and PUT idempotency keys preserve at-least-once semantics (§5).

A copy of ``repro.core.backend``, whole.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

from repro_torch.core import fabric as F
from repro_torch.core import metrics as M
from repro_torch.core.arena import ArenaRegistry, Slot
from repro_torch.core.cache import SharedCache
from repro_torch.core.credentials import TokenManager
from repro_torch.core.hints import InputHint, OutputHint
from repro_torch.core.ratelimit import ClientLimiter
from repro_torch.core.storage import RemoteStorage
from repro_torch.core.streaming import CircularBuffer

MB = 1024 * 1024


class BackendCrashed(ConnectionError):
    """Raised by in-flight ops when the backend process dies."""


class LostWriteError(ConnectionError):
    """An ack-less write has no idempotency record: it never completed
    (crash took both), so the redrive must carry the payload again."""


@dataclass
class PrefetchHandle:
    """Frontend-visible handle to an in-flight hinted prefetch."""

    hint: InputHint
    ready: threading.Event = field(default_factory=threading.Event)
    slot: Slot | None = None
    error: BaseException | None = None

    def wait(self, timeout: float = 30.0) -> Slot:
        if not self.ready.wait(timeout):
            raise TimeoutError(f"prefetch of {self.hint.key} timed out")
        if self.error is not None:
            raise self.error
        assert self.slot is not None
        return self.slot


@dataclass
class PutTicket:
    """Tracks one async output write to completion (at-least-once).

    Carries the logical-write identity (tenant, cred, hint) so a
    frontend whose ack timed out can re-drive the write idempotently
    (`NexusBackend.redrive_put`) — the dedup table resolves retries of
    completed writes without moving bytes again.
    """

    invocation_id: str
    future: Future = field(default_factory=Future)
    tenant: str = ""
    cred: str = ""
    out: OutputHint | None = None


class NexusBackend:
    """The shared host I/O daemon (Go in the paper; threads here)."""

    def __init__(self, remote: RemoteStorage, acct: M.CycleAccount,
                 *, workers: int = 16, arena_mb: float = 64.0,
                 transport_name: str = "tcp",
                 arenas: ArenaRegistry | None = None,
                 tokens: TokenManager | None = None,
                 cache: SharedCache | None = None,
                 fault_hooks=None,
                 alloc_timeout_s: float = 10.0):
        self.remote = remote
        self.acct = acct
        self.transport_name = transport_name
        # SharedCache: node-owned like the arenas/tokens — survives a
        # backend crash and re-attaches to the restarted daemon.
        self.cache = cache
        # FaultPlane taps (faults.FaultHooks), read at call time so the
        # injector stays armed across supervisor restarts
        self.fault_hooks = fault_hooks
        self.alloc_timeout_s = alloc_timeout_s
        # Arenas are file-backed host memory and tokens belong to the
        # cluster orchestrator — both survive a backend crash (§5); the
        # supervisor re-attaches them to the restarted daemon.
        self.arenas = arenas if arenas is not None else ArenaRegistry(arena_mb)
        self.tokens = tokens if tokens is not None else TokenManager()
        self.limiter = ClientLimiter()
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="nexus-be")
        self._alive = True
        self._lock = threading.Lock()
        # idempotency: invocation_id -> etag of the completed write.
        # Deliberately *not* persisted: a crash loses it and a retried
        # write re-executes — idempotent PUTs keep at-least-once intact.
        self._completed_puts: dict[str, int] = {}
        self.stats = {"prefetches": 0, "sync_gets": 0, "puts": 0,
                      "stream_gets": 0, "dedup_hits": 0, "acks_dropped": 0,
                      "cache_hits": 0}
        self._conn_established: set[str] = set()

    # ----------------------------------------------------------- liveness

    @property
    def alive(self) -> bool:
        return self._alive

    def crash(self) -> None:
        """Fault injection: kill the daemon (crash-only design, §5)."""
        self._alive = False

    def _check_alive(self) -> None:
        if not self._alive:
            raise BackendCrashed("nexus backend is down")

    # ------------------------------------------------------ registration

    def register_function(self, function: str, buckets: set[str]) -> str:
        """Orchestrator provisions least-privilege credentials (§4.3.3)
        and establishes the tenant's shared-memory region up front (the
        PCI-BAR mapping exists before the first invocation, §4.3.1).
        Returns the opaque handle the guest may hold."""
        self.arenas.get(function)
        return self.tokens.provision(function, buckets)

    def connection_setup(self, endpoint: str) -> float:
        """First use of a storage endpoint pays transport setup (the
        paper's 'Add Server' cold-start component — RDMA QP setup is the
        dominant term). Returns seconds spent."""
        with self._lock:
            if endpoint in self._conn_established:
                return 0.0
            self._conn_established.add(endpoint)
        t = self.remote.transport.setup_latency_s
        time.sleep(t)
        self.acct.charge(M.HOST_USER, 0.3 if self.remote.transport.kernel_bypass
                         else 0.15)
        return t

    # ------------------------------------------------------------- ingress

    def terminate_rpc(self) -> None:
        """Backend natively terminates the invocation RPC (§4.2.1)."""
        self._check_alive()
        F.rpc_ingress_cost(in_guest=False).charge(self.acct)

    # ------------------------------------------------------------ fetches

    def _run_sdk(self, nbytes: int) -> None:
        """The Go SDK's cycles run here, on host cores — still ahead of
        data availability, so they are slept (they shape fetch latency)
        as well as accounted (host-user, via remoted_op_cost)."""
        nominal = int(nbytes * self.remote.cost_scale)
        time.sleep(F.fabric_op_mcycles("aws", "go", nominal) / 2100.0)

    def _authorized_get(self, tenant: str, cred: str, bucket: str,
                        key: str, *, hinted: bool = True,
                        use_cache: bool = True) -> bytes:
        """Authorized GET through the SharedCache plane. A validated
        hit is served from the host arena tier: no remote trip, no SDK
        cycles, no S3 rate-limit spend — only the modeled arena copy
        time (the same `hit_duration_s` the DES charges). A miss takes
        the full remote path and offers the bytes back for admission
        (`hinted` = the GET was hint-promoted at ingress;
        ``use_cache=False`` is the per-GET opt-out header)."""
        self.tokens.authorize(cred, bucket, "get")
        self.connection_setup(bucket)
        cache = self.cache if use_cache else None
        if cache is not None:
            data = cache.get(tenant, bucket, key, self.remote.store,
                             hinted=hinted)
            if data is not None:
                self.stats["cache_hits"] += 1
                time.sleep(cache.spec.hit_duration_s(
                    int(len(data) * self.remote.cost_scale)))
                return data
        # bytes and etag come from ONE atomic store snapshot: a PUT
        # committing during the modeled transfer must never let the
        # fill bind the old bytes to the new version's etag (that
        # entry would revalidate forever and serve stale data).
        data, meta = self.remote.get_with_meta(bucket, key)
        if cache is not None:
            cache.fill(tenant, bucket, key, data,
                       int(len(data) * self.remote.cost_scale),
                       hinted=hinted, etag=meta.etag)
        self._run_sdk(len(data))
        self.limiter.bucket("s3").throttle(len(data))
        return data

    def prefetch(self, tenant: str, cred: str, hint: InputHint,
                 nominal_bytes: int | None = None,
                 pre_connect: str | None = None) -> PrefetchHandle:
        """Hint-driven async prefetch into an exactly-sized slot (§4.2.2).

        `pre_connect`: cold starts first establish the new VM's storage
        connections (per-VM state; the 'Add Server' cost) — serial with
        the fetch but overlapped with the VM restore.
        """
        self._check_alive()
        handle = PrefetchHandle(hint)
        self.stats["prefetches"] += 1

        def _run():
            try:
                self._check_alive()
                if pre_connect is not None:
                    self.connection_setup(pre_connect)
                data = self._authorized_get(tenant, cred, hint.bucket,
                                            hint.key, hinted=True,
                                            use_cache=hint.cacheable)
                size = len(data)
                # arena pressure is transient: stall for reclaim rather
                # than failing the fetch outright (§4.3.1)
                slot = self.arenas.get(tenant).alloc_wait(
                    max(size, 1), timeout_s=self.alloc_timeout_s)
                slot.write(data)
                # RDMA: NIC DMAs straight into the registered arena —
                # charged inside the transport model (zero host-kernel).
                handle.slot = slot
            except BaseException as e:      # noqa: BLE001 — propagated
                handle.error = e
            finally:
                handle.ready.set()

        self._pool.submit(_run)
        return handle

    def fetch_sync(self, tenant: str, cred: str, bucket: str, key: str,
                   *, hinted: bool = True, cacheable: bool = True) -> Slot:
        """Synchronous remoted GET (Nexus-TCP path / no hints)."""
        self._check_alive()
        self.stats["sync_gets"] += 1
        data = self._authorized_get(tenant, cred, bucket, key,
                                    hinted=hinted, use_cache=cacheable)
        slot = self.arenas.get(tenant).alloc_wait(
            max(len(data), 1), timeout_s=self.alloc_timeout_s)
        slot.write(data)
        return slot

    def fetch_stream(self, tenant: str, cred: str, bucket: str, key: str,
                     buf: CircularBuffer, chunk: int = 256 * 1024) -> None:
        """Streaming fallback: pump the object through a bounded ring
        (§4.2.3). Runs on a backend worker; the frontend consumes."""
        self._check_alive()
        self.stats["stream_gets"] += 1

        def _run():
            try:
                # opaque payload: never hint-promoted, so it is only
                # admitted under the ``admit="all"`` policy
                data = self._authorized_get(tenant, cred, bucket, key,
                                            hinted=False)
                for off in range(0, len(data), chunk):
                    buf.write(memoryview(data)[off:off + chunk])
            except BaseException as e:      # noqa: BLE001 — propagated
                # a failed pump must surface at the consumer, never
                # read as a clean (truncated) EOF
                buf.fail(e)
            else:
                buf.close()

        self._pool.submit(_run)

    # -------------------------------------------------------------- writes

    def submit_put(self, tenant: str, cred: str, out: OutputHint,
                   slot: Slot, invocation_id: str) -> PutTicket:
        """Asynchronous output write (§4.2.5). The returned ticket's
        future resolves only after remote storage acks — callers gate
        the invocation response on it (at-least-once)."""
        self._check_alive()
        self.arenas.resolve(tenant, slot)         # isolation check
        ticket = PutTicket(invocation_id, tenant=tenant, cred=cred, out=out)
        self.stats["puts"] += 1
        # idempotency is per *logical write*: an invocation may make any
        # number of distinct durable PUTs (fan-out handlers); only a
        # retry of the same output may dedup.
        dedup_key = f"{invocation_id}:{out.bucket}/{out.key}"

        def _run():
            try:
                self._check_alive()
                with self._lock:
                    done = self._completed_puts.get(dedup_key)
                if done is not None:
                    self.stats["dedup_hits"] += 1
                    slot.release()       # the retry's copy is never sent
                    ticket.future.set_result(done)
                    return
                self.tokens.authorize(cred, out.bucket, "put")
                self.connection_setup(out.bucket)
                view = slot.view()
                self._run_sdk(len(view))
                self.limiter.bucket("s3").throttle(len(view))
                meta = self.remote.put(out.bucket, out.key, view)
                with self._lock:
                    self._completed_puts[dedup_key] = meta.etag
                cache = self.cache
                if cache is not None:
                    # write-through strictly AFTER the remote PUT
                    # committed durably (never caches an unacked
                    # write); bytes copied before the slot goes back
                    cache.put(tenant, out.bucket, out.key, bytes(view),
                              int(len(view) * self.remote.cost_scale),
                              meta.etag)
                slot.release()
                # FaultPlane ack-drop tap: the write IS durable and the
                # idempotency record exists — only the ack is lost. The
                # frontend's timed-out wait redrives and dedup resolves.
                hooks = self.fault_hooks
                if (hooks is not None and hooks.ack_drop is not None
                        and hooks.ack_drop(dedup_key)):
                    self.stats["acks_dropped"] += 1
                    return
                ticket.future.set_result(meta.etag)
            except BaseException as e:      # noqa: BLE001
                # the attempt failed BEFORE the release above: free the
                # slot now (idempotent) — arenas outlive backend crashes
                # by design, so a leak here would be permanent, and the
                # frontend's recovery re-submits with a fresh slot.
                slot.release()
                ticket.future.set_exception(e)

        self._pool.submit(_run)
        return ticket

    def redrive_put(self, tenant: str, cred: str, out: OutputHint,
                    invocation_id: str) -> PutTicket:
        """Idempotent retry of a durable write whose ack never arrived
        (§5). No payload travels: if the original write completed, the
        per-logical-write dedup record resolves the retry immediately;
        if it truly was lost (e.g. the daemon died mid-write and took
        the dedup table with it), the caller still holds the payload
        and must re-submit via `submit_put` instead."""
        self._check_alive()
        ticket = PutTicket(invocation_id, tenant=tenant, cred=cred, out=out)
        dedup_key = f"{invocation_id}:{out.bucket}/{out.key}"
        with self._lock:
            done = self._completed_puts.get(dedup_key)
        if done is not None:
            self.stats["dedup_hits"] += 1
            ticket.future.set_result(done)
        else:
            ticket.future.set_exception(LostWriteError(
                f"no idempotency record for {dedup_key}: the write was "
                f"lost, re-submit the payload"))
        return ticket

    # ------------------------------------------------------------ teardown

    def shutdown(self) -> None:
        self._alive = False
        self._pool.shutdown(wait=False, cancel_futures=True)

    def memory_mb(self, registered_instances: int) -> float:
        return (F.BACKEND_BASE_MB
                + F.BACKEND_PER_INSTANCE_MB * registered_instances
                + self.arenas.total_mb())
