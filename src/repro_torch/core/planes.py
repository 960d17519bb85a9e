"""Control-plane / data-plane split (paper §4.3.1).

* ControlPlane — the virtio-vsock channel: a bounded queue of *small*
  descriptor messages (request marshaling, completions). Message size is
  asserted ≤ 4 KB: bulk bytes must never ride the control plane.
* Data moves through `arena.TenantArena` slots (fast path) or
  `streaming.CircularBuffer` (fallback); both are zero-copy views over
  pre-allocated host memory.

Every control message charges the vsock costs from the fabric model and
counts the two boundary crossings (kick + completion) that a vsock
round-trip costs — this is what makes Nexus's crossing counts per op
O(1) instead of O(payload) under virtio-net.

A copy of ``repro.core.planes``, whole. Every constant keeps the
reference's value.
"""
from __future__ import annotations

import queue
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core import fabric as F
from repro_torch.core import metrics as M

CTRL_MSG_MAX_BYTES = 4096


@dataclass
class ControlMessage:
    kind: str                    # 'invoke' | 'get' | 'put' | 'complete' | ...
    tenant: str
    body: dict[str, Any] = field(default_factory=dict)
    reply: "queue.Queue | None" = None

    def approx_size(self) -> int:
        return 64 + sum(len(str(k)) + len(str(v)) for k, v in self.body.items())


class ControlPlane:
    """Bounded vsock-like duplex channel between one guest and the host."""

    def __init__(self, acct: M.CycleAccount, depth: int = 256):
        self._q: "queue.Queue[ControlMessage]" = queue.Queue(maxsize=depth)
        self._acct = acct
        self.sent = 0

    def send(self, msg: ControlMessage) -> None:
        size = msg.approx_size()
        if size > CTRL_MSG_MAX_BYTES:
            raise ValueError(
                f"control message {size}B exceeds {CTRL_MSG_MAX_BYTES}B — "
                "bulk payloads must use the data plane")
        self._acct.charge(M.GUEST_KERNEL, F.VSOCK_GUEST_KERNEL_MCYC)
        self._acct.charge(M.HOST_KERNEL, F.VSOCK_HOST_KERNEL_MCYC)
        self._acct.cross(M.VM_EXIT, F.VSOCK_EXITS_PER_MSG)
        self._acct.cross(M.CTRL_MSG)
        self._q.put(msg)
        self.sent += 1

    def recv(self, timeout: float | None = None) -> ControlMessage:
        return self._q.get(timeout=timeout)

    def try_recv(self) -> ControlMessage | None:
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None


def call(plane: ControlPlane, msg: ControlMessage, timeout: float = 30.0):
    """Synchronous RPC over the control plane: send, await reply."""
    msg.reply = queue.Queue(maxsize=1)
    plane.send(msg)
    return msg.reply.get(timeout=timeout)


def reply(msg: ControlMessage, value) -> None:
    assert msg.reply is not None, "message was not a call"
    msg.reply.put(value)
