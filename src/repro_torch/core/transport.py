"""Transport models: TCP vs kernel-bypass RDMA (paper §4.3.2).

A transport carries bulk payloads between the worker node and remote
storage. The two concrete transports differ exactly as in the paper:

* TCP  — every byte traverses the host kernel network stack, charging
  host-kernel cycles per byte plus fixed per-message costs; connection
  setup is cheap.
* RDMA — the NIC DMAs payloads straight into the (registered) shared
  memory arena, bypassing the host kernel: near-zero per-byte CPU cost,
  much lower latency, but expensive one-time connection/queue-pair
  setup (the paper's "Add Server" cold-start component).

Latency is *real* (the runtime sleeps), cycles are *accounted* (charged
to `CycleAccount`). Constants are calibrated for the paper's testbed
(2.1 GHz Xeon, 100 Gbps NIC).

A copy of ``repro.core.transport`` without the pluggable clock, which the
port's serve driver does not use.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import metrics as M

MB = 1024 * 1024


@dataclass(frozen=True)
class TransportSpec:
    name: str
    bandwidth_mbps: float          # effective MB/s payload bandwidth
    base_latency_s: float          # per-message one-way latency
    setup_latency_s: float         # connection / queue-pair establishment
    host_kernel_mcyc_per_mb: float  # kernel net-stack cost (0 for bypass)
    host_user_mcyc_per_mb: float   # userspace driver / completion handling
    host_kernel_mcyc_per_msg: float  # syscalls / interrupts per message
    kernel_bypass: bool

    def transfer_latency(self, nbytes: int) -> float:
        return self.base_latency_s + (nbytes / MB) / self.bandwidth_mbps

    def charge_transfer(self, acct: M.CycleAccount, nbytes: int) -> None:
        mb = nbytes / MB
        acct.charge(M.HOST_KERNEL,
                    self.host_kernel_mcyc_per_mb * mb
                    + self.host_kernel_mcyc_per_msg)
        acct.charge(M.HOST_USER, self.host_user_mcyc_per_mb * mb)


# 100 Gbps-class NIC; TCP reaches ~6 GB/s effective per stream with the
# kernel stack engaged, RDMA ~11 GB/s with negligible CPU involvement.
TCP = TransportSpec(
    name="tcp",
    bandwidth_mbps=6_000.0,
    base_latency_s=120e-6,
    setup_latency_s=4e-3,            # TLS pool establishment
    host_kernel_mcyc_per_mb=2.4,     # skb alloc/copy/csum per MB
    host_user_mcyc_per_mb=0.5,
    host_kernel_mcyc_per_msg=0.08,   # syscalls, softirq
    kernel_bypass=False,
)

RDMA = TransportSpec(
    name="rdma",
    bandwidth_mbps=11_000.0,
    base_latency_s=8e-6,
    setup_latency_s=60e-3,           # QP creation + memory registration
                                     # (the paper's "Add Server" term)
    host_kernel_mcyc_per_mb=0.0,     # kernel fully bypassed
    host_user_mcyc_per_mb=0.12,      # CQ polling / doorbells
    host_kernel_mcyc_per_msg=0.0,
    kernel_bypass=True,
)

TRANSPORTS = {"tcp": TCP, "rdma": RDMA}

