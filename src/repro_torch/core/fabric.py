"""Communication-fabric cost model (paper §3, Figs. 2–3).

The "communication fabric" is the per-instance stack the paper measures:
cloud SDK + RPC library + TCP/IP, optionally amplified by running inside
a VM. Costs below are calibrated against the paper's microbenchmarks
(single 1 MB PUT, 2.1 GHz Xeon):

* Fig 2b/2c — SDK-over-TCP cycle multipliers, per language:
    MinIO SDK:  3x (Python), 5x (Go); AWS SDK: 6x (Python), 13x (Go),
  on top of language-specific raw-TCP baselines (Python's interpreter
  makes its raw-TCP baseline ~4x Go's). Absolute anchors chosen so the
  Go backend executing the AWS SDK costs ~2x fewer cycles than the same
  SDK in guest Python — the effect the paper exploits.
* Fig 2d — virtualization roughly doubles the I/O path's total cycles;
  the amplification lands in guest-kernel + host-kernel (virtio, exits).
* Fig 3 — memory: fabric ~= 25% of a 169 MB mean footprint
  (SDK 19% ~= 32 MB, RPC 5% ~= 8.5 MB).

All cycle figures are Mcycles; the model is *generative* — benchmarks
derive the paper's claimed savings from these inputs, they never encode
the claimed savings directly.

A copy of ``repro.core.fabric`` holding the parts the port's backend
charges: the SDK cost table and the invocation-RPC ingress cost, plus
the backend's memory constants and the testbed clock the calibration's
Mcycles are counted in. Every kept constant has the reference's
value.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import metrics as M

MB = 1024 * 1024

#: the paper's testbed clock (2.1 GHz Xeon): Mcycles per second per core.
GHZ_MCYC_PER_S = 2100.0

# ------------------------------------------------------- cycle calibration
#
# Per-operation fabric cost = fixed (connection mgmt, auth, signing,
# request construction) + per-MB (serialization, checksumming, buffer
# mgmt). Fixed and per-MB parts are calibrated separately so that at the
# paper's 1 MB measurement point the (sdk, lang) totals reproduce the
# Fig 2b ratios — MinIO 3x/5x and AWS 6x/13x over the same-language raw
# TCP baseline (Python's interpreted control path makes its raw-TCP
# baseline ~2.3x Go's; bulk byte-handling in both SDKs bottoms out in
# native code, so the per-MB gap is only ~2x). Note the Go AWS SDK's
# *fixed* cost exceeds Python's — exactly Fig 2c's instruction-count
# observation — yet offloading still wins because the guest's VM
# amplification (Fig 2d) disappears along the way.
_COST_TABLE = {
    # (sdk, lang): (fixed_mcycles, per_mb_mcycles); 1MB totals below.
    ("tcp", "go"): (0.4, 2.6),       # 3.0  (anchor)
    ("tcp", "py"): (1.6, 5.2),       # 6.8  (= 2.3x go)
    ("minio", "go"): (11.1, 3.9),    # 15.0 (= 5x go tcp)
    ("minio", "py"): (12.6, 7.8),    # 20.4 (= 3x py tcp)
    ("aws", "go"): (33.8, 5.2),      # 39.0 (= 13x go tcp)
    ("aws", "py"): (30.4, 10.4),     # 40.8 (= 6x py tcp)
}

#: paper Fig 2d: in-VM execution of the I/O path ~doubles total cycles.
VM_AMPLIFICATION = 2.0

VIRTIO_EXITS_PER_OP = 150      # HTTP/2-over-virtio packet storm per op
WAKEUPS_PER_EXIT = 0.7         # I/O exits often block + wake the vCPU
#: Nexus control plane: vsock round-trip = 2 exits (kick + completion).
VSOCK_EXITS_PER_MSG = 2


def fabric_op_mcycles(sdk: str, lang: str, nbytes: int) -> float:
    """Total *native* cycles for one SDK GET/PUT of ``nbytes``."""
    fixed, per_mb = _COST_TABLE[(sdk, lang)]
    return fixed + per_mb * (nbytes / MB)


@dataclass(frozen=True)
class FabricCost:
    """Cycle charges for one storage op, split by domain."""

    guest_user: float = 0.0
    guest_kernel: float = 0.0
    host_user: float = 0.0
    host_kernel: float = 0.0
    vm_exits: int = 0
    vcpu_wakeups: int = 0

    def charge(self, acct: M.CycleAccount) -> None:
        if self.guest_user:
            acct.charge(M.GUEST_USER, self.guest_user)
        if self.guest_kernel:
            acct.charge(M.GUEST_KERNEL, self.guest_kernel)
        if self.host_user:
            acct.charge(M.HOST_USER, self.host_user)
        if self.host_kernel:
            acct.charge(M.HOST_KERNEL, self.host_kernel)
        if self.vm_exits:
            acct.cross(M.VM_EXIT, self.vm_exits)
        if self.vcpu_wakeups:
            acct.cross(M.VCPU_WAKEUP, self.vcpu_wakeups)

    def total(self) -> float:
        return (self.guest_user + self.guest_kernel
                + self.host_user + self.host_kernel)


#: thin frontend stub: marshal request params + vsock round trip + map
#: the shared-memory view. Independent of payload size (zero-copy).
STUB_MCYCLES_PER_CALL = 0.09
VSOCK_GUEST_KERNEL_MCYC = 0.04     # virtio-vsock TX/RX in guest kernel
VSOCK_HOST_KERNEL_MCYC = 0.03      # host UDS hop


def rpc_ingress_cost(in_guest: bool, nbytes: int = 4096) -> FabricCost:
    """Invocation RPC handling (gRPC server) per request.

    Coupled design: gRPC server lives in the guest (Python) and every
    request crosses the virtio boundary. Nexus: the backend terminates
    the RPC natively (Go) and forwards a descriptor over vsock.
    """
    if in_guest:
        native = fabric_op_mcycles("tcp", "py", nbytes) * 1.6  # +HTTP/2 framing
        amp = native * (VM_AMPLIFICATION - 1.0)
        exits = VIRTIO_EXITS_PER_OP
        return FabricCost(
            guest_user=native, guest_kernel=amp * 0.55,
            host_kernel=amp * 0.45, vm_exits=exits,
            vcpu_wakeups=int(exits * WAKEUPS_PER_EXIT))
    native = fabric_op_mcycles("tcp", "go", nbytes) * 1.6
    return FabricCost(
        guest_user=STUB_MCYCLES_PER_CALL,
        guest_kernel=VSOCK_GUEST_KERNEL_MCYC,
        host_user=native,
        host_kernel=VSOCK_HOST_KERNEL_MCYC,
        vm_exits=VSOCK_EXITS_PER_MSG, vcpu_wakeups=1)


#: shared backend: fixed + small per-registered-instance state.
BACKEND_BASE_MB = 180.0
BACKEND_PER_INSTANCE_MB = 0.35
