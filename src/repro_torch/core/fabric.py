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

A copy of ``repro.core.fabric`` without ``working_set_pages`` and
``restore_seconds``, the uniform-fraction variants no port module
calls. Every constant has the reference's value.
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

#: virtio-net doorbells + completion interrupts per MB moved through the
#: guest stack (drives the KVM-exit analogue counter).
VIRTIO_EXITS_PER_MB = 260
VIRTIO_EXITS_PER_OP = 150      # HTTP/2-over-virtio packet storm per op
WAKEUPS_PER_EXIT = 0.7         # I/O exits often block + wake the vCPU
#: Nexus control plane: vsock round-trip = 2 exits (kick + completion).
VSOCK_EXITS_PER_MSG = 2
#: busy guest compute (Python handlers: syscalls, GC, timer ticks, TLB
#: shootdowns) — exits that offloading CANNOT remove; this floor is why
#: the paper's exit reduction is -53%, not -90%.
COMPUTE_EXITS_PER_SEC = 50_000
COMPUTE_WAKEUPS_PER_EXIT = 0.3


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


def in_guest_op_cost(sdk: str, lang: str, nbytes: int) -> FabricCost:
    """Coupled baseline: full SDK inside the VM (paper §2.2).

    The native SDK cost runs in guest-user; virtualization amplification
    (x2 total) is paid in guest-kernel (guest net stack + virtio front)
    and host-kernel (vhost/tap + KVM), per Fig 2a's kernel split.
    """
    native = fabric_op_mcycles(sdk, lang, nbytes)
    amp = native * (VM_AMPLIFICATION - 1.0)
    mb = nbytes / MB
    exits = int(VIRTIO_EXITS_PER_OP + VIRTIO_EXITS_PER_MB * mb)
    return FabricCost(
        guest_user=native,
        guest_kernel=amp * 0.55,
        host_kernel=amp * 0.45,
        vm_exits=exits,
        vcpu_wakeups=int(exits * WAKEUPS_PER_EXIT),
    )


#: thin frontend stub: marshal request params + vsock round trip + map
#: the shared-memory view. Independent of payload size (zero-copy).
STUB_MCYCLES_PER_CALL = 0.09
VSOCK_GUEST_KERNEL_MCYC = 0.04     # virtio-vsock TX/RX in guest kernel
VSOCK_HOST_KERNEL_MCYC = 0.03      # host UDS hop


def remoted_op_cost(sdk: str, nbytes: int, backend_lang: str = "go") -> FabricCost:
    """Nexus path: stub in guest, SDK in the shared Go backend (§4.3.2).

    Transport (TCP/RDMA) cycles are charged separately by the transport
    model — this covers SDK execution + control-plane hop only. Bulk
    bytes move through shared memory: zero copies, zero per-byte guest
    cycles.
    """
    backend = fabric_op_mcycles(sdk, backend_lang, nbytes)
    return FabricCost(
        guest_user=STUB_MCYCLES_PER_CALL,
        guest_kernel=VSOCK_GUEST_KERNEL_MCYC,
        host_user=backend,
        host_kernel=VSOCK_HOST_KERNEL_MCYC,
        vm_exits=VSOCK_EXITS_PER_MSG,
        vcpu_wakeups=1,
    )


def in_process_op_cost(sdk: str, lang: str, nbytes: int) -> FabricCost:
    """WASM-hypervisor reference point (paper Fig 14, Faasm): the fabric
    is compiled into the sandbox (C++ ~ Go cost class) and there is no
    virtualization boundary — native cycles, zero amplification, zero
    exits. Faabric's sandbox-bootstrap page-fault storm is charged
    separately, per invocation (`FAABRIC_KERNEL_MCYC`)."""
    return FabricCost(guest_user=fabric_op_mcycles(sdk, lang, nbytes))


# --------------------------------------------------- Faasm/WASM calibration
# Paper Fig 14 footnotes: the AES workload is a C++ port (WASM-compiled
# native code ~2x the Python handler's speed, less ~12% WASM-JIT tax);
# Faabric's sandbox bootstrap page-faults heavily in the host kernel,
# which is why Faasm's TOTAL cycles exceed Nexus despite lower latency.

CPP_COMPUTE_SCALE = 0.5        # C++ handler vs the Python reference
WASM_JIT_OVERHEAD = 1.12       # WASM-JIT vs native C++
WASM_COMPUTE_SCALE = CPP_COMPUTE_SCALE * WASM_JIT_OVERHEAD
FAABRIC_KERNEL_MCYC = 75.0     # page-fault storm per invocation
WASM_RUNTIME_MB = 20.0         # runtime + module memory
WASM_WORKLOAD_SCALE = 0.35     # no interpreter heap bloat
SANDBOX_DISPATCH_S = 0.003     # Faabric scheduling hop per invocation


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


# ------------------------------------------------------ memory calibration
# Paper Fig 3: mean per-instance RSS 169 MB; SDK 19%, RPC 5%.

GUEST_OS_MB = 52.0          # kernel + init + rootfs page cache
RUNTIME_BASE_MB = 24.0      # CPython + stdlib
RPC_LIB_MB = 8.5            # grpcio + HTTP/2 server state
CLOUD_SDK_MB = 32.0         # boto3 + botocore + urllib3 + TLS
FRONTEND_STUB_MB = 1.6      # Nexus thin frontend (645 LoC + vsock shim)
VSOCK_SHIM_MB = 0.9         # retained control-plane endpoint

#: shared backend: fixed + small per-registered-instance state.
BACKEND_BASE_MB = 180.0
BACKEND_PER_INSTANCE_MB = 0.35


def instance_memory(workload_mb: float, system: str) -> M.MemoryAccount:
    """Per-instance RSS under a given system variant.

    system: 'baseline' | 'nexus-sdk-only' | 'nexus' (full fabric offload;
    async/rdma variants have identical per-instance footprints) |
    'wasm' (no guest OS or interpreter: sandbox runtime + module only).
    """
    acct = M.MemoryAccount()
    if system == "wasm":
        acct.add("wasm_runtime", WASM_RUNTIME_MB)
        acct.add("workload", workload_mb * WASM_WORKLOAD_SCALE)
        return acct
    acct.add("guest_os", GUEST_OS_MB)
    acct.add("runtime", RUNTIME_BASE_MB)
    acct.add("workload", workload_mb)
    if system == "baseline":
        acct.add("rpc_lib", RPC_LIB_MB)
        acct.add("cloud_sdk", CLOUD_SDK_MB)
    elif system == "nexus-sdk-only":
        acct.add("rpc_lib", RPC_LIB_MB)
        acct.add("frontend_stub", FRONTEND_STUB_MB)
    elif system == "nexus":
        acct.add("frontend_stub", FRONTEND_STUB_MB)
        acct.add("vsock_shim", VSOCK_SHIM_MB)
    else:
        raise ValueError(system)
    return acct


# ---------------------------------------------------- snapshot / cold start
#: REAP-style working-set restore (paper §6, Figs 12-13). The recorded
#: working set is NOT a uniform slice of RSS: fabric code+TLS state is
#: touched on every startup (hot), while workload libs/data fault in
#: partially — which is why removing ~22% of RSS cuts ~31% of the pages
#: REAP must insert (paper Fig 13).
PAGE_KB = 4.0
WS_FRACTION = 0.62          # fallback uniform fraction
_WS_BY_COMPONENT = {
    "guest_os": 0.50, "runtime": 0.70, "rpc_lib": 0.92, "cloud_sdk": 0.92,
    "frontend_stub": 0.92, "vsock_shim": 0.92, "workload": 0.55,
    "wasm_runtime": 0.92,          # module instantiation touches it all
}
RESTORE_US_PER_PAGE = 1.9   # disk read + map + fault cost per page
SNAPSHOT_FIXED_S = 0.012    # uVM create + vcpu resume


def working_set_pages_components(mem: M.MemoryAccount) -> int:
    mb = sum(v * _WS_BY_COMPONENT.get(k, WS_FRACTION)
             for k, v in mem.components.items())
    return int(mb * 1024 / PAGE_KB)


def restore_seconds_components(mem: M.MemoryAccount) -> float:
    return (SNAPSHOT_FIXED_S
            + working_set_pages_components(mem) * RESTORE_US_PER_PAGE * 1e-6)
