"""The port's serve driver on the CPU, and its copies of the host modules.

A port copy of tests/test_distributed_extras.py::TestServingDriver, the
driver's completions against the reference driver's on the reference's
params, and the copied `core` constants against `repro.core`.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.core import fabric as ref_fabric
from repro.core import metrics as ref_metrics
from repro.core import ratelimit as ref_ratelimit
from repro.core import transport as ref_transport
from repro.launch import serve as ref_serve
from repro.launch.serve import NexusModelServer as RefServer
from repro_torch.configs import registry
from repro_torch.core import fabric, metrics, ratelimit, transport
from repro_torch.launch import serve
from repro_torch.launch.serve import NexusModelServer
from repro_torch.models.convert import params_from_numpy

MARGIN = 0.3        # compare tokens only where the top-2 margin exceeds this
ARCHS = ["llama3-8b", "falcon-mamba-7b", "hymba-1.5b", "qwen3-moe-30b-a3b",
         "granite-8b", "yi-34b", "qwen2-72b", "mixtral-8x22b"]


class TestServingDriver:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_batched_requests_end_to_end(self, arch):
        cfg = registry.get_smoke(arch)
        server = NexusModelServer(cfg, transport="rdma", replicas=2,
                                  prompt_len=32, device="cpu")
        rng = np.random.default_rng(0)
        keys = [f"req-{i}" for i in range(4)]
        for k in keys:
            server.seed_prompt(k, rng)
        for inst in server.instances:
            inst.warmup(32)
        futs = [server.submit(k, gen_tokens=4) for k in keys]
        outs = [f.result(timeout=300) for f in futs]
        assert all(o.shape == (4,) for o in outs)
        # completions durably written before the response resolved
        for k in keys:
            assert server.store.head("out", f"{k}-completion").size == 16
        # prompts were prefetched through the backend fast path
        assert server.backend.stats["prefetches"] >= len(keys)
        # the replicas share one params tree
        assert server.instances[0].params is server.instances[1].params


def _serve(server, n, gen):
    rng = np.random.default_rng(0)
    keys = [f"req-{i}" for i in range(n)]
    for k in keys:
        server.seed_prompt(k, rng)
    outs = [server.submit(k, gen).result(timeout=300) for k in keys]
    prompts = [np.frombuffer(server.store.get("prompts", k), np.int32)
               for k in keys]
    return prompts, outs


@pytest.mark.parametrize("arch", ARCHS)
def test_completions_match_reference_where_margin_allows(arch):
    cfg = ref_registry.get_smoke(arch)
    ref = RefServer(cfg, replicas=1, prompt_len=32)
    params = params_from_numpy(jax.tree.map(np.asarray,
                                            ref.instances[0].params))
    port = NexusModelServer(registry.get_smoke(arch), replicas=1,
                            prompt_len=32, device="cpu", params=params)
    prompts, ref_outs = _serve(ref, 3, 6)
    port_prompts, port_outs = _serve(port, 3, 6)
    model = port.instances[0].model
    compared = 0
    for prompt, pp, ref_out, out in zip(prompts, port_prompts, ref_outs,
                                        port_outs):
        np.testing.assert_array_equal(prompt, pp)
        # replay the reference's tokens through the port, reading margins
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(prompt.copy())[None]})
        replay = []
        for ref_tok in ref_out:
            top2 = logits[0, -1].topk(2).values
            tok = int(logits[0, -1].argmax())
            replay.append(tok)
            if float(top2[0] - top2[1]) > MARGIN:
                assert tok == int(ref_tok)
                compared += 1
            logits, cache = model.decode_step(
                params, cache, torch.tensor([[int(ref_tok)]], dtype=torch.int32))
        # the driver generated greedily: it agrees with the replay up to
        # the first token the replay had to force
        for i, (a, b) in enumerate(zip(out, replay)):
            assert a == b, f"token {i}"
            if b != ref_out[i]:
                break
    assert compared >= len(prompts)


@pytest.mark.parametrize("arch", ARCHS)
def test_main_runs_on_cpu(capsys, arch):
    result = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "2", "--gen", "3", "--prompt-len",
                         "16"])
    assert [o.size for o in result["outputs"]] == [3, 3]
    assert result["server"].cfg.name == f"{arch}-smoke"
    assert "2 requests x 3 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-large-v2"])
@pytest.mark.parametrize("smoke", [False, True])
def test_main_refuses_vlm_and_encdec_like_the_reference(monkeypatch, arch,
                                                        smoke):
    """Both drivers serve token LMs only: an ``embed_input`` or
    encoder-decoder arch exits with the same message, before any server
    is built."""
    argv = ["--arch", arch] + (["--smoke"] if smoke else [])
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as ref_exit:
        ref_serve.main()
    with pytest.raises(SystemExit) as port_exit:
        serve.main(argv + ["--device", "cpu"])
    assert str(port_exit.value) == str(ref_exit.value) == \
        "serve driver covers token-LM archs"


def test_copied_core_constants_equal_reference():
    assert set(transport.TRANSPORTS) == set(ref_transport.TRANSPORTS)
    for name, spec in transport.TRANSPORTS.items():
        assert (dataclasses.asdict(spec)
                == dataclasses.asdict(ref_transport.TRANSPORTS[name]))
    assert fabric._COST_TABLE == ref_fabric._COST_TABLE
    for const in ("MB", "VM_AMPLIFICATION", "VIRTIO_EXITS_PER_OP",
                  "WAKEUPS_PER_EXIT", "VSOCK_EXITS_PER_MSG",
                  "STUB_MCYCLES_PER_CALL", "VSOCK_GUEST_KERNEL_MCYC",
                  "VSOCK_HOST_KERNEL_MCYC", "BACKEND_BASE_MB",
                  "BACKEND_PER_INSTANCE_MB"):
        assert getattr(fabric, const) == getattr(ref_fabric, const), const
    assert metrics.DOMAINS == ref_metrics.DOMAINS
    assert (metrics.VM_EXIT, metrics.VCPU_WAKEUP) == (
        ref_metrics.VM_EXIT, ref_metrics.VCPU_WAKEUP)
    assert (ratelimit.DEFAULT_RATE_MBPS, ratelimit.DEFAULT_MAX_DEBT_S,
            ratelimit.MBPS) == (ref_ratelimit.DEFAULT_RATE_MBPS,
                                ref_ratelimit.DEFAULT_MAX_DEBT_S,
                                ref_ratelimit.MBPS)
    for in_guest in (False, True):
        assert (dataclasses.asdict(fabric.rpc_ingress_cost(in_guest))
                == dataclasses.asdict(ref_fabric.rpc_ingress_cost(in_guest)))
