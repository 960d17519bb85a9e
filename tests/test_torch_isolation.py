"""The port stands alone: no jax and no repro in its import graph, and
its entry points never fall back to the CPU on their own."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.launch.serve import NexusModelServer
from repro_torch.models import Model, get_model, serving

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "repro" or n.startswith("repro."))
print("IMPORTED", len([n for n in sys.modules if n.startswith("repro_torch")]))
print("BAD", bad)
print("MODULES", " ".join(sorted(n for n in sys.modules
                                 if n.startswith("repro_torch."))))
"""

#: the copies of the node's planes, which must be in the probe's graph
PLANES = ("repro_torch.core.cache", "repro_torch.core.faults",
          "repro_torch.core.workloads", "repro_torch.core.analysis.verify",
          "repro_torch.core.backend", "repro_torch.core.runtime")


def test_port_imports_no_jax_and_no_reference():
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["IMPORTED"]) >= 20
    assert lines["BAD"] == "[]"
    assert set(PLANES) <= set(lines["MODULES"].split())


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_server_default_device_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NexusModelServer(registry.get_smoke("llama3-8b"))


def test_model_default_device_raises_without_card(no_card):
    cfg = registry.get_smoke("llama3-8b")
    for make in (Model, get_model):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(cfg)


def test_main_default_device_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--requests", "1", "--gen", "1"])


@pytest.mark.parametrize("call", [
    lambda: serving.seed_payloads("LLM-PREFILL"),
    lambda: serving.llm_cold([b""], b""),
    lambda: serving.llm_prefill(b"", b""),
    lambda: serving.llm_decode(b"", b""),
    lambda: serving.emb_encode(b"", b""),
    lambda: serving.moe_infer([b""]),
], ids=["seed_payloads", "llm_cold", "llm_prefill", "llm_decode",
        "emb_encode", "moe_infer"])
def test_serving_cores_default_device_raises_without_card(no_card, call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_cpu_is_used_only_when_asked(no_card):
    model = Model(registry.get_smoke("llama3-8b"), device="cpu")
    assert model.device.type == "cpu"
