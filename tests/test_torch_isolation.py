"""The port stands alone: no jax and no repro in its import graph, and
its entry points never fall back to the CPU on their own."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import serve, train
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

#: the copies of the node's planes, of the density simulator, of the
#: fleet model and of PlanCheck, the training modules, the FLOPs model
#: and the dry run's modules, and the mesh layer (``parallel``), which
#: must be in the probe's graph
PLANES = ("repro_torch.core.cache", "repro_torch.core.faults",
          "repro_torch.core.workloads", "repro_torch.core.analysis.verify",
          "repro_torch.core.backend", "repro_torch.core.runtime",
          "repro_torch.core.trace", "repro_torch.core.planes",
          "repro_torch.core.fluid", "repro_torch.core.des",
          "repro_torch.core.cluster", "repro_torch.core.analysis.mutate",
          "repro_torch.core.analysis.driver",
          "repro_torch.core.analysis.__main__",
          "repro_torch.optim.adamw", "repro_torch.checkpoint.ckpt",
          "repro_torch.data.pipeline", "repro_torch.launch.train",
          "repro_torch.models.flops", "repro_torch.launch.mesh",
          "repro_torch.launch.sharding", "repro_torch.launch.specs",
          "repro_torch.launch.dryrun", "repro_torch.parallel.collectives",
          "repro_torch.parallel.placement")

_ENV_PROBE = """
import os
before = dict(os.environ)
import repro_torch.launch.dryrun
print("CHANGED", sorted(k for k in set(before) | set(os.environ)
                        if before.get(k) != os.environ.get(k)))
"""


def test_port_imports_no_jax_and_no_reference():
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["IMPORTED"]) >= 20
    assert lines["BAD"] == "[]"
    assert set(PLANES) <= set(lines["MODULES"].split())


def test_dryrun_import_sets_no_environment():
    """The reference's dry run sets XLA_FLAGS when imported; the port's
    sets nothing."""
    env = {"PYTHONPATH": f"{ROOT / 'src'}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", _ENV_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "CHANGED []"


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


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-large-v2"])
def test_vlm_and_encdec_default_device_raises_without_card(no_card, arch):
    """The `Model` facade is these archs' entry point (the serve driver
    refuses them): on the card by default, the CPU only when asked."""
    cfg = registry.get(arch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    assert Model(registry.get_smoke(arch), device="cpu").device.type == "cpu"


def test_main_default_device_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--requests", "1", "--gen", "1"])


def test_train_default_device_raises_without_card(no_card):
    """The train driver's ``--device`` defaults to cuda, and `run` to the
    card: both raise without one, before any step."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1", "--batch", "1", "--seq", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(registry.get_smoke("llama3-8b"), steps=1, batch=1, seq=8)


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
