"""The port's dry run (`repro_torch.launch.dryrun`): its meta-device pass
against the same step on CPU tensors, the depth extrapolation against
the full pass, the record and the command line.

The per-device argument bytes and every spec are held against the
reference in tests/test_torch_sharding.py.
"""
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_IDS, SHAPES, InputShape, all_cells,
                                 cell_is_runnable, registry)
from repro_torch.kernels.flash_attention import ref as attention_ref
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP
from repro_torch.models import Model, mamba
from repro_torch.models import kv_cache as kvc
from repro_torch.optim import adamw_init
from repro_torch.parallel import placement as P

RUNNABLE = [(a, s) for a, s in all_cells()
            if cell_is_runnable(registry.get(a), SHAPES[s])[0]]


# ------------------------------------------------------------ the meta pass

SMOKE_SHAPES = {"train": InputShape("train", 32, 2, "train"),
                "prefill": InputShape("prefill", 32, 2, "prefill"),
                "decode": InputShape("decode", 40, 2, "decode")}


def _cpu_args(cfg, shape):
    """The step's inputs as CPU tensors at a smoke config: seeded params,
    random tokens and embeddings, a zero cache."""
    params = Model(cfg, device="cpu").init_params()
    rng = np.random.default_rng(0)
    B, S = shape.global_batch, shape.seq_len

    def tokens(*dims):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, dims,
                                             dtype=np.int32))

    def embeds():
        return torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)

    if shape.kind == "decode":
        cache = kvc.init_cache(cfg, B, S)
        return {"params": params, "cache": cache, "token": tokens(B, 1)}
    if cfg.is_encoder_decoder:
        batch = {"src_embeds": embeds(), "tgt_tokens": tokens(B, S)}
    elif cfg.embed_input:
        batch = {"inputs_embeds": embeds()}
    else:
        batch = {"tokens": tokens(B, S)}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch}
    batch["targets"] = tokens(B, S)
    return {"state": adamw_init(params), "batch": batch}


@pytest.fixture
def one_thread():
    """Smoke-size CPU passes gain nothing from intra-op threads, and
    beside other test workers their threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_pass_counts_the_cpu_pass(monkeypatch, one_thread, arch, kind):
    """At a smoke config the meta pass's FlopCounterMode count (one block
    of rows and of scan steps) equals the same step's count on CPU
    tensors with the plain attention in row blocks of 4 and the plain
    scan in chunks of 8: the meta pass is the real computation."""
    cfg, shape = registry.get_smoke(arch), SMOKE_SHAPES[kind]
    meta = dryrun.meta_passes(cfg, shape, True)
    assert meta["by"] == dryrun.FULL_PASS
    (depth, outputs, meta_flops), = meta["depths"]
    assert depth == cfg.num_layers and meta_flops > 0
    heads = max(cfg.num_heads, 1)
    monkeypatch.setattr(attention_ref, "SCORE_ELEMS",
                        4 * shape.global_batch * heads * shape.seq_len)
    monkeypatch.setattr(mamba, "SCAN_CHUNK", 8)
    args = _cpu_args(cfg, shape)
    with FlopCounterMode(display=False) as counter:
        cpu_outputs = dryrun.run_step(cfg, shape, args)
    assert counter.get_total_flops() == meta_flops
    mesh = M.make_debug_mesh()
    assert (dryrun.output_bytes(shape, cpu_outputs, mesh)
            == dryrun.output_bytes(shape, outputs, mesh))
    assert attention_ref.SCORE_ELEMS != 1 << 62


# --------------------------------------------------------- the command line

def test_record_of_a_cell():
    """One record: the reference's keys where there is a counterpart, the
    analytic figures over the mesh's devices, and the one-device mesh."""
    rec = dryrun.run_cell("llama3-8b", "train_4k")
    assert {k: rec[k] for k in ("arch", "shape", "mesh", "step", "devices",
                                "flops_by")} == {
        "arch": "llama3-8b", "shape": "train_4k", "mesh": "16x16",
        "step": "train_step", "devices": 256,
        "flops_by": dryrun.ONE_LAYER}
    mem = rec["memory"]
    assert set(mem) == {"argument_B", "output_B", "arguments_B"}
    assert mem["argument_B"] == sum(mem["arguments_B"].values())
    # train: the state comes back in its own layout, with 4 f32 metrics
    assert mem["output_B"] == mem["arguments_B"]["state"] + 4 * 4
    assert rec["flops_per_device"] > rec["model_flops_per_device"] > 0
    one = dryrun.run_cell("llama3-8b", InputShape("train", 4096, 2, "train"),
                          extra={"num_layers": 2}, mesh=M.make_debug_mesh())
    assert (one["mesh"], one["devices"], one["shape"]) == ("1x1", 1, "train")
    cfg = registry.get("llama3-8b").replace(num_layers=2)
    n = cfg.param_count()
    params = SP.param_specs(cfg)
    f32 = sum(x.numel() for _, x in P.leaves_with_paths(params)
              if x.dtype == torch.float32)
    assert one["memory"]["arguments_B"]["state"] == 2 * (n - f32) \
        + 4 * f32 + 8 * n + 4
    with pytest.raises(SystemExit, match="skip"):
        dryrun.run_cell("llama3-8b", "long_500k")


def test_main_one_cell(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    recs = dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                        "--out", str(out)])
    lines = out.read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == recs[0]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == recs[0]
    rec = recs[0]
    assert (rec["step"], rec["mesh"], rec["devices"]) == ("serve_step",
                                                          "16x16", 256)
    assert set(rec["memory"]["arguments_B"]) == {"params", "cache", "token"}
    recs = dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                        "--multi-pod", "--out", str(out), "--extra",
                        '{"num_layers": 4}'])
    assert (recs[0]["mesh"], recs[0]["extra"]) == ("2x16x16",
                                                   {"num_layers": 4})
    assert len(out.read_text().splitlines()) == 2


def test_main_all_skips_done_cells_and_records_errors(tmp_path,
                                                      monkeypatch):
    """``--all`` skips what ``--out`` holds and writes an ``error`` record
    for a cell whose pass raises, then goes on."""
    cells = [("llama3-8b", "decode_32k", False),
             ("llama3-8b", "decode_32k", True),
             ("falcon-mamba-7b", "long_500k", False)]
    monkeypatch.setattr(dryrun, "cells_to_run", lambda: cells)
    out = tmp_path / "all.jsonl"
    out.write_text(json.dumps({"arch": "llama3-8b", "shape": "decode_32k",
                               "mesh": "16x16"}) + "\n")
    real = dryrun.run_step

    def run_step(cfg, shape, args):
        if cfg.family == "ssm":
            raise NotImplementedError("aten::fake_op has no meta kernel")
        return real(cfg, shape, args)

    monkeypatch.setattr(dryrun, "run_step", run_step)
    recs = dryrun.main(["--all", "--out", str(out)])
    assert [(r["arch"], r["mesh"]) for r in recs] == [
        ("llama3-8b", "2x16x16"), ("falcon-mamba-7b", "16x16")]
    assert "error" not in recs[0]
    assert "aten::fake_op" in recs[1]["error"][-1]
    assert len(out.read_text().splitlines()) == 3


def test_main_all_single_pod_only_leaves_out_the_multipod_cells(
        tmp_path, monkeypatch, capsys):
    """``--all --single-pod-only``, in the reference's order: a done cell
    still prints "skip (done)", whatever its mesh, and a 2x16x16 cell
    that is not done is left out without a line."""
    cells = [("llama3-8b", "decode_32k", False),
             ("llama3-8b", "decode_32k", True),
             ("granite-8b", "decode_32k", True),
             ("granite-8b", "decode_32k", False)]
    monkeypatch.setattr(dryrun, "cells_to_run", lambda: cells)
    out = tmp_path / "all.jsonl"
    out.write_text(json.dumps({"arch": "llama3-8b", "shape": "decode_32k",
                               "mesh": "2x16x16"}) + "\n")
    ran = []
    monkeypatch.setattr(dryrun, "run_cell", lambda arch, shape, multi_pod,
                        extra: ran.append((arch, multi_pod)) or {
                            "arch": arch, "shape": shape, "mesh": "16x16"})
    recs = dryrun.main(["--all", "--single-pod-only", "--out", str(out)])
    assert ran == [("llama3-8b", False), ("granite-8b", False)]
    assert [r["arch"] for r in recs] == ["llama3-8b", "granite-8b"]
    lines = [line.rsplit(" ", 1)[0] if line.endswith("s") and not
             line.endswith("(done)") else line
             for line in capsys.readouterr().out.splitlines()]
    assert lines == ["[1/4] llama3-8b decode_32k 16x16",
                     "[2/4] llama3-8b decode_32k 2x16x16 skip (done)",
                     "[4/4] granite-8b decode_32k 16x16"]
    assert len(out.read_text().splitlines()) == 3


def test_cells_to_run_are_the_runnable_cells_on_both_meshes():
    cells = dryrun.cells_to_run()
    assert cells == [(a, s, m) for a, s in RUNNABLE for m in (False, True)]
    assert len(cells) == 66

