"""The port's MLServe serving cores and calibration copy against the
reference (`repro.models.serving`, `repro.core.calibrate`).

The port's seeded params cannot be the reference's (``PRNGKey(0)``), so
the cores are held against the reference's cores on the reference's own
``seed_payloads`` bytes. Tolerances, as the whole-model tests state them:

* logits and float cache leaves: atol 0.3, rtol 0.05 (bf16, as
  tests/test_models.py);
* integer leaves (``pos``, ``slot_pos``), lengths, prompt payloads:
  exactly;
* greedy tokens: equal wherever the reference's top-2 margin exceeds
  ``MARGIN`` (0.3, the logits' tolerance); a token under that margin may
  flip, and then only what the flip does not reach is compared;
* MoE routing: a different expert is excused only at a router margin
  within 2e-2 (`test_torch_model.RoutingSpy`).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import calibrate as ref_calibrate
from repro.core import fabric as ref_fabric
from repro.models import serialize as ref_serialize
from repro.models import serving as ref_serving
from repro_torch.configs import registry
from repro_torch.core import calibrate, fabric
from repro_torch.models import serialize, serving
from test_torch_model import ROUTE_TOL, RoutingSpy

TOL = dict(atol=0.3, rtol=0.05)
MARGIN = 0.3
SCENARIOS = list(serving.SCENARIO_INPUTS)
PAIRS = [(scale, role) for scale in calibrate.SCALES
         for role in calibrate.ML_ROLES]
#: the durable output of each scenario, as its calibration key
OUT_KEY = {"LLM-COLD": "cold_out_bytes", "LLM-PREFILL": "kv_prefill_bytes",
           "LLM-DECODE": "kv_out_bytes", "EMB": "emb_bytes",
           "MOE": "moe_out_bytes"}


@functools.lru_cache(maxsize=None)
def _ref_payloads(scenario):
    return tuple(ref_serving.seed_payloads(scenario))


@functools.lru_cache(maxsize=None)
def _port_payloads(scenario):
    return tuple(serving.seed_payloads(scenario, device="cpu"))


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _output(scenario, body):
    return serving.load_output(scenario, body, device="cpu")


def _assert_cache_close(cache, rcache):
    assert set(cache) == set(rcache)
    for key in cache:
        a, b = cache[key], rcache[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if a.dtype == torch.int32:
            assert torch.equal(a, b), key
        else:
            np.testing.assert_allclose(_np(a), _np(b), **TOL, err_msg=key)


def _assert_close_unless_excused(out, ref, flipped):
    """Logits within TOL; where a discrete choice flipped at a margin
    within its tolerance (``flipped``), a disagreement is excused and
    printed, and agreement is still checked."""
    out, ref = _np(out), _np(ref)
    if flipped and not np.allclose(out, ref, **TOL):
        print(f"excused by the flip: max |diff| {np.abs(out - ref).max()}")
        return
    np.testing.assert_allclose(out, ref, **TOL)


class TokenSpy:
    """The logits and token of every `_next_token` call, in both
    packages."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        for mod, seen in ((ref_serving, self.ref), (serving, self.port)):
            def spy(logits, orig=mod._next_token, seen=seen):
                tok = orig(logits)
                seen.append((_np(logits[:, -1]), np.asarray(tok)))
                return tok
            monkeypatch.setattr(mod, "_next_token", spy)

    def same_tokens(self):
        """Every call's logits within TOL; True if every token agrees,
        False if a token flipped at a margin within MARGIN (a flip past
        it fails)."""
        assert len(self.ref) == len(self.port) > 0
        same = True
        for (rl, rt), (pl, pt) in zip(self.ref, self.port):
            np.testing.assert_allclose(pl, rl, **TOL)
            top = -np.sort(-rl, axis=-1)
            margin = top[:, 0] - top[:, 1]
            print(f"top-2 margin of the reference's logits {margin}, "
                  f"tokens {rt.ravel()} / {pt.ravel()}")
            for b in np.flatnonzero(rt.ravel() != pt.ravel()):
                assert margin[b] <= MARGIN, f"row {b} flipped at {margin[b]}"
                same = False
        return same


# ------------------------------------------------------- calibrate copy

def test_calibrate_constants_equal_reference():
    for name in ("CALIBRATION_VERSION", "ML_ROLES", "SERVING_SHAPES",
                 "ROLE_SHARDS", "LLM_WEIGHT_SHARDS", "MOE_SHARDS", "SCALES",
                 "PHASES"):
        assert getattr(calibrate, name) == getattr(ref_calibrate, name), name
    assert fabric.GHZ_MCYC_PER_S == ref_fabric.GHZ_MCYC_PER_S
    assert set(calibrate.MACHINES) == set(ref_calibrate.MACHINES)
    for scale, machine in calibrate.MACHINES.items():
        ref = ref_calibrate.MACHINES[scale]
        assert dataclasses.asdict(machine) == dataclasses.asdict(ref)
        for flops, nbytes in ((1e12, 1e9), (3e9, 7e10), (0.0, 0.0)):
            assert machine.seconds(flops, nbytes) == ref.seconds(flops, nbytes)
            assert machine.mcycles(flops, nbytes) == ref.mcycles(flops, nbytes)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 7])
def test_shard_bytes_equals_reference(shards):
    for total in (shards, shards + 1, 853_248, 774_913, 16_060_522_497):
        assert (calibrate.shard_bytes(total, shards)
                == ref_calibrate.shard_bytes(total, shards))
    with pytest.raises(ValueError):
        calibrate.shard_bytes(shards - 1, shards)


def test_calibration_json_is_byte_identical():
    with open(calibrate.CALIBRATION_PATH, "rb") as a, \
            open(ref_calibrate.CALIBRATION_PATH, "rb") as b:
        assert a.read() == b.read()
    assert calibrate.load_calibration() == ref_calibrate.load_calibration()
    assert (calibrate.load_calibration(calibrate.CALIBRATION_PATH)
            == calibrate.load_calibration())
    with pytest.raises(KeyError, match="no calibration for huge/llm"):
        calibrate.model_entry("huge", "llm")


@pytest.mark.parametrize("scale,role", PAIRS)
def test_role_sizes_equal_committed_entries(scale, role):
    """The port's shape arithmetic (a meta-device run) gives every byte
    size the reference's calibration committed, per device of its slice:
    8 devices at full scale, 1 at tiny."""
    arch = calibrate.ML_ROLES[role]
    cfg = registry.get(arch) if scale == "full" else registry.get_smoke(arch)
    sizes = serving.role_sizes(cfg, devices=calibrate.MACHINES[scale].devices)
    entry = calibrate.model_entry(scale, role)
    assert entry["arch"] == cfg.name and entry["family"] == cfg.family
    assert sizes == {k: entry[k] for k in sizes}
    if role in calibrate.ROLE_SHARDS:
        assert entry["weights_shard_bytes"] == calibrate.shard_bytes(
            sizes["params_bytes"], calibrate.ROLE_SHARDS[role])


def test_full_llm_sizes_on_one_device():
    """llama3-8b at full width on one device: 16.06 GB of params and a
    2.15 GB decode state (8 x 2048 slots of 32 layers' K and V, their
    slot positions, the positions and the next tokens)."""
    sizes = serving.role_sizes(registry.get("llama3-8b"))
    assert sizes["params_bytes"] == 16_060_522_496
    kv = 2 * 32 * 8 * 2048 * 8 * 128 * 2
    assert sizes["kv_in_bytes"] == kv + 8 * 2048 * 4 + 8 * 4 + 8 * 4
    assert sizes["kv_prefill_bytes"] == 268_443_652


def test_unknown_scale_raises():
    with pytest.raises(ValueError, match="scale 'huge'"):
        serving._bundle("llm", "huge")


# ------------------------------------------------------------ seed payloads

@pytest.mark.parametrize("scenario", SCENARIOS)
def test_seed_payloads_match_reference(scenario):
    """The same number and lengths of payloads as the reference's, the
    calibrated tiny sizes, and prompts byte for byte."""
    role, kinds = serving.SCENARIO_INPUTS[scenario]
    assert (role, kinds) == ref_serving.SCENARIO_INPUTS[scenario]
    ref, port = _ref_payloads(scenario), _port_payloads(scenario)
    assert [len(p) for p in port] == [len(p) for p in ref]
    entry = calibrate.model_entry("tiny", role)
    sizes = serving.role_sizes(serving._bundle(role)["cfg"])
    want = {"weights": None, "params": sizes["params_bytes"],
            "prompt": entry["prompt_bytes"], "kv": entry["kv_in_bytes"],
            "enc_tokens": entry["enc_tokens_bytes"]}
    shards = iter(entry.get("weights_shard_bytes", []))
    for kind, body, rbody in zip(kinds, port, ref):
        assert len(body) == (next(shards) if kind == "weights"
                             else want[kind]), kind
        if kind in ("prompt", "enc_tokens"):
            assert body == rbody, kind
    if "weights" in kinds:     # the shards split one params blob
        assert (sum(len(p) for k, p in zip(kinds, port) if k == "weights")
                == entry["params_bytes"])


@pytest.mark.parametrize("role", list(calibrate.ML_ROLES))
def test_seed_role_equals_seed_payloads(role):
    """One draw for all of a role's scenarios gives each scenario's
    payloads byte for byte, sharing one params blob."""
    both = serving.seed_role(role, device="cpu")
    assert sorted(both) == sorted(s for s, (r, _) in
                                  serving.SCENARIO_INPUTS.items() if r == role)
    for scenario, payloads in both.items():
        assert tuple(payloads) == _port_payloads(scenario), scenario
    blobs = {id(p) for s, ps in both.items() for k, p in
             zip(serving.SCENARIO_INPUTS[s][1], ps) if k == "params"}
    assert len(blobs) <= 1
    # weight shards are views of that blob, not copies
    shards = [p for s, ps in both.items() for k, p in
              zip(serving.SCENARIO_INPUTS[s][1], ps) if k == "weights"]
    assert all(isinstance(p, memoryview) for p in shards)
    if shards and blobs:
        assert {id(p.obj) for p in shards} == blobs
    with pytest.raises(ValueError, match="not all scenarios of"):
        serving.seed_role(role, ["LLM-COLD", "EMB"], device="cpu")


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_cores_give_calibrated_lengths_on_port_payloads(scenario):
    role = serving.SCENARIO_INPUTS[scenario][0]
    timings = {}
    out = serving.run_scenario(scenario, _port_payloads(scenario),
                               device="cpu", timings=timings)
    body = out[0] if scenario == "LLM-DECODE" else out
    assert len(body) == calibrate.model_entry("tiny", role)[OUT_KEY[scenario]]
    assert set(timings) == {"decode", "forward", "encode"}
    assert all(t >= 0 for t in timings.values())


# ------------------------------------------------- cores on reference bytes

def test_llm_cold_matches_reference(monkeypatch):
    payloads = _ref_payloads("LLM-COLD")
    spy = TokenSpy(monkeypatch)
    ref = ref_serving.llm_cold(payloads[:-1], payloads[-1])
    out = serving.llm_cold(payloads[:-1], payloads[-1], device="cpu")
    assert len(out) == len(ref)
    _assert_close_unless_excused(_output("LLM-COLD", out),
                                 _output("LLM-COLD", ref),
                                 not spy.same_tokens())


def test_llm_prefill_matches_reference():
    payloads = _ref_payloads("LLM-PREFILL")
    ref = ref_serving.llm_prefill(*payloads)
    out = serving.llm_prefill(*payloads, device="cpu")
    assert len(out) == len(ref)
    _assert_cache_close(_output("LLM-PREFILL", out),
                        _output("LLM-PREFILL", ref))


def test_llm_decode_matches_reference(monkeypatch):
    payloads = _ref_payloads("LLM-DECODE")
    spy = TokenSpy(monkeypatch)
    ref, rtok = ref_serving.llm_decode(*payloads)
    out, tok = serving.llm_decode(*payloads, device="cpu")
    assert len(out) == len(ref) and isinstance(tok, int)
    _assert_cache_close(_output("LLM-DECODE", out),
                        _output("LLM-DECODE", ref))
    if spy.same_tokens():
        assert tok == rtok


def test_emb_encode_matches_reference():
    payloads = _ref_payloads("EMB")
    ref = ref_serving.emb_encode(*payloads)
    out = serving.emb_encode(*payloads, device="cpu")
    assert len(out) == len(ref)
    np.testing.assert_allclose(_np(_output("EMB", out)),
                               _np(_output("EMB", ref)), **TOL)


def test_moe_infer_matches_reference(monkeypatch):
    """The port's expert-shard fan-in on the reference's shards. The
    reference's routing is recorded from its model's prefill on the same
    params and prompt (its cores' compiled prefill may predate the spy);
    a flip at a margin within ``ROUTE_TOL`` excuses the whole prompt
    (the sorted dispatch's capacity couples its rows)."""
    payloads = _ref_payloads("MOE")
    ref = ref_serving.moe_infer(payloads)
    serving._bundle("moe")          # its meta-device pass before the spy
    spy = RoutingSpy(monkeypatch)
    b = ref_serving._bundle("moe")
    b["model"].prefill(ref_serving._load_params("moe", b"".join(payloads)),
                       {"tokens": ref_serving._prompt_tokens("moe")})
    out = serving.moe_infer(payloads, device="cpu")
    assert len(out) == len(ref)
    cfg = serving._bundle("moe")["cfg"]
    flipped = spy.flipped_rows(cfg.num_experts_per_tok, 1,
                               ROUTE_TOL[cfg.dtype], coupled=True)
    print(f"smallest routing margin per layer {spy.margins}; flipped "
          f"{sorted(flipped)}")
    _assert_close_unless_excused(_output("MOE", out),
                                 _output("MOE", ref),
                                 bool(flipped))


def test_decode_kv_round_trip_is_bit_exact():
    """The port reads the reference's (cache, token) payload and writes
    it back byte for byte; its decode core is a function of the bytes
    alone (the in-place cache update never reaches the caller's
    payload)."""
    params, kv = _ref_payloads("LLM-DECODE")
    st = serving._bundle("llm")["structs"]
    tree = serialize.loads((st["decode_cache"], st["step_token"]), kv)
    assert serialize.dumps(tree) == kv
    cache, token = ref_serving.llm_decode(params, kv)
    ref_tree = ref_serialize.loads(
        (ref_serving._bundle("llm")["structs"]["decode_cache"],
         ref_serving._bundle("llm")["structs"]["step_token"]), kv)
    assert serialize.dumps(tree) == ref_serialize.dumps(ref_tree)
    first = serving.llm_decode(params, kv, device="cpu")
    assert serving.llm_decode(params, kv, device="cpu") == first
    assert len(first[0]) == len(cache)


def test_prompt_tokens_are_the_reference_progression():
    for role, which in (("llm", "prompt"), ("llm", "decode_tokens"),
                        ("emb", "enc_tokens"), ("moe", "prompt")):
        port = serving._prompt_tokens(role, which)
        ref = ref_serving._prompt_tokens(role, which)
        assert port.dtype == torch.int32
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    logits = torch.tensor([[[0.0, 2.0, 2.0, 1.0]], [[5.0, 0.0, 5.0, 0.0]]])
    assert serving._next_token(logits).tolist() == np.asarray(
        ref_serving._next_token(jax.numpy.asarray(logits.numpy()))).tolist()
