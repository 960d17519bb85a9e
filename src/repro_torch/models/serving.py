"""MLServe model plumbing: shape structs, seed payloads, handler cores.

The counterpart of ``repro.models.serving``, in the same order. A core
takes a function's inputs as the serialized payloads storage hands it
(weight shards or a whole params blob, a prompt, a KV state), decodes
them onto the device, runs the forward pass there, and returns the bytes
of its durable output, encoded with the byte-identical codec of
`repro_torch.models.serialize`.

The positional arguments and the return values are the reference's.
Each core, and `seed_payloads` (`seed_role`: several scenarios of one
role from one params blob), also takes keyword-only arguments:

* ``scale`` — ``"tiny"`` (the SMOKE configs, as the reference's cores
  always run) or ``"full"`` (the published configs, at the full-scale
  serving shapes of the calibration, on one device);
* ``device`` — where the tensors live: the card by default, raising
  without one; ``"cpu"`` only when asked;
* ``plain`` (cores only) — run the kernels' plain versions instead of the
  kernels;
* ``timings`` (cores only) — a dict the core fills with the wall seconds
  of its three steps: ``decode`` (payloads to tensors on the device),
  ``forward`` (synchronised) and ``encode`` (outputs to bytes).

Shape structs come from a meta-device run with ``plain=True`` (the
counterpart of ``jax.eval_shape``: the kernels' wrappers refuse meta
tensors). Prompts are the reference's arithmetic progression, so their
payloads are byte-identical to the reference's. The seeded params are
the port's own (the port cannot draw the reference's ``PRNGKey(0)``
tensors): the same sizes, other values. They are drawn at each
`seed_role` call and dropped when it returns; unlike the reference's
bundle, `_bundle` caches only the config and the structs, so at full
scale no seeded params tree stays on the card beside the params a core
decodes.

The port's decode updates the cache in place (`repro_torch.models.lm`):
`llm_cold` steps the cache its own prefill built, and every core decodes
its own tensors from the bytes it is given, so two calls on the same
bytes give the same bytes.
"""
from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.calibrate import (LLM_WEIGHT_SHARDS, ML_ROLES,
                                        MOE_SHARDS, SERVING_SHAPES,
                                        shard_bytes)
from repro_torch.device import resolve_device
from repro_torch.models import lm, serialize

#: scenario name -> (role, list of payload kinds in IOProfile GET order)
SCENARIO_INPUTS = {
    "LLM-COLD": ("llm", ["weights"] * LLM_WEIGHT_SHARDS + ["prompt"]),
    "LLM-PREFILL": ("llm", ["params", "prompt"]),
    "LLM-DECODE": ("llm", ["params", "kv"]),
    "EMB": ("emb", ["params", "enc_tokens"]),
    "MOE": ("moe", ["weights"] * MOE_SHARDS),
}
#: scenario name -> the struct of its durable output
SCENARIO_OUTPUT = {
    "LLM-COLD": "cold_logits",
    "LLM-PREFILL": "prefill_cache",
    "LLM-DECODE": "decode_cache_out",
    "EMB": "emb_logits",
    "MOE": "moe_logits",
}


# ----------------------------------------------------------- shape structs

def _token_struct(B: int, S: int):
    return serialize.struct((B, S), torch.int32)


def _as_structs(tree):
    """A tree of tensors as a tree of fresh structs of the same shapes."""
    if isinstance(tree, dict):
        return {k: _as_structs(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_as_structs(v) for v in tree)
    return serialize.struct(tree.shape, tree.dtype)


@functools.lru_cache(maxsize=None)
def _structs_for(cfg):
    """All shape trees one role needs, from one meta-device pass set.

    Returns a dict of struct trees keyed by struct name. Cached per
    config — configs are frozen dataclasses (hashable).
    """
    shapes = SERVING_SHAPES["tiny" if cfg.name.endswith("-smoke")
                            else "full"]
    (Bp, Sp), (Bd, Sd), (Be, Se) = (shapes["prefill"], shapes["decode"],
                                    shapes["encode"])
    params = lm.param_structs(cfg)
    tok_p, tok_d, tok_e = (_token_struct(Bp, Sp), _token_struct(Bd, Sd),
                           _token_struct(Be, Se))

    def prefill(tokens):
        return lm.prefill(cfg, params, {"tokens": tokens}, plain=True)

    def step(cache, token):
        return _as_structs(lm.decode_step(cfg, params, cache, token,
                                          plain=True))

    logits_p, cache_p = prefill(tok_p)
    _, cache_d = prefill(tok_d)
    step_tok = _token_struct(Bd, 1)
    cold_tok = _token_struct(Bp, 1)
    structs = {
        "params": params,
        "prompt": tok_p,
        "decode_tokens": tok_d,             # seeds the decode-shaped KV
        "enc_tokens": tok_e,
        "prefill_cache": cache_p,           # LLM-PREFILL durable PUT
        "decode_cache": cache_d,            # LLM-DECODE GET (w/ token)
        "step_token": step_tok,
        "moe_logits": logits_p,             # MOE durable PUT
        "emb_logits": prefill(tok_e)[0],    # EMB durable PUT
    }
    structs = _as_structs(structs)
    # the decode steps last: they update their meta caches in place
    structs["decode_cache_out"] = step(cache_d, step_tok)[1]
    structs["cold_logits"] = step(cache_p, cold_tok)[0]
    return structs


def role_sizes(cfg, devices: int = 1) -> dict:
    """Exact per-device serialized byte sizes for one calibrated role.

    At tiny scale (``devices=1``, SMOKE config) these are the byte-exact
    sizes of the payloads the cores read and write; at full scale the
    same shape arithmetic over the published config, divided across the
    serving slice. The serving shapes are implied by the config (see
    `_structs_for`).
    """
    st = _structs_for(cfg)
    n = serialize.tree_nbytes
    return {
        "params_bytes": n(st["params"]) // devices,
        "prompt_bytes": n(st["prompt"]),
        "enc_tokens_bytes": n(st["enc_tokens"]),
        "token_bytes": n(st["step_token"]),
        "kv_prefill_bytes": n(st["prefill_cache"]) // devices,
        "kv_in_bytes": (n(st["decode_cache"]) // devices
                        + n(st["step_token"])),
        "kv_out_bytes": n(st["decode_cache_out"]) // devices,
        "cold_out_bytes": n(st["cold_logits"]),
        "emb_bytes": n(st["emb_logits"]),
        "moe_out_bytes": n(st["moe_logits"]),
    }


# ------------------------------------------------------------------ bundle

@functools.lru_cache(maxsize=None)
def _bundle(role: str, scale: str = "tiny"):
    """(cfg, structs) for one role at one scale: the SMOKE config at
    ``tiny``, the published config at ``full``."""
    if scale not in SERVING_SHAPES:
        raise ValueError(f"scale {scale!r} is not one of "
                         f"{sorted(SERVING_SHAPES)}")
    arch = ML_ROLES[role]
    cfg = registry.get(arch) if scale == "full" else registry.get_smoke(arch)
    return {"cfg": cfg, "structs": _structs_for(cfg)}


def _prompt_tokens(role: str, which: str = "prompt", scale: str = "tiny",
                   device="cpu"):
    """Deterministic prompt: a fixed arithmetic progression mod vocab."""
    b = _bundle(role, scale)
    shape = tuple(b["structs"][which].shape)
    n = math.prod(shape)
    toks = (np.arange(n, dtype=np.int64) * 7 + 3) % b["cfg"].vocab_size
    return torch.from_numpy(toks.astype(np.int32).reshape(shape)).to(device)


def _next_token(logits):
    return logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]


# -------------------------------------------------- seeding (test harness)

def seed_payloads(scenario: str, *, scale: str = "tiny",
                  device=None) -> list:
    """The input objects for one scenario, in GET order — what a
    deployment stages in remote storage before invoking. Byte sizes match
    `role_sizes` (and, at tiny scale, ``calibration.json``) exactly.
    Weight shards are read-only ``memoryview`` slices of one params blob;
    every other payload is ``bytes``."""
    role = SCENARIO_INPUTS[scenario][0]
    return seed_role(role, [scenario], scale=scale, device=device)[scenario]


def seed_role(role: str, scenarios=None, *, scale: str = "tiny",
              device=None) -> dict[str, list]:
    """`seed_payloads` of several scenarios of one role (all of them by
    default), from one draw of the params: their lists share one params
    blob and one decode state, so a full-scale role is encoded once."""
    dev = resolve_device(device)
    if scenarios is None:
        scenarios = [s for s, (r, _) in SCENARIO_INPUTS.items() if r == role]
    if any(SCENARIO_INPUTS[s][0] != role for s in scenarios):
        raise ValueError(f"{scenarios} are not all scenarios of {role!r}")
    kinds = {k for s in scenarios for k in SCENARIO_INPUTS[s][1]}
    b = _bundle(role, scale)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0),
                            b["cfg"], device=dev)
    params_blob = serialize.dumps(params)
    made = {}
    if "kv" in kinds:
        # a real decode-ready state: prefill a DECODE-shaped fixed
        # prompt, then serialize (cache, next-token) — the decode GET
        # payload
        logits, cache = lm.prefill(
            b["cfg"], params, {"tokens": _prompt_tokens(
                role, "decode_tokens", scale, dev)})
        made["kv"] = serialize.dumps((cache, _next_token(logits)))
        del logits, cache
    del params
    made["params"] = params_blob
    for kind in ("prompt", "enc_tokens"):
        if kind in kinds:
            made[kind] = serialize.dumps(_prompt_tokens(role, kind, scale))

    # weight shards are views of the one blob: no scenario copies it
    whole = memoryview(params_blob)
    out = {}
    for scenario in scenarios:
        skinds = SCENARIO_INPUTS[scenario][1]
        offs = [0]
        for n in shard_bytes(len(params_blob), skinds.count("weights") or 1):
            offs.append(offs[-1] + n)
        shards = iter(whole[offs[i]:offs[i + 1]]
                      for i in range(len(offs) - 1))
        out[scenario] = [next(shards) if kind == "weights" else made[kind]
                         for kind in skinds]
    return out


def load_output(scenario: str, body, *, scale: str = "tiny", device=None):
    """A scenario's durable output bytes as a tree of tensors (for
    LLM-DECODE, the cache bytes of the pair it returns)."""
    role = SCENARIO_INPUTS[scenario][0]
    return serialize.loads(
        _bundle(role, scale)["structs"][SCENARIO_OUTPUT[scenario]], body,
        resolve_device(device))


# ------------------------------------------------------------ handler cores

class _Steps:
    """Wall seconds of a core's steps into ``timings`` (when given), the
    device synchronised at the end of each."""

    def __init__(self, timings, device):
        self.timings, self.device = timings, device
        self.t = time.perf_counter()

    def done(self, name):
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = now - self.t
        self.t = now


def _load_params(role: str, blob, scale: str = "tiny", device="cpu"):
    b = _bundle(role, scale)
    return serialize.loads(b["structs"]["params"], blob, device)


def llm_cold(shard_bodies, prompt_body, *, scale="tiny", device=None,
             plain=False, timings=None) -> bytes:
    """Assemble weights from shards, prefill the prompt, take one decode
    step; the durable output is the step's logits."""
    dev = resolve_device(device)
    steps = _Steps(timings, dev)
    b = _bundle("llm", scale)
    params = _load_params("llm", b"".join(shard_bodies),
                          scale, dev)
    tokens = serialize.loads(b["structs"]["prompt"], prompt_body, dev)
    steps.done("decode")
    logits, cache = lm.prefill(b["cfg"], params, {"tokens": tokens},
                               plain=plain)
    logits2, _ = lm.decode_step(b["cfg"], params, cache,
                                _next_token(logits), plain=plain)
    steps.done("forward")
    out = serialize.dumps(logits2)
    steps.done("encode")
    return out


def llm_prefill(params_body, prompt_body, *, scale="tiny", device=None,
                plain=False, timings=None) -> bytes:
    """Prefill: the durable output is the serialized KV cache the decode
    tier would consume."""
    dev = resolve_device(device)
    steps = _Steps(timings, dev)
    b = _bundle("llm", scale)
    params = _load_params("llm", params_body, scale, dev)
    tokens = serialize.loads(b["structs"]["prompt"], prompt_body, dev)
    steps.done("decode")
    _, cache = lm.prefill(b["cfg"], params, {"tokens": tokens}, plain=plain)
    steps.done("forward")
    out = serialize.dumps(cache)
    steps.done("encode")
    return out


def llm_decode(params_body, kv_body, *, scale="tiny", device=None,
               plain=False, timings=None) -> tuple[bytes, int]:
    """One decode step: deserialize (cache, token), advance the model,
    return (serialized updated cache, next token id)."""
    dev = resolve_device(device)
    steps = _Steps(timings, dev)
    b = _bundle("llm", scale)
    params = _load_params("llm", params_body, scale, dev)
    cache, token = serialize.loads(
        (b["structs"]["decode_cache"], b["structs"]["step_token"]), kv_body,
        dev)
    steps.done("decode")
    logits, cache2 = lm.decode_step(b["cfg"], params, cache, token,
                                    plain=plain)
    nxt = int(_next_token(logits)[0, 0])
    steps.done("forward")
    out = serialize.dumps(cache2)
    steps.done("encode")
    return out, nxt


def emb_encode(params_body, tokens_body, *, scale="tiny", device=None,
               plain=False, timings=None) -> bytes:
    """Batch encode: final-position logits as the embedding vectors."""
    dev = resolve_device(device)
    steps = _Steps(timings, dev)
    b = _bundle("emb", scale)
    params = _load_params("emb", params_body, scale, dev)
    tokens = serialize.loads(b["structs"]["enc_tokens"], tokens_body, dev)
    steps.done("decode")
    logits, _ = lm.prefill(b["cfg"], params, {"tokens": tokens}, plain=plain)
    steps.done("forward")
    out = serialize.dumps(logits)
    steps.done("encode")
    return out


def moe_infer(shard_bodies, *, scale="tiny", device=None, plain=False,
              timings=None) -> bytes:
    """Expert-shard fan-in: reassemble the MoE params from the fetched
    shards, run the fixed prompt through the router + top-k experts."""
    dev = resolve_device(device)
    steps = _Steps(timings, dev)
    params = _load_params("moe", b"".join(shard_bodies),
                          scale, dev)
    tokens = _prompt_tokens("moe", "prompt", scale, dev)
    steps.done("decode")
    logits, _ = lm.prefill(_bundle("moe", scale)["cfg"], params,
                           {"tokens": tokens}, plain=plain)
    steps.done("forward")
    out = serialize.dumps(logits)
    steps.done("encode")
    return out


def run_scenario(scenario: str, payloads, **kw):
    """A scenario's core on its payloads in GET order (as `seed_payloads`
    gives them); ``kw`` goes to the core."""
    if scenario == "LLM-COLD":
        return llm_cold(payloads[:-1], payloads[-1], **kw)
    if scenario == "MOE":
        return moe_infer(payloads, **kw)
    core = {"LLM-PREFILL": llm_prefill, "LLM-DECODE": llm_decode,
            "EMB": emb_encode}[scenario]
    return core(*payloads, **kw)
