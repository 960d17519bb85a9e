"""The port's configs and tensor-tree codec against the JAX reference.

The codec must be byte-identical: params and KV state written by either
package read back in the other.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import get_model as ref_get_model
from repro.models import serialize as ref_serialize
from repro.models import serving as ref_serving
from repro_torch.configs import registry
from repro_torch.models import kv_cache as kvc
from repro_torch.models import lm, serialize
from repro_torch.models.convert import cache_from_numpy, params_from_numpy

ARCH = "llama3-8b"
ARCHS = ["llama3-8b", "falcon-mamba-7b", "hymba-1.5b", "qwen3-moe-30b-a3b",
         "granite-8b"]
PROMPT = 32
CACHE_KEYS = {"dense": {"k", "v", "slot_pos", "pos"},
              "moe": {"k", "v", "slot_pos", "pos"},
              "ssm": {"pos", "conv", "ssm"},
              "hybrid": {"k", "v", "slot_pos", "pos", "conv", "ssm"}}


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's smoke params (PRNGKey(0), as its serving bundle
    seeds them) and its decode state after a PROMPT-token prefill: the
    (cache, next token) pair an LLM-DECODE payload carries."""
    cfg = ref_registry.get_smoke(arch)
    model = ref_get_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    toks = (np.arange(PROMPT) * 7 + 3) % cfg.vocab_size
    logits, cache = model.prefill(
        params, {"tokens": jnp.asarray(toks, jnp.int32)[None]})
    token = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    return params, cache, token


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_equal_reference(smoke, arch):
    get = "get_smoke" if smoke else "get"
    port = getattr(registry, get)(arch)
    ref = getattr(ref_registry, get)(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_param_count_equals_reference(smoke, arch):
    get = "get_smoke" if smoke else "get"
    assert (getattr(registry, get)(arch).param_count()
            == getattr(ref_registry, get)(arch).param_count())


def test_falcon_mamba_has_its_published_size():
    """7.27e9 parameters at full width: 105.3 M per layer x 64, plus the
    embedding and the head (266 M each)."""
    assert registry.get("falcon-mamba-7b").param_count() == 7_272_665_088


def test_qwen3_moe_has_its_published_size():
    """30.53e9 parameters at full width: 48 layers of 128 experts
    (3 x 2048 x 768 each), attention with q/k-norm and an f32 router,
    plus the embedding and the head (311 M each)."""
    assert registry.get("qwen3-moe-30b-a3b").param_count() == 30_532_122_624


def test_unported_arch_raises():
    with pytest.raises(KeyError, match="not ported"):
        registry.get("qwen2-72b")


def test_llama_reference_state_is_the_serving_payloads():
    """For llama3-8b the state the tests below encode is byte for byte
    what the MLServe LLM-PREFILL and LLM-DECODE scenarios stage."""
    params, cache, token = _reference(ARCH)
    assert ref_serving.seed_payloads("LLM-PREFILL")[0] == \
        ref_serialize.dumps(params)
    assert ref_serving.seed_payloads("LLM-DECODE")[1] == \
        ref_serialize.dumps((cache, token))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_encode_byte_identical(arch):
    params = _reference(arch)[0]
    blob = ref_serialize.dumps(params)
    port_params = params_from_numpy(_numpy_tree(params))
    assert serialize.dumps(port_params) == blob
    assert serialize.tree_nbytes(port_params) == len(blob)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_payload_round_trips(arch):
    blob = ref_serialize.dumps(_reference(arch)[0])
    structs = lm.param_structs(registry.get_smoke(arch))
    assert serialize.tree_nbytes(structs) == len(blob)
    tree = serialize.loads(structs, blob)
    for got, spec in zip(serialize.leaves(tree), serialize.leaves(structs)):
        assert got.dtype == spec.dtype and got.shape == spec.shape
    assert serialize.dumps(tree) == blob


def _decode_structs(arch=ARCH):
    cfg = registry.get_smoke(arch)
    cache = kvc.init_cache(cfg, 1, PROMPT, device="meta")
    return cache, serialize.struct((1, 1), torch.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_payload_round_trips(arch):
    _, rcache, rtoken = _reference(arch)
    blob = ref_serialize.dumps((rcache, rtoken))
    cache, token = serialize.loads(_decode_structs(arch), blob)
    assert set(cache) == CACHE_KEYS[registry.get_smoke(arch).family]
    assert cache["pos"].tolist() == [PROMPT] and token.shape == (1, 1)
    assert serialize.dumps((cache, token)) == blob


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_from_numpy_matches_codec(arch):
    cache = _reference(arch)[1]
    port = cache_from_numpy(_numpy_tree(cache))
    assert set(port) == CACHE_KEYS[registry.get_smoke(arch).family]
    assert serialize.dumps(port) == ref_serialize.dumps(cache)


def test_cache_from_numpy_rejects_unknown_keys():
    cache = _numpy_tree(_reference("falcon-mamba-7b")[1])
    with pytest.raises(ValueError, match="keys"):
        cache_from_numpy({**cache, "k": cache["conv"]})


@pytest.mark.parametrize("cut", [-1, 1])
def test_wrong_size_payload_raises(cut):
    _, cache, token = _reference(ARCH)
    blob = ref_serialize.dumps((cache, token))
    bad = blob[:cut] if cut < 0 else blob + b"\0" * cut
    with pytest.raises(ValueError, match="declared tree"):
        serialize.loads(_decode_structs(), bad)
