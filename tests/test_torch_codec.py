"""The port's configs and tensor-tree codec against the JAX reference.

The codec must be byte-identical: params and KV state written by either
package read back in the other.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import serialize as ref_serialize
from repro.models import serving as ref_serving
from repro_torch.configs import registry
from repro_torch.models import kv_cache as kvc
from repro_torch.models import lm, serialize
from repro_torch.models.convert import cache_from_numpy, params_from_numpy

ARCH = "llama3-8b"


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_equal_reference(smoke):
    get = "get_smoke" if smoke else "get"
    port = getattr(registry, get)(ARCH)
    ref = getattr(ref_registry, get)(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("smoke", [False, True])
def test_param_count_equals_reference(smoke):
    get = "get_smoke" if smoke else "get"
    assert (getattr(registry, get)(ARCH).param_count()
            == getattr(ref_registry, get)(ARCH).param_count())


def test_unported_arch_raises():
    with pytest.raises(KeyError, match="not ported"):
        registry.get("qwen2-72b")


def test_params_encode_byte_identical():
    params = ref_serving._bundle("llm")["params"]
    blob = ref_serialize.dumps(params)
    port_params = params_from_numpy(_numpy_tree(params))
    assert serialize.dumps(port_params) == blob
    assert serialize.tree_nbytes(port_params) == len(blob)


def test_params_payload_round_trips():
    blob = ref_serving.seed_payloads("LLM-PREFILL")[0]
    structs = lm.param_structs(registry.get_smoke(ARCH))
    assert serialize.tree_nbytes(structs) == len(blob)
    tree = serialize.loads(structs, blob)
    assert tree["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert serialize.dumps(tree) == blob


def _decode_structs():
    cfg = registry.get_smoke(ARCH)
    cache = kvc.init_cache(cfg, 1, 32, device="meta")
    return cache, serialize.struct((1, 1), torch.int32)


def test_kv_payload_round_trips():
    blob = ref_serving.seed_payloads("LLM-DECODE")[1]
    cache, token = serialize.loads(_decode_structs(), blob)
    assert set(cache) == {"k", "v", "slot_pos", "pos"}
    assert cache["pos"].tolist() == [32] and token.shape == (1, 1)
    assert serialize.dumps((cache, token)) == blob


def test_cache_from_numpy_matches_codec():
    b = ref_serving._bundle("llm")
    toks = ref_serving._prompt_tokens("llm", "decode_tokens")
    _, cache = b["prefill"](b["params"], {"tokens": toks})
    port = cache_from_numpy(_numpy_tree(cache))
    assert serialize.dumps(port) == ref_serialize.dumps(cache)


@pytest.mark.parametrize("cut", [-1, 1])
def test_wrong_size_payload_raises(cut):
    blob = ref_serving.seed_payloads("LLM-DECODE")[1]
    bad = blob[:cut] if cut < 0 else blob + b"\0" * cut
    with pytest.raises(ValueError, match="declared tree"):
        serialize.loads(_decode_structs(), bad)
