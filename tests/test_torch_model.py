"""The port's decoders (dense, ssm, hybrid) against repro.models on the
same params.

The reference's params (JAX init) reach the port through
`repro_torch.models.convert`; logits and every cache leaf are compared
with the whole-model bf16 tolerance of tests/test_models.py
(atol 0.3, rtol 0.05).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import get_model as ref_get_model
from repro_torch.configs import registry
from repro_torch.models import Model, get_model
from repro_torch.models.convert import cache_from_numpy, params_from_numpy

TOL = dict(atol=0.3, rtol=0.05)
ARCH = "llama3-8b"
ARCHS = ["llama3-8b", "falcon-mamba-7b", "hymba-1.5b"]
INT_LEAVES = ("pos", "slot_pos")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = ref_registry.get_smoke(request.param)
    ref = ref_get_model(cfg)
    params = ref.init_params(jax.random.PRNGKey(0))
    port = get_model(registry.get_smoke(request.param), device="cpu")
    return ref, params, port, params_from_numpy(jax.tree.map(np.asarray,
                                                             params))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def test_prefill_then_decode_matches_reference(pair):
    ref, rparams, port, pparams = pair
    rng = np.random.default_rng(0)
    B, S = 2, 16
    toks = rng.integers(0, port.cfg.vocab_size, (B, S), dtype=np.int32)
    rlogits, rcache = ref.prefill(rparams, {"tokens": jnp.asarray(toks)},
                                  cache_len=S + 4)
    logits, cache = port.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                                 cache_len=S + 4)
    np.testing.assert_allclose(_np(logits), _np(rlogits), **TOL)
    _assert_cache_matches(cache, rcache, "prefill")
    for step in range(4):
        tok = rng.integers(0, port.cfg.vocab_size, (B, 1), dtype=np.int32)
        rlogits, rcache = ref.decode_step(rparams, rcache, jnp.asarray(tok))
        logits, cache = port.decode_step(pparams, cache,
                                         torch.from_numpy(tok))
        np.testing.assert_allclose(_np(logits), _np(rlogits), **TOL,
                                   err_msg=f"decode step {step}")
        _assert_cache_matches(cache, rcache, f"decode step {step}")


def _assert_cache_matches(cache, rcache, when):
    """Every leaf: the same keys and dtypes, integer leaves equal, float
    leaves within the whole-model tolerance."""
    assert set(cache) == set(rcache)
    for name, ref_leaf in rcache.items():
        leaf = cache[name]
        assert str(leaf.dtype).split(".")[-1] == ref_leaf.dtype.name, name
        if name in INT_LEAVES:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref_leaf),
                                          err_msg=f"{when}: {name}")
        else:
            np.testing.assert_allclose(_np(leaf), _np(ref_leaf), **TOL,
                                       err_msg=f"{when}: {name}")


def test_decode_from_reference_cache(pair):
    """A decode state written by the reference advances in the port."""
    ref, rparams, port, pparams = pair
    toks = jnp.arange(24, dtype=jnp.int32)[None] % port.cfg.vocab_size
    _, rcache = ref.prefill(rparams, {"tokens": toks})
    cache = cache_from_numpy(jax.tree.map(np.asarray, rcache))
    tok = np.array([[5]], np.int32)
    rlogits, _ = ref.decode_step(rparams, rcache, jnp.asarray(tok))
    logits, _ = port.decode_step(pparams, cache, torch.from_numpy(tok))
    np.testing.assert_allclose(_np(logits), _np(rlogits), **TOL)


@pytest.mark.parametrize("pair", ["llama3-8b", "hymba-1.5b"], indirect=True)
def test_first_decode_evicts_position_zero_like_the_reference(pair):
    """Without cache_len the dense cache is exactly S wide, so the first
    decode step writes slot S % S = 0: the reference's behaviour, kept."""
    ref, rparams, port, pparams = pair
    S = 12
    toks = (np.arange(S, dtype=np.int32) * 5 + 1)[None]
    _, rcache = ref.prefill(rparams, {"tokens": jnp.asarray(toks)})
    _, cache = port.prefill(pparams, {"tokens": torch.from_numpy(toks)})
    assert cache["k"].shape[2] == S
    tok = np.array([[3]], np.int32)
    rlogits, rcache = ref.decode_step(rparams, rcache, jnp.asarray(tok))
    logits, cache = port.decode_step(pparams, cache, torch.from_numpy(tok))
    expect = np.arange(S)
    expect[0] = S
    np.testing.assert_array_equal(cache["slot_pos"].numpy()[0], expect)
    np.testing.assert_array_equal(np.asarray(rcache["slot_pos"])[0], expect)
    np.testing.assert_allclose(_np(logits), _np(rlogits), **TOL)
    # with room in the cache position 0 stays visible, and the logits move
    _, wide = port.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                           cache_len=S + 1)
    logits_wide, _ = port.decode_step(pparams, wide, torch.from_numpy(tok))
    assert not torch.allclose(logits_wide, logits)


class TestDecodeConsistency:
    """Port copy of tests/test_models.py::TestDecodeConsistency: prefill
    then decode matches a teacher-forced full prefill (the port's own
    seeded params)."""

    @pytest.mark.parametrize("arch", ARCHS)
    def test_decode_matches_prefill_logits(self, arch):
        cfg = registry.get_smoke(arch).replace(remat_policy="none")
        model = Model(cfg, device="cpu")
        params = model.init_params(torch.Generator().manual_seed(2))
        B, S = 1, 32
        toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(3))
        logits_full, _ = model.prefill(params, {"tokens": toks})
        logits_pre, cache = model.prefill(params, {"tokens": toks[:, :-1]},
                                          cache_len=S)
        logits_dec, _ = model.decode_step(params, cache, toks[:, -1:])
        np.testing.assert_allclose(_np(logits_full[:, -1]),
                                   _np(logits_dec[:, 0]), **TOL)


def test_plain_flag_matches_wrapper_path_on_cpu(pair):
    _, _, port, pparams = pair
    toks = torch.arange(10, dtype=torch.int32)[None]
    a, ca = port.prefill(pparams, {"tokens": toks})
    b, cb = port.prefill(pparams, {"tokens": toks}, plain=True)
    assert torch.equal(a, b)
    for name in ca:
        if name == "ssm":
            # the wrapper's CPU path is the sequential oracle, plain=True
            # the chunked doubling scan: f32 sums in another order
            torch.testing.assert_close(ca[name], cb[name], atol=1e-5,
                                       rtol=1e-5)
        else:
            assert torch.equal(ca[name], cb[name]), name


def test_unported_family_raises():
    cfg = registry.get_smoke(ARCH).replace(family="moe")
    with pytest.raises(NotImplementedError, match="moe"):
        Model(cfg, device="cpu")
