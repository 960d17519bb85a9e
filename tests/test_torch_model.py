"""The port's decoders (dense, moe, ssm, hybrid) against repro.models on
the same params.

The reference's params (JAX init) reach the port through
`repro_torch.models.convert`; logits and every cache leaf are compared
with the whole-model bf16 tolerance of tests/test_models.py
(atol 0.3, rtol 0.05), and in f32 configs at 1e-4.

MoE routing is a discrete choice, and the two packages' bf16 activations
differ in their last bits, so at a near-tie one package can route a
token to another expert than the other and move the logits by far more
than the tolerance. `RoutingSpy` records the router probabilities of
every MoE layer in both packages. Where the chosen experts differ, the
k-th and (k+1)-th probabilities must lie within ``ROUTE_TOL`` (else the
test fails: a flip at a clear margin is a fault), and from then on the
rows the flip reaches are not compared: the token's own row in a dropless
decode step, every row in a sorted prefill (capacity couples them). The
margins are printed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import get_model as ref_get_model
from repro.models import moe as ref_moe
from repro.models import serialize as ref_serialize
from repro_torch.configs import registry
from repro_torch.models import Model, get_model, moe, serialize
from repro_torch.models.convert import cache_from_numpy, params_from_numpy

TOL = dict(atol=0.3, rtol=0.05)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
#: f32 decode logits of the SSM families: their conv tail is bf16 in both
#: packages, and where the two round f32 values that differ in the last
#: bits to bf16 on either side of a rounding boundary, one element of the
#: tail differs by a bf16 ulp (2^-7 relative), which moves the next
#: steps' logits by up to ~5e-4 (falcon-mamba smoke)
SSM_F32_DECODE_TOL = dict(atol=1e-3, rtol=1e-3)
#: largest gap between the k-th and (k+1)-th router probability at which
#: the packages may choose other experts: the kernels' bf16 tolerance
#: (`test_prefill_then_decode_matches_reference` prints how far apart the
#: packages' probabilities are: up to ~3e-3 from the second bf16 layer
#: of the qwen3-moe smoke model on), and 1e-4 in f32
ROUTE_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
ARCH = "llama3-8b"
ARCHS = ["llama3-8b", "falcon-mamba-7b", "hymba-1.5b", "qwen3-moe-30b-a3b",
         "granite-8b"]
INT_LEAVES = ("pos", "slot_pos")


class RoutingSpy:
    """Both packages' router probabilities, one (T, E) array per MoE layer
    call, in call order (the reference's through a debug callback, which
    runs inside its layer scan)."""

    def __init__(self, monkeypatch):
        self.ref, self.port, self.margins, self.gaps = [], [], [], []
        ref_route, port_route = ref_moe._route, moe._route

        def ref_spy(p, cfg, xf):
            probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], -1)
            jax.debug.callback(lambda pr: self.ref.append(np.asarray(pr)),
                               probs, ordered=True)
            return ref_route(p, cfg, xf)

        def port_spy(p, cfg, xf):
            self.port.append(torch.softmax(xf.float() @ p["router"], -1)
                             .numpy())
            return port_route(p, cfg, xf)

        monkeypatch.setattr(ref_moe, "_route", ref_spy)
        monkeypatch.setattr(moe, "_route", port_spy)

    def flipped_rows(self, k, batch, tol, coupled):
        """The batch rows that a routing flip in the calls since the last
        call reaches (all rows if ``coupled``); fails on a flip past
        ``tol``."""
        assert len(self.ref) == len(self.port) > 0
        rows = set()
        for pr, pp in zip(self.ref, self.port):
            sets = [np.sort(np.argsort(-p, axis=-1, kind="stable")[:, :k], -1)
                    for p in (pr, pp)]
            margin = np.minimum(*[_route_margin(p, k) for p in (pr, pp)])
            self.margins.append(float(margin.min()))
            self.gaps.append(float(np.abs(pr - pp).max()))
            flips = np.flatnonzero((sets[0] != sets[1]).any(-1))
            for t in flips:
                assert margin[t] <= tol, (f"token {t} routed to other experts "
                                          f"at margin {margin[t]:.3e}")
                rows |= (set(range(batch)) if coupled
                         else {int(t) * batch // len(pr)})
        self.ref.clear()
        self.port.clear()
        return rows


def _route_margin(probs, k):
    top = -np.sort(-probs, axis=-1)
    return top[:, k - 1] - top[:, k]


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


def _prefill_then_decode(ref, rparams, port, pparams, tol, monkeypatch,
                         decode_tol=None):
    """Prefill 16 tokens of 2 rows and decode 4, comparing logits and
    every cache leaf after each call (decode logits at ``decode_tol``,
    by default ``tol``), on the rows no routing flip has reached (all
    rows for families without MoE)."""
    cfg = port.cfg
    spy = RoutingSpy(monkeypatch) if cfg.family == "moe" else None
    route_tol = ROUTE_TOL[cfg.dtype]
    rng = np.random.default_rng(0)
    B, S = 2, 16
    rows = list(range(B))
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    rlogits, rcache = ref.prefill(rparams, {"tokens": jnp.asarray(toks)},
                                  cache_len=S + 4)
    logits, cache = port.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                                 cache_len=S + 4)
    for step in range(5):
        if step:
            tok = rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
            rlogits, rcache = ref.decode_step(rparams, rcache,
                                              jnp.asarray(tok))
            logits, cache = port.decode_step(pparams, cache,
                                             torch.from_numpy(tok))
        if spy is not None:
            coupled = step == 0 and cfg.moe_impl != "dense"
            flipped = spy.flipped_rows(cfg.num_experts_per_tok, B, route_tol,
                                       coupled)
            rows = [b for b in rows if b not in flipped]
        when = f"decode step {step - 1}" if step else "prefill"
        np.testing.assert_allclose(_np(logits)[rows], _np(rlogits)[rows],
                                   **(decode_tol if step and decode_tol
                                      else tol), err_msg=when)
        _assert_cache_matches(cache, rcache, when, tol, rows)
    if spy is not None:
        print(f"per MoE layer call, the smallest routing margin "
              f"{np.round(spy.margins, 5).tolist()} and the largest "
              f"difference of the packages' router probabilities "
              f"{np.round(spy.gaps, 6).tolist()}; rows compared to the "
              f"end: {rows}")


def test_prefill_then_decode_matches_reference(pair, monkeypatch):
    _prefill_then_decode(*pair, TOL, monkeypatch)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_config_matches_reference(arch, monkeypatch):
    """The smoke config in f32 (params and activations): logits and float
    cache leaves at 1e-4 (the SSM families' decode logits at
    ``SSM_F32_DECODE_TOL``). The SSM conv tail stays bf16 in both
    packages, so the encoded cache has the reference's size."""
    cfg = _f32(ref_registry.get_smoke(arch))
    ref = ref_get_model(cfg)
    rparams = ref.init_params(jax.random.PRNGKey(0))
    port = get_model(_f32(registry.get_smoke(arch)), device="cpu")
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams))
    assert all(leaf.dtype == torch.float32
               for leaf in serialize.leaves(pparams))
    _prefill_then_decode(ref, rparams, port, pparams, F32_TOL, monkeypatch,
                         SSM_F32_DECODE_TOL if cfg.family in ("ssm", "hybrid")
                         else None)
    toks = (np.arange(12, dtype=np.int32) % cfg.vocab_size)[None]
    _, rcache = ref.prefill(rparams, {"tokens": jnp.asarray(toks)})
    _, cache = port.prefill(pparams, {"tokens": torch.from_numpy(toks)})
    if "conv" in cache:
        assert cache["conv"].dtype == torch.bfloat16
    assert serialize.tree_nbytes(cache) == len(ref_serialize.dumps(rcache))


def _assert_cache_matches(cache, rcache, when, tol=TOL, rows=None):
    """Every leaf: the same keys and dtypes, integer leaves equal, float
    leaves within ``tol`` (a bf16 leaf of an f32 config, the SSM conv
    tail, within one bf16 ulp, 2^-7 relative: the packages round f32
    values that differ in their last bits), on the batch ``rows`` (all by
    default)."""
    assert set(cache) == set(rcache)
    for name, ref_leaf in rcache.items():
        leaf = cache[name]
        assert str(leaf.dtype).split(".")[-1] == ref_leaf.dtype.name, name
        # the batch axis: leading for pos and slot_pos, after the layer
        # axis for the stacked leaves
        axis = 0 if name in INT_LEAVES else 1
        got = np.take(_np(leaf), rows or range(leaf.shape[axis]), axis)
        want = np.take(_np(ref_leaf), rows or range(leaf.shape[axis]), axis)
        if name in INT_LEAVES:
            np.testing.assert_array_equal(got, want, err_msg=f"{when}: {name}")
        else:
            leaf_tol = tol
            if leaf.dtype == torch.bfloat16 and tol["atol"] < 2 ** -7:
                leaf_tol = dict(atol=tol["atol"], rtol=2 ** -7)
            np.testing.assert_allclose(got, want, **leaf_tol,
                                       err_msg=f"{when}: {name}")


def test_decode_from_reference_cache(pair, monkeypatch):
    """A decode state written by the reference advances in the port."""
    ref, rparams, port, pparams = pair
    toks = jnp.arange(24, dtype=jnp.int32)[None] % port.cfg.vocab_size
    _, rcache = ref.prefill(rparams, {"tokens": toks})
    cache = cache_from_numpy(jax.tree.map(np.asarray, rcache))
    tok = np.array([[5]], np.int32)
    spy = RoutingSpy(monkeypatch) if port.cfg.family == "moe" else None
    rlogits, _ = ref.decode_step(rparams, rcache, jnp.asarray(tok))
    logits, _ = port.decode_step(pparams, cache, torch.from_numpy(tok))
    if spy is not None and spy.flipped_rows(port.cfg.num_experts_per_tok, 1,
                                            ROUTE_TOL["bfloat16"], False):
        print(f"routing flipped at a near-tie (margins {spy.margins}): "
              f"logits not compared")
        return
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
        if cfg.family == "moe":
            # as the reference's test: sorted dispatch drops tokens
            # capacity-dependently, decode is dropless
            cfg = cfg.replace(moe_impl="dense")
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
    cfg = registry.get_smoke(ARCH).replace(family="vlm")
    with pytest.raises(NotImplementedError, match="vlm"):
        Model(cfg, device="cpu")
