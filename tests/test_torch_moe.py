"""The port's MoE layer (`repro_torch.models.moe`) against repro.models.moe.

Inputs and params are drawn with numpy from a seed and handed to both
packages; bf16 inputs are rounded from the same f32 draws on both sides.
Tolerances as in tests/test_kernels.py: fp32 1e-5 here (the products are
small), bf16 2e-2.

Routing is a discrete choice: the k-th and (k+1)-th router probability
of a token decide whether an expert is in or out. The router runs in f32
on the same inputs in both packages, so their probabilities differ by
float rounding alone (~1e-7); every routing test prints the smallest
margin and requires it above ``MARGIN``, so a near-tie would be reported,
not compared through a flipped expert.

Capacity drops: at the qwen3-moe smoke width (E 8, k 2, capacity factor
1.25) with B 2, S 64, there are A = 256 assignments and capacity
C = max(int(256 / 8 * 1.25), 8) = 40 per expert. The hidden states share
a common direction, so the routing is skewed, and on these inputs the
reference drops 56 of the 256 (asserted to be some); both packages drop
exactly the assignments past capacity in token order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import moe as ref_moe
from repro_torch.configs import registry
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy

ARCH = "qwen3-moe-30b-a3b"
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MARGIN = 1e-5       # smallest k-th minus (k+1)-th router probability


def _cfg(**kw):
    return registry.get_smoke(ARCH).replace(**kw)


def _inputs(seed, cfg, dtype, B=2, S=64):
    """(ref params, port params, ref x, port x): router f32, experts and
    x in ``dtype``, all from one numpy draw."""
    jd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    tree = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
            "w_gate": rng.standard_normal((E, D, Fd)) / np.sqrt(D),
            "w_up": rng.standard_normal((E, D, Fd)) / np.sqrt(D),
            "w_down": rng.standard_normal((E, Fd, D)) / np.sqrt(Fd)}
    # hidden states share a common direction, which skews the routing
    # toward a few experts, as a model's do
    x = rng.standard_normal((B, S, D)) + rng.standard_normal(D)
    rp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jd)
          for k, v in tree.items()}
    pp = params_from_numpy(jax.tree.map(np.asarray, rp))
    jx = jnp.asarray(x, jd)
    return rp, pp, jx, torch.from_numpy(np.array(x)).to(td)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _close(ref, out, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


def _margin(cfg, xf, router):
    """Smallest k-th minus (k+1)-th router probability over the tokens."""
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(xf, jnp.float32) @ router, axis=-1))
    top = -np.sort(-probs, axis=-1)
    k = cfg.num_experts_per_tok
    margin = float((top[:, k - 1] - top[:, k]).min())
    print(f"smallest top-{k} routing margin {margin:.3e}")
    assert margin > MARGIN, "a near-tie in the routing: not comparable"
    return margin


def _dropped(idx, E, cap):
    """(T, k) bool: the assignments past their expert's capacity, in the
    reference's order (token-major, then k), counted in numpy."""
    flat = np.asarray(idx).reshape(-1)
    seen = np.zeros(E, np.int64)
    out = np.zeros(flat.shape, bool)
    for a, e in enumerate(flat):
        out[a] = seen[e] >= cap
        seen[e] += 1
    return out.reshape(np.asarray(idx).shape)


def _capacity(cfg, T):
    A = T * cfg.num_experts_per_tok
    return max(int(A / cfg.num_experts * cfg.capacity_factor), 8)


def test_silu_rounds_like_the_reference():
    """bf16: bit for bit as ``jax.nn.silu``; f32 within float rounding."""
    x = np.random.default_rng(0).standard_normal(20_000) * 4
    for dtype, tol in (("bfloat16", 0.0), ("float32", 1e-6)):
        jd, td, _ = DTYPES[dtype]
        ref = np.asarray(jax.nn.silu(jnp.asarray(x, jd)), np.float32)
        out = moe.silu(torch.from_numpy(x).to(td)).float().numpy()
        np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_moe_tree_matches_reference(dtype):
    cfg = _cfg()
    jd, td, _ = DTYPES[dtype]
    ref = ref_moe.init_moe(jax.random.PRNGKey(0), ref_registry.get_smoke(ARCH),
                           jd)
    port = moe.init_moe(torch.Generator().manual_seed(0), cfg, td)
    assert list(port) == list(ref)
    for name, leaf in ref.items():
        assert tuple(port[name].shape) == leaf.shape, name
        assert str(port[name].dtype).split(".")[-1] == leaf.dtype.name, name
    assert port["router"].dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_route_matches_reference(dtype):
    cfg = _cfg()
    rp, pp, jx, tx = _inputs(1, cfg, dtype)
    D = cfg.d_model
    _margin(cfg, jx.reshape(-1, D), rp["router"])
    gates_r, idx_r, aux_r = ref_moe._route(rp, cfg, jx.reshape(-1, D))
    gates, idx, aux = moe._route(pp, cfg, tx.reshape(-1, D))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    # the router is f32 in both packages, whatever x's dtype
    assert gates.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_r), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity_factor,drops", [(1.25, True),
                                                   (8.0, False)])
def test_moe_sorted_matches_reference(dtype, capacity_factor, drops):
    """With the published capacity factor the reference drops assignments
    on these inputs; with 8.0 it drops none."""
    cfg = _cfg(capacity_factor=capacity_factor)
    rp, pp, jx, tx = _inputs(2, cfg, dtype)
    D, T = cfg.d_model, jx.shape[0] * jx.shape[1]
    _margin(cfg, jx.reshape(-1, D), rp["router"])
    _, idx_r, _ = ref_moe._route(rp, cfg, jx.reshape(-1, D))
    n_drop = int(_dropped(idx_r, cfg.num_experts, _capacity(cfg, T)).sum())
    print(f"capacity {_capacity(cfg, T)}: {n_drop} of {idx_r.size} "
          f"assignments dropped")
    assert (n_drop > 0) == drops
    y_r, aux_r = ref_moe.moe_sorted(rp, cfg, jx)
    y, aux = moe.moe_sorted(pp, cfg, tx)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    _close(y_r, y, dtype)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)


def test_moe_sorted_drops_exactly_the_assignments_past_capacity():
    """Both packages' sorted dispatch equal the dense one with the gate of
    every assignment past its expert's capacity (counted in numpy, in
    token order) set to zero, f32."""
    cfg = _cfg()
    rp, pp, jx, tx = _inputs(2, cfg, "float32")
    D, T, E = cfg.d_model, jx.shape[0] * jx.shape[1], cfg.num_experts
    gates, idx, _ = moe._route(pp, cfg, tx.reshape(-1, D))
    drop = _dropped(idx.numpy(), E, _capacity(cfg, T))
    assert drop.any()
    w = torch.zeros((T, E)).scatter_add_(
        1, idx, gates * torch.from_numpy(~drop))
    h = torch.nn.functional.silu(torch.matmul(tx.reshape(T, D), pp["w_gate"]))
    h = h * torch.matmul(tx.reshape(T, D), pp["w_up"])
    want = torch.einsum("etd,te->td", torch.matmul(h, pp["w_down"]), w)
    y, _ = moe.moe_sorted(pp, cfg, tx)
    y_r, _ = ref_moe.moe_sorted(rp, cfg, jx)
    for out in (y, y_r):
        np.testing.assert_allclose(_np(out).reshape(T, D), want.numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S", [(2, 16), (8, 1)])      # prefill, decode
def test_moe_dense_matches_reference(dtype, B, S):
    cfg = _cfg()
    rp, pp, jx, tx = _inputs(3, cfg, dtype, B, S)
    _margin(cfg, jx.reshape(-1, cfg.d_model), rp["router"])
    y_r, aux_r = ref_moe.moe_dense(rp, cfg, jx)
    y, aux = moe.moe_dense(pp, cfg, tx)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    _close(y_r, y, dtype)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)


@pytest.mark.parametrize("impl", ["sorted", "dense", "local"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_layer_matches_reference(impl, dtype):
    """`moe_layer` dispatches on ``moe_impl``; ``local`` on one device is
    the sorted dispatch in both packages."""
    cfg = _cfg(moe_impl=impl)
    rp, pp, jx, tx = _inputs(4, cfg, dtype)
    _margin(cfg, jx.reshape(-1, cfg.d_model), rp["router"])
    y_r, aux_r = ref_moe.moe_layer(rp, cfg, jx)
    y, aux = moe.moe_layer(pp, cfg, tx)
    _close(y_r, y, dtype)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)
    if impl == "local":
        assert torch.equal(y, moe.moe_sorted(pp, cfg, tx)[0])


@pytest.mark.parametrize("arch", [ARCH, "mixtral-8x22b"])
def test_sorted_matches_dense_oracle_without_drops(arch):
    """Port copy of tests/test_models.py::TestMoE::
    test_sorted_matches_dense_oracle, with the port's own seeded params:
    at capacity factor 8.0 nothing drops and sorted equals dense."""
    cfg = ref_registry.get_smoke(arch).replace(capacity_factor=8.0)
    g = torch.Generator().manual_seed(3)
    p = moe.init_moe(g, cfg, torch.float32)
    x = torch.randn((2, 16, cfg.d_model), generator=g)
    y_sorted, aux_s = moe.moe_sorted(p, cfg, x)
    y_dense, aux_d = moe.moe_dense(p, cfg, x)
    np.testing.assert_allclose(y_sorted.numpy(), y_dense.numpy(), atol=1e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(float(aux_s), float(aux_d), rtol=1e-5)


def test_capacity_drops_are_bounded():
    """Port copy of TestMoE::test_capacity_drops_are_bounded."""
    cfg = _cfg()
    g = torch.Generator().manual_seed(4)
    p = moe.init_moe(g, cfg, torch.float32)
    x = torch.randn((2, 64, cfg.d_model), generator=g)
    y, aux = moe.moe_sorted(p, cfg, x)
    assert torch.isfinite(y).all()
    assert float(aux) >= 0.0
