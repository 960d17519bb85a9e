"""``cfg.inner_remat`` in the port, against the reference's.

The reference checkpoints the bodies of its inner scans when
``inner_remat`` is set: the chunked selective scan's chunk step
(``repro.models.mamba``, ``jax.checkpoint(chunk_step)``) and the blocked
attention's q and kv steps (``repro.models.layers``). The port runs them
under ``torch.utils.checkpoint``: the values and gradients stay those of
the reference (f32, within 1e-4 of each gradient's largest |value|) and
equal, bit for bit, the port's own run without it, and the bodies run
again in the backward pass: a `TorchDispatchMode` counts the ``exp``
calls the backward pass makes, which a recompute adds to.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as ref_registry
from repro.models import get_model as ref_get_model
from repro.models import layers as ref_layers
from repro.models import mamba as RM
from repro_torch.configs import registry
from repro_torch.models import get_model, layers, serialize
from repro_torch.models import mamba as M
from repro_torch.models.convert import params_from_numpy

TOL = 1e-4


class CountExp(TorchDispatchMode):
    """Counts the ``exp`` ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.exp = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.exp.default:
            self.exp += 1
        return func(*args, **(kwargs or {}))


def _grads_close(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        a = a.float().numpy()
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= TOL * scale


def _port_run(fn, inputs, cotangents):
    """fn(*inputs) and its gradients for the cotangents, with the exp ops
    of the backward pass counted."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    with CountExp() as count:
        grads = torch.autograd.grad(outs, leaves, cotangents)
    return [o.detach() for o in outs], grads, count.exp


def _remat_pair(fn, inputs, cotangents):
    """The port's run with and without inner remat: equal bit for bit,
    the remat run's backward recomputing (more exp ops)."""
    outs, grads, exps = _port_run(lambda *a: fn(*a, True), inputs,
                                  cotangents)
    outs0, grads0, exps0 = _port_run(lambda *a: fn(*a, False), inputs,
                                     cotangents)
    for a, b in zip(outs + list(grads), outs0 + list(grads0)):
        assert torch.equal(a, b)
    assert exps > exps0
    return outs, grads


@pytest.mark.parametrize("B,S,di,N,chunk", [
    (2, 256, 16, 16, 64),
    (1, 300, 24, 8, 128),                         # ragged: 2 chunks + 44
])
def test_chunked_scan_inner_remat(B, S, di, N, chunk):
    rng = np.random.default_rng(51)
    arrs = [np.log1p(np.exp(rng.standard_normal((B, S, di)))) * 0.1,
            rng.standard_normal((B, S, di)), rng.standard_normal((B, S, N)),
            rng.standard_normal((B, S, N)),
            -np.exp(rng.standard_normal((di, N)) * 0.5),
            rng.standard_normal((B, di, N)) * 0.5]
    arrs = [a.astype(np.float32) for a in arrs]
    cot = [rng.standard_normal((B, S, di)).astype(np.float32),
           rng.standard_normal((B, di, N)).astype(np.float32)]
    (jy, jh), vjp = jax.vjp(lambda *a: RM.ssm_scan_chunked(
        *a, chunk=chunk, inner_remat=True), *map(jnp.asarray, arrs))
    jgrads = vjp(tuple(map(jnp.asarray, cot)))
    (y, h), grads = _remat_pair(
        lambda *a: M.ssm_scan_chunked(*a[:6], chunk=chunk,
                                      inner_remat=a[6]),
        list(map(torch.from_numpy, arrs)), list(map(torch.from_numpy, cot)))
    _grads_close([y, h], [jy, jh])
    _grads_close(grads, jgrads)


def test_mamba_layer_inner_remat():
    """`mamba_layer` on the plain path passes ``cfg.inner_remat`` to the
    chunked scan, as the reference's does."""
    cfg = dataclasses.replace(ref_registry.get_smoke("falcon-mamba-7b"),
                              dtype="float32", param_dtype="float32",
                              inner_remat=True)
    pcfg = registry.get_smoke("falcon-mamba-7b").replace(
        dtype="float32", param_dtype="float32", inner_remat=True)
    rp = RM.init_mamba(jax.random.PRNGKey(5), cfg, jnp.float32)
    names = sorted(rp)
    rng = np.random.default_rng(52)
    x = rng.standard_normal((2, 150, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 150, cfg.d_model)).astype(np.float32)

    def ref_fn(x, *leaves):
        return RM.mamba_layer(dict(zip(names, leaves)), cfg, x)[0]

    jy, vjp = jax.vjp(ref_fn, jnp.asarray(x), *(rp[k] for k in names))
    jgrads = vjp(jnp.asarray(dy))
    pp = params_from_numpy(jax.tree.map(np.asarray, rp))

    def port_fn(x, *rest):
        *leaves, remat = rest
        c = pcfg.replace(inner_remat=remat)
        return (M.mamba_layer(dict(zip(names, leaves)), c, x,
                              plain=True)[0],)

    (y,), grads = _remat_pair(port_fn, [torch.from_numpy(x)]
                              + [pp[k] for k in names],
                              [torch.from_numpy(dy)])
    _grads_close([y], [jy])
    _grads_close(grads, jgrads)


@pytest.mark.parametrize("window,causal,Sq", [(0, True, 96), (24, True, 80),
                                              (0, False, 70)])
def test_blocked_attention_inner_remat(window, causal, Sq):
    rng = np.random.default_rng(53)
    H, K, hd = 4, 2, 16
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, Sq, H, hd), (2, Sq, K, hd), (2, Sq, K, hd))]
    dout = rng.standard_normal((2, Sq, H, hd)).astype(np.float32)
    kw = dict(window=window, causal=causal, q_block=32, kv_block=16)
    jout, vjp = jax.vjp(lambda q, k, v: ref_layers.blocked_causal_attention(
        q, k, v, inner_remat=True, **kw), *map(jnp.asarray, arrs))
    jgrads = vjp(jnp.asarray(dout))
    (out,), grads = _remat_pair(
        lambda q, k, v, remat: (layers.blocked_causal_attention(
            q, k, v, inner_remat=remat, **kw),),
        list(map(torch.from_numpy, arrs)), [torch.from_numpy(dout)])
    _grads_close([out], [jout])
    _grads_close(grads, jgrads)


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms: the CPU embedding backward
    otherwise adds a token's rows in an order that changes from run to
    run (two runs of one config differ in the last bits)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_smoke_model_inner_remat(arch, deterministic):
    """A smoke model with ``inner_remat`` on the plain path: the loss and
    every gradient leaf against ``jax.value_and_grad`` of the reference's
    with ``inner_remat``, and equal bit for bit to the port's run
    without it, whose backward recomputes less."""
    cfg = dataclasses.replace(ref_registry.get_smoke(arch), dtype="float32",
                              param_dtype="float32", inner_remat=True,
                              remat_policy="none")
    ref = ref_get_model(cfg)
    rparams = ref.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(54)
    toks = rng.integers(0, cfg.vocab_size, (2, 161), dtype=np.int32)
    rbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "targets": jnp.asarray(toks[:, 1:])}
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: ref.loss(p, rbatch), has_aux=True)(rparams)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "targets": torch.from_numpy(toks[:, 1:].copy())}
    out = {}
    for remat in (True, False):
        pcfg = registry.get_smoke(arch).replace(
            dtype="float32", param_dtype="float32", inner_remat=remat,
            remat_policy="none")
        port = get_model(pcfg, device="cpu")
        pparams = params_from_numpy(jax.tree.map(np.asarray, rparams))
        leaves = serialize.leaves(pparams)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = port.loss(pparams, batch, plain=True)
        with CountExp() as count:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out[remat] = (loss.detach(), [torch.zeros_like(p) if g is None
                                      else g for p, g in zip(leaves, grads)],
                      count.exp)
    np.testing.assert_allclose(float(out[True][0]), float(rloss), rtol=1e-5)
    _grads_close(out[True][1], [r for _, r in
                                jax.tree_util.tree_flatten_with_path(
                                    rgrads)[0]])
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
    assert out[True][2] > out[False][2]
