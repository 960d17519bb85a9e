"""Training in the port (``repro_torch.models.lm.forward_train``,
``encdec.forward_train``, ``optim``, ``launch/train``) against the
reference's (``repro.models``, ``repro.optim``), on the CPU.

The reference's params (JAX init, smoke configs) reach the port through
`repro_torch.models.convert`; inputs are drawn with numpy and handed to
both. The loss and the gradient of every params leaf are held to
``jax.value_and_grad`` of the reference's ``model.loss``:

* f32 configs: the loss at rtol 1e-5, each leaf within 1e-4 of its
  largest |value| (the frameworks sum in other orders);
* bf16 (llama3-8b, qwen3-moe-30b-a3b, seamless-m4t-large-v2): the loss
  within 2e-2, each leaf within 5e-2 of its largest |value|. MoE routing
  is a discrete choice: where the port's bf16 activations put a token's
  k-th and (k+1)-th router probabilities on the other side of a near-tie
  (within ``ROUTE_TOL``), the port is held to the reference's experts for
  that token (`PinnedRouting`); a flip at a larger margin fails.

The attention's gradient on the card is the backward kernel
(``csrc/flash_attention_bwd.cu``, tested on the card in
tests/test_torch_cuda.py); `tiled_backward` repeats its three passes
tile by tile here, and is held to the reference's autodiff and to the
port's plain backward `mha_ref_bwd`. The selective scan's gradient is
its autograd Function, which on CPU tensors runs the plain backward
`ssm_scan_ref_bwd` (tests/test_torch_scan_bwd.py): the ssm and hybrid
archs' gradients below go through it.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro.models import get_model as ref_get_model
from repro.models import moe as ref_moe
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import make_train_step as ref_make_train_step
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.adamw import compress_grads as ref_compress_grads
from repro.optim.adamw import cosine_schedule as ref_cosine_schedule
from repro_torch.configs import ARCH_IDS, registry
from repro_torch.kernels.flash_attention import (mha, mha_bwd, mha_ref,
                                                 mha_ref_bwd,
                                                 mha_ref_with_lse,
                                                 mha_with_lse)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.launch import train
from repro_torch.models import get_model, lm, moe, serialize
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import (adamw_init, adamw_update, cosine_schedule,
                               make_train_step)
from repro_torch.optim.adamw import (compress_grads, decompress_grads,
                                     global_norm)

F32 = {"loss_rtol": 1e-5, "leaf": 1e-4}
BF16 = {"loss_atol": 2e-2, "leaf": 5e-2}
#: the router margin within which bf16 routing may flip (as
#: tests/test_torch_model.py's ROUTE_TOL)
ROUTE_TOL = 2e-2
BF16_ARCHS = ["llama3-8b", "qwen3-moe-30b-a3b", "seamless-m4t-large-v2"]
B, S = 2, 64


def _dtype(cfg, dtype):
    return dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)


def _batches(cfg, rng, batch=B, seq=S):
    """A training batch for the reference and for the port from the same
    numpy draws: tokens and their next-token targets, or (vlm) bf16
    embeddings, or (enc-dec) bf16 source frames, three longer than the
    target."""
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
    tgt = toks[:, 1:]
    if cfg.is_encoder_decoder:
        emb = rng.standard_normal((batch, seq + 3, cfg.d_model))
        ref = {"src_embeds": jnp.asarray(emb, jnp.bfloat16),
               "tgt_tokens": jnp.asarray(toks[:, :-1])}
        port = {"src_embeds": torch.from_numpy(emb.astype(np.float32)).to(
            torch.bfloat16), "tgt_tokens": torch.from_numpy(toks[:, :-1])}
    elif cfg.embed_input:
        emb = rng.standard_normal((batch, seq, cfg.d_model))
        ref = {"inputs_embeds": jnp.asarray(emb, jnp.bfloat16)}
        port = {"inputs_embeds": torch.from_numpy(emb.astype(np.float32)).to(
            torch.bfloat16)}
    else:
        ref = {"tokens": jnp.asarray(toks[:, :-1])}
        port = {"tokens": torch.from_numpy(toks[:, :-1].copy())}
    ref["targets"] = jnp.asarray(tgt)
    port["targets"] = torch.from_numpy(tgt.copy())
    return ref, port


def _pair(arch, dtype="float32", seed=0, remat=None):
    cfg = _dtype(ref_registry.get_smoke(arch), dtype)
    pcfg = _dtype(registry.get_smoke(arch), dtype)
    if remat is not None:
        cfg, pcfg = cfg.replace(remat_policy=remat), pcfg.replace(
            remat_policy=remat)
    ref = ref_get_model(cfg)
    rparams = ref.init_params(jax.random.PRNGKey(seed))
    port = get_model(pcfg, device="cpu")
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams))
    return ref, rparams, port, pparams


def _port_loss_and_grads(port, pparams, batch):
    leaves = serialize.leaves(pparams)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = port.loss(pparams, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _assert_leaves(grads, ref_grads, tol):
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(grads) == len(ref_leaves)
    for g, (path, r) in zip(grads, ref_leaves):
        want = np.asarray(r, np.float32)
        got = g.float().numpy()
        assert got.shape == want.shape, jax.tree_util.keystr(path)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, (f"{jax.tree_util.keystr(path)}: "
                                    f"{err:.3e} of max {scale:.3e}")


class PinnedRouting:
    """The reference's MoE routing, recorded per layer in its forward pass
    (the first L router calls, in layer order), and the port's router held
    to it: for each token whose expert set differs, the k-th and
    (k+1)-th probabilities must lie within ``ROUTE_TOL`` in both packages
    (else the test fails), and the port then takes the reference's
    experts, with its own probabilities as gates (so the router's
    gradient is the port's)."""

    def __init__(self, monkeypatch, pparams, L):
        self.ref, self.flips, self.margins = [], 0, []
        ref_route, port_route = ref_moe._route, moe._route
        routers = pparams["layers"]["moe"]["router"]
        self.layer = {routers[i].data_ptr(): i for i in range(L)}

        def ref_spy(p, cfg, xf):
            out = ref_route(p, cfg, xf)
            probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], -1)
            jax.debug.callback(
                lambda i, pr: self.ref.append((np.asarray(i), np.asarray(pr))),
                out[1], probs, ordered=True)
            return out

        def port_spy(p, cfg, xf):
            gates, idx, aux = port_route(p, cfg, xf)
            ridx, rprobs = self.ref[self.layer[p["router"].data_ptr()]]
            ridx = torch.from_numpy(ridx.astype(np.int64))
            flip = (idx.sort(-1).values != ridx.sort(-1).values).any(-1)
            if not bool(flip.any()):
                return gates, idx, aux
            k = cfg.num_experts_per_tok
            probs = torch.softmax(xf.float() @ p["router"], -1)
            for pr in (probs.detach().numpy(), rprobs):
                top = -np.sort(-pr, axis=-1)
                margin = (top[:, k - 1] - top[:, k])[flip.numpy()]
                assert margin.max() <= ROUTE_TOL, margin
                self.margins.append(float(margin.max()))
            self.flips += int(flip.sum())
            idx = torch.where(flip[:, None], ridx, idx)
            gates = probs.gather(-1, idx)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            E = cfg.num_experts
            ce = torch.zeros((E,), dtype=torch.float32)
            ce.index_add_(0, idx.reshape(-1),
                          torch.ones(idx.numel(), dtype=torch.float32))
            ce = ce / ce.sum().clamp_min(1.0)
            aux = E * torch.sum(probs.mean(dim=0) * ce) * cfg.router_aux_loss
            return gates, idx, aux

        monkeypatch.setattr(ref_moe, "_route", ref_spy)
        monkeypatch.setattr(moe, "_route", port_spy)


def _check_loss_and_grads(arch, dtype, monkeypatch):
    ref, rparams, port, pparams = _pair(arch, dtype)
    rbatch, pbatch = _batches(port.cfg, np.random.default_rng(0))
    pin = (PinnedRouting(monkeypatch, pparams, port.cfg.num_layers)
           if port.cfg.family == "moe" and dtype == "bfloat16" else None)
    (rloss, rmetrics), rgrads = jax.value_and_grad(
        lambda p: ref.loss(p, rbatch), has_aux=True)(rparams)
    loss, metrics, grads = _port_loss_and_grads(port, pparams, pbatch)
    if pin is not None:
        print(f"{pin.flips} tokens held to the reference's experts at "
              f"margins up to {max(pin.margins, default=0.0):.3e}")
    assert set(metrics) == set(rmetrics) == {"ce_loss", "aux_loss"}
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(rloss),
                                   rtol=F32["loss_rtol"])
        np.testing.assert_allclose(float(metrics["aux_loss"]),
                                   float(rmetrics["aux_loss"]), rtol=1e-5,
                                   atol=1e-9)
    else:
        assert abs(float(loss) - float(rloss)) <= BF16["loss_atol"]
    _assert_leaves(grads, rgrads, F32["leaf"] if dtype == "float32"
                   else BF16["leaf"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference_f32(arch, monkeypatch):
    _check_loss_and_grads(arch, "float32", monkeypatch)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_loss_and_grads_match_reference_bf16(arch, monkeypatch):
    _check_loss_and_grads(arch, "bfloat16", monkeypatch)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b",
                                  "hymba-1.5b", "seamless-m4t-large-v2"])
def test_remat_policies_give_the_same_loss_and_grads(arch):
    """The remat policy trades memory for compute only: the loss and every
    gradient are equal, bit for bit, under none, dots and full."""
    out = {}
    for policy in lm.REMAT_POLICIES:
        _, _, port, pparams = _pair(arch, remat=policy)
        _, pbatch = _batches(port.cfg, np.random.default_rng(1))
        out[policy] = _port_loss_and_grads(port, pparams, pbatch)
    for policy in ("dots", "full"):
        assert torch.equal(out[policy][0], out["none"][0]), policy
        for a, b in zip(out[policy][2], out["none"][2]):
            assert torch.equal(a, b), policy


def test_remat_dots_saves_the_projection_products():
    """Under "dots" the selective checkpoint keeps each layer's mm
    outputs, and recomputes the rest: fewer ops run again in the backward
    pass than under "full", more than under "none"."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in lm._DOTS:
                self.mm += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for policy in lm.REMAT_POLICIES:
        _, _, port, pparams = _pair("llama3-8b", remat=policy)
        _, pbatch = _batches(port.cfg, np.random.default_rng(2))
        with Count() as c:
            _port_loss_and_grads(port, pparams, pbatch)
        counts[policy] = c.mm
    # "full" recomputes each layer's projections (up to the last one a
    # saved tensor needs: the recompute stops early), "dots" none of them
    assert counts["none"] == counts["dots"] < counts["full"]


def test_unknown_remat_policy_raises():
    _, _, port, pparams = _pair("llama3-8b", remat="everything")
    _, pbatch = _batches(port.cfg, np.random.default_rng(0))
    with pytest.raises(ValueError, match="remat_policy"):
        _port_loss_and_grads(port, pparams, pbatch)


def test_chunked_ce_loss_pads_and_masks_like_the_reference():
    """S = 100 with chunk 32: the last chunk padded with targets -1, and
    some targets -1 in the batch too."""
    from repro.models import lm as ref_lm
    cfg = ref_registry.get_smoke("llama3-8b").replace(dtype="float32",
                                                      param_dtype="float32")
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 100, cfg.d_model)).astype(np.float32)
    head = rng.standard_normal((cfg.d_model, cfg.vocab_size)).astype(
        np.float32) * 0.05
    tgt = rng.integers(0, cfg.vocab_size, (2, 100), dtype=np.int32)
    tgt[0, :7] = -1
    want = ref_lm.chunked_ce_loss(cfg, {"lm_head": jnp.asarray(head)},
                                  jnp.asarray(hidden), jnp.asarray(tgt),
                                  chunk=32)
    got = lm.chunked_ce_loss(cfg, {"lm_head": torch.from_numpy(head)},
                             torch.from_numpy(hidden), torch.from_numpy(tgt),
                             chunk=32)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------ optimizer

def _ref_tree(rng, scale=1.0):
    return {"a": rng.standard_normal((32, 16)).astype(np.float32) * scale,
            "b": rng.standard_normal((64,)).astype(np.float32) * scale * 0.1,
            "c": {"d": rng.standard_normal((8, 8, 4)).astype(np.float32)}}


def _torch_tree(tree):
    return params_from_numpy(tree)


def test_cosine_schedule_matches_reference():
    lr, rlr = cosine_schedule(3e-4, 10, 100), ref_cosine_schedule(3e-4, 10,
                                                                   100)
    for step in (0, 1, 10, 55, 100, 150):
        np.testing.assert_allclose(float(lr(step)), float(rlr(step)),
                                   rtol=1e-6, atol=1e-12)
    # a step tensor on the device, as make_train_step passes it
    step = torch.tensor(5, dtype=torch.int32)
    np.testing.assert_allclose(float(lr(step + 1)), float(rlr(6)), rtol=1e-6)


def test_clipping_matches_reference():
    params = {"w": np.ones((4, 4), np.float32)}
    huge = {"w": np.full((4, 4), 1e6, np.float32)}
    ref = ref_adamw_update(ref_adamw_init(jax.tree.map(jnp.asarray, params)),
                           jax.tree.map(jnp.asarray, huge), lr=1e-3,
                           clip_norm=1.0)
    got = adamw_update(adamw_init(_torch_tree(params)), _torch_tree(huge),
                       lr=1e-3, clip_norm=1.0)
    for name in ("params", "mu", "nu"):
        np.testing.assert_allclose(getattr(got, name)["w"].numpy(),
                                   np.asarray(getattr(ref, name)["w"]),
                                   rtol=1e-6)
    assert int(got.step) == int(ref.step) == 1
    # clipped: the applied step is bounded by lr * O(1)
    assert float((got.params["w"] - 1).abs().max()) < 0.01


def test_global_norm_matches_reference_across_chunks(monkeypatch):
    """The f32 sum of squares, a leaf split into chunks or not."""
    from repro.optim.adamw import global_norm as ref_global_norm
    from repro_torch.optim import adamw as port_adamw
    tree = _ref_tree(np.random.default_rng(4))
    want = float(ref_global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(global_norm(_torch_tree(tree)))
    monkeypatch.setattr(port_adamw, "NORM_CHUNK", 100)
    chunked = float(global_norm(_torch_tree(tree)))
    np.testing.assert_allclose([got, chunked], [want, want], rtol=1e-6)


def test_compress_grads_matches_reference():
    """q exactly equal, the scales and the error feedback equal."""
    rng = np.random.default_rng(5)
    g, e = _ref_tree(rng), _ref_tree(rng, scale=1e-3)
    rq, rs, re = ref_compress_grads(jax.tree.map(jnp.asarray, g),
                                    jax.tree.map(jnp.asarray, e))
    q, s, err = compress_grads(_torch_tree(g), _torch_tree(e))
    for a, b in zip(serialize.leaves(q), jax.tree.leaves(rq)):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(serialize.leaves(s) + serialize.leaves(err),
                    jax.tree.leaves(rs) + jax.tree.leaves(re)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compress_rounds_half_to_even():
    g = {"x": torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0])}
    q, s, _ = compress_grads(g, {"x": torch.zeros(5)})
    assert float(s["x"]) == 1.0
    assert q["x"].tolist() == [0, 2, 2, 0, 127]


class TestGradientCompression:
    """Port copy of tests/test_distributed_extras.py::TestGradientCompression."""

    def _tree(self, seed, scale=1.0):
        rng = np.random.default_rng(seed)
        return _torch_tree({
            "a": rng.standard_normal((32, 16)).astype(np.float32) * scale,
            "b": rng.standard_normal((64,)).astype(np.float32) * scale * 0.1,
            "c": {"d": rng.standard_normal((8, 8, 4)).astype(np.float32)}})

    def _zeros(self, tree):
        return {k: self._zeros(v) if isinstance(v, dict)
                else torch.zeros_like(v) for k, v in tree.items()}

    def test_roundtrip_error_bounded(self):
        g = self._tree(0)
        q, scales, err = compress_grads(g, self._zeros(g))
        back = decompress_grads(q, scales)
        for leaf_g, leaf_b, leaf_s in zip(serialize.leaves(g),
                                          serialize.leaves(back),
                                          serialize.leaves(scales)):
            assert float((leaf_g - leaf_b).abs().max()) <= \
                float(leaf_s) * 0.51 + 1e-6

    def test_error_feedback_is_unbiased_over_steps(self):
        err = self._zeros(self._tree(1))
        total_true = total_sent = None
        for i in range(20):
            g = self._tree(100 + i)
            q, scales, err = compress_grads(g, err)
            sent = decompress_grads(q, scales)
            total_true = g if total_true is None else {
                k: _add(total_true[k], g[k]) for k in g}
            total_sent = sent if total_sent is None else {
                k: _add(total_sent[k], sent[k]) for k in sent}
        for t, s, e in zip(serialize.leaves(total_true),
                           serialize.leaves(total_sent),
                           serialize.leaves(err)):
            np.testing.assert_allclose((t - s).numpy(), e.numpy(), atol=1e-4,
                                       rtol=1e-4)

    def test_int8_payload(self):
        g = self._tree(2)
        q, _, _ = compress_grads(g, self._zeros(g))
        assert all(x.dtype == torch.int8 for x in serialize.leaves(q))


def _add(a, b):
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    return a + b


class TestOptimizer:
    """Port copy of tests/test_distributed_extras.py::TestOptimizer."""

    def test_cosine_schedule_shape(self):
        lr = cosine_schedule(1e-3, warmup=10, total=100)
        assert float(lr(0)) == 0.0
        assert float(lr(10)) == pytest.approx(1e-3, rel=1e-5)
        assert float(lr(100)) == pytest.approx(0.0, abs=1e-9)
        assert float(lr(5)) == pytest.approx(5e-4, rel=1e-5)

    def test_grad_clipping(self):
        params = {"w": torch.ones((4, 4))}
        state = adamw_init(params)
        huge = {"w": torch.full((4, 4), 1e6)}
        new = adamw_update(state, huge, lr=1e-3, clip_norm=1.0)
        delta = float((new.params["w"] - 1).abs().max())
        assert delta < 0.01


def _ref_state_np(state):
    return {name: jax.tree.map(lambda x: np.asarray(x, np.float32),
                               getattr(state, name))
            for name in ("params", "mu", "nu")}


def test_adamw_update_with_reference_grads():
    """`adamw_update` fed the reference's own gradients of llama3-8b smoke
    (f32) at step 3 of a warm state: params, mu and nu to f32 rounding."""
    ref, rparams, port, pparams = _pair("llama3-8b")
    rbatch, _ = _batches(port.cfg, np.random.default_rng(6))
    rgrads = jax.grad(lambda p: ref.loss(p, rbatch)[0])(rparams)
    rng = np.random.default_rng(7)
    rstate = ref_adamw_init(rparams)
    rstate = rstate.__class__(
        step=jnp.asarray(3, jnp.int32), params=rstate.params,
        mu=jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32) * 1e-3), rstate.mu),
        nu=jax.tree.map(lambda x: jnp.asarray(
            rng.random(x.shape).astype(np.float32) * 1e-5), rstate.nu))
    state = adamw_init(pparams)
    state.step = torch.tensor(3, dtype=torch.int32)
    state.mu = params_from_numpy(jax.tree.map(np.asarray, rstate.mu))
    state.nu = params_from_numpy(jax.tree.map(np.asarray, rstate.nu))
    lr = 3e-4
    want = _ref_state_np(ref_adamw_update(rstate, rgrads, lr))
    got = adamw_update(state, params_from_numpy(
        jax.tree.map(np.asarray, rgrads)), lr)
    assert int(got.step) == 4
    for name in ("params", "mu", "nu"):
        for a, b in zip(serialize.leaves(getattr(got, name)),
                        jax.tree.leaves(want[name])):
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-6,
                                       atol=2e-6 * float(np.abs(b).max()))


def test_train_step_matches_reference():
    """One `make_train_step` on f32 llama3-8b smoke against the
    reference's: loss and grad_norm at rtol 1e-5, mu and nu at rtol 1e-5
    (with an atol of 1e-5 of the leaf's largest |value|: the gradients
    differ in the last bits), and the new params within 2 lr of the
    reference's (a first Adam step is lr sign(g), which may flip where
    g ~ 0)."""
    ref, rparams, port, pparams = _pair("llama3-8b")
    rbatch, pbatch = _batches(port.cfg, np.random.default_rng(8))
    rstate, rmetrics = ref_make_train_step(ref)(ref_adamw_init(rparams),
                                                rbatch)
    state, metrics = make_train_step(port)(adamw_init(pparams), pbatch)
    for key in ("loss", "grad_norm", "ce_loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[key]), float(rmetrics[key]),
                                   rtol=1e-5, atol=1e-9, err_msg=key)
    assert int(state.step) == int(rstate.step) == 1
    want = _ref_state_np(rstate)
    lr = float(ref_cosine_schedule(3e-4, 100, 10_000)(1))
    for name in ("mu", "nu"):
        for a, b in zip(serialize.leaves(getattr(state, name)),
                        jax.tree.leaves(want[name])):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(b).max()))
    for a, b in zip(serialize.leaves(state.params),
                    jax.tree.leaves(want["params"])):
        assert float(np.abs(a.numpy() - b).max()) <= 2 * lr


@pytest.mark.parametrize("arch", ARCH_IDS)
class TestArchSmoke:
    """Port copy of tests/test_models.py::TestArchSmoke::
    test_train_step_updates: the smoke config, the port's seeded params,
    one train step, B 2 x S 64."""

    def test_train_step_updates(self, arch):
        cfg = registry.get_smoke(arch)
        model = get_model(cfg, device="cpu")
        params = model.init_params(torch.Generator().manual_seed(1))
        before = [p.clone() for p in serialize.leaves(params)]
        _, batch = _batches(cfg, np.random.default_rng(1))
        if not cfg.embed_input:
            batch["targets"] = batch["tokens"]
        new_state, metrics = make_train_step(model)(adamw_init(params), batch)
        assert math.isfinite(float(metrics["loss"]))
        assert int(new_state.step) == 1
        # at least one param leaf actually moved
        assert any(bool((a != b).any()) for a, b in zip(
            before, serialize.leaves(new_state.params)))


# ------------------------------------------------ the kernel's arithmetic

#: body -> (dk/dv: key rows per CTA, query rows per tile; dq: query rows
#: per CTA, key rows per tile), as csrc/flash_attention_bwd.cu tiles them
BWD_TILES = {"simt": (64, 64, 64, 64), "wgmma": (128, 64, 128, 64)}
LOG2E = 1.4426950408889634


def _bf16(t):
    return t.to(torch.bfloat16).float()


def tiled_backward(q, k, v, out, dout, *, causal, window, body="simt",
                   lse=None):
    """The passes of ``csrc/flash_attention_bwd.cu`` in plain PyTorch,
    tile by tile, with the body's tiles and ranges: D = dout . out; per
    key tile, dk and dv over the G heads of its group and the query tiles
    that see it; per query tile, dq over the key tiles it visits. q, out,
    dout (B, Sq, H, hd); k, v (B, Sk, K, hd); results in q's dtype.

    body "simt": f32 throughout, on the lse that the SIMT forward's loop
    computes (each query tile's online m and l over the key tiles it
    visits, rebuilt here). body "wgmma": the tensor-core kernels, on the
    forward's ``lse`` (B, H, Sq) in natural units, converted to base 2
    once: P^T = exp2(s scale log2(e) - lse2) on unscaled scores, P^T and
    dS^T rounded to bf16 before their products, f32 sums, dk and dq
    scaled by 1 / sqrt(hd) at the end."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    wgmma = body == "wgmma"
    kv_rows, qt_rows, dq_rows, kt_rows = BWD_TILES[body]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() if wgmma else q.float() * scale
    kf, vf, of, df = k.float(), v.float(), out.float(), dout.float()

    def visible(qp, kp):
        ok = (qp[:, None] < Sq) & (kp[None, :] < Sk)
        if causal:
            ok &= kp[None, :] <= qp[:, None]
        if window > 0:
            ok &= (qp[:, None] - kp[None, :]) < window
        return ok

    def k_range(q0, bq, bk):
        lo, hi = 0, Sk
        if causal:
            hi = min(Sk, q0 + bq)
        if window > 0:
            lo = max(0, q0 - window + 1)
        return range((lo // bk) * bk, hi, bk)

    dsum = (df * of).sum(-1).transpose(1, 2)             # (B, H, Sq)
    if wgmma:
        lse2 = lse * LOG2E
        scale_log2 = torch.tensor(LOG2E, dtype=torch.float32) * scale
    else:
        lse = torch.zeros((B, H, Sq))
        for q0 in range(0, Sq, 64):
            qp = torch.arange(q0, min(q0 + 64, Sq))
            m = torch.full((B, H, len(qp)), -1e30)
            l = torch.zeros((B, H, len(qp)))
            for k0 in k_range(q0, 64, 64):
                kp = torch.arange(k0, min(k0 + 64, Sk))
                s = torch.einsum("bqhd,bshd->bhqs", qf[:, qp],
                                 kf[:, kp].repeat_interleave(G, dim=2))
                s = torch.where(visible(qp, kp), s, -1e30)
                m_new = torch.maximum(m, s.amax(-1))
                l = l * torch.exp(m - m_new) + torch.exp(
                    s - m_new[..., None]).sum(-1)
                m = m_new
            lse[:, :, qp] = m + torch.log(l.clamp_min(1e-30))

    def probs_and_ds(qp, kp, h):
        kh = h // G
        s = torch.einsum("bqd,bsd->bqs", qf[:, qp, h], kf[:, kp, kh])
        if wgmma:
            p = torch.exp2(s * scale_log2 - lse2[:, h, qp][..., None])
        else:
            p = torch.exp(s - lse[:, h, qp][..., None])
        p = torch.where(visible(qp, kp), p, 0.0)
        dp = torch.einsum("bqd,bsd->bqs", df[:, qp, h], vf[:, kp, kh])
        ds = p * (dp - dsum[:, h, qp][..., None])
        return (_bf16(p), _bf16(ds)) if wgmma else (p, ds)

    dq = torch.zeros((B, Sq, H, hd))
    dk = torch.zeros((B, Sk, K, hd))
    dv = torch.zeros((B, Sk, K, hd))
    for k0 in range(0, Sk, kv_rows):
        kp = torch.arange(k0, min(k0 + kv_rows, Sk))
        q_lo = k0 if causal else 0
        q_hi = min(Sq, k0 + kv_rows - 1 + window) if window > 0 else Sq
        for kh in range(K):
            for h in range(kh * G, kh * G + G):
                for q0 in range((q_lo // qt_rows) * qt_rows, q_hi, qt_rows):
                    qp = torch.arange(q0, min(q0 + qt_rows, Sq))
                    p, ds = probs_and_ds(qp, kp, h)
                    dv[:, kp, kh] += torch.einsum("bqs,bqd->bsd", p,
                                                  df[:, qp, h])
                    dk[:, kp, kh] += torch.einsum("bqs,bqd->bsd", ds,
                                                  qf[:, qp, h])
    for q0 in range(0, Sq, dq_rows):
        qp = torch.arange(q0, min(q0 + dq_rows, Sq))
        for h in range(H):
            for k0 in k_range(q0, dq_rows, kt_rows):
                kp = torch.arange(k0, min(k0 + kt_rows, Sk))
                _, ds = probs_and_ds(qp, kp, h)
                step = torch.einsum("bqs,bsd->bqd", ds, kf[:, kp, h // G])
                dq[:, qp, h] += step if wgmma else step * scale
    if wgmma:
        dq, dk = dq * scale, dk * scale
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


@pytest.mark.parametrize("Bq,Sq,Sk,H,K,hd,causal,window", [
    (2, 150, 150, 4, 2, 32, True, 0),
    (1, 130, 130, 4, 4, 16, False, 0),          # G 1, bidirectional
    (1, 200, 200, 6, 1, 16, True, 48),          # G 6, a window
    (1, 100, 170, 4, 2, 16, False, 0),          # cross: Sq < Sk
    (1, 170, 100, 7, 1, 16, True, 0),           # G 7, causal, Sq > Sk
    (1, 140, 140, 8, 1, 32, False, 70),         # G 8, bidirectional window
])
def test_tiled_backward_matches_reference_autodiff(Bq, Sq, Sk, H, K, hd,
                                                   causal, window):
    """The kernel's passes (f32) against ``jax.vjp`` of the reference's
    attention and against the port's `mha_ref_bwd`, f32, within 1e-4 of
    each gradient's largest |value|."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, Sk, K, hd)).astype(np.float32)
            for _ in range(2))
    dout = rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out = mha_ref(tq, tk, tv, causal=causal, window=window)
    got = tiled_backward(tq, tk, tv, out, tdo, causal=causal, window=window)
    plain = mha_ref_bwd(tq, tk, tv, out, tdo, causal=causal, window=window)
    T = (0, 2, 1, 3)
    _, vjp = jax.vjp(lambda a, b, c: ref_attention(
        a, b, c, causal=causal, window=window),
        *(jnp.asarray(x.transpose(T)) for x in (q, k, v)))
    want = [np.asarray(g).transpose(T)
            for g in vjp(jnp.asarray(dout.transpose(T)))]
    for a, p, w in zip(got, plain, want):
        scale = float(np.abs(w).max())
        assert float(np.abs(a.numpy() - w).max()) <= 1e-4 * scale
        assert float(np.abs(p.numpy() - w).max()) <= 1e-4 * scale


#: (B, Sq, Sk, H, K, hd, causal, window): the cases above at the
#: tensor-core body's head dims, and one longer sequence with few heads
WGMMA_BWD_CASES = [
    (2, 150, 150, 4, 2, 64, True, 0),
    (1, 130, 130, 4, 4, 128, False, 0),         # G 1, bidirectional
    (1, 200, 200, 6, 1, 64, True, 48),          # G 6, a window
    (1, 100, 170, 4, 2, 64, False, 0),          # cross: Sq < Sk
    (1, 170, 100, 7, 1, 64, True, 0),           # G 7, causal, Sq > Sk
    (1, 140, 140, 8, 1, 128, False, 70),        # G 8, bidirectional window
    (1, 1100, 1100, 2, 1, 128, True, 0),        # many tiles of a row
]


@pytest.mark.parametrize("Bq,Sq,Sk,H,K,hd,causal,window", WGMMA_BWD_CASES)
def test_tiled_backward_wgmma_matches_reference_autodiff(Bq, Sq, Sk, H, K, hd,
                                                         causal, window):
    """The tensor-core kernels' arithmetic (bf16 P^T and dS^T, the
    forward's base-2 lse from the tensor-core forward's model) on bf16
    inputs, against ``jax.vjp`` of the reference's attention on the same
    bf16 inputs, within 2e-2 of each gradient's largest |value|."""
    from tests.test_torch_attention_tiled import tiled_prefill
    rng = np.random.default_rng(19)
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            [(Bq, Sq, H, hd), (Bq, Sk, K, hd), (Bq, Sk, K, hd),
             (Bq, Sq, H, hd)]]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    T = (0, 2, 1, 3)
    out, lse = tiled_prefill(*(t.permute(T) for t in (tq, tk, tv)),
                             causal=causal, window=window, body="wgmma",
                             with_lse=True)
    got = tiled_backward(tq, tk, tv, out.permute(T), tdo, causal=causal,
                         window=window, body="wgmma", lse=lse)
    jq, jk, jv, jdo = (jnp.asarray(a.transpose(T), jnp.bfloat16)
                       for a in arrs)
    _, vjp = jax.vjp(lambda a, b, c: ref_attention(
        a, b, c, causal=causal, window=window), jq, jk, jv)
    want = [np.asarray(g, np.float32).transpose(T) for g in vjp(jdo)]
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        err = float(np.abs(a.float().numpy() - w).max())
        assert err <= 2e-2 * float(np.abs(w).max())


@pytest.mark.parametrize("Sq,Sk,causal,window", [(90, 90, True, 0),
                                                 (90, 90, True, 17),
                                                 (60, 130, False, 0),
                                                 (130, 60, True, 0),
                                                 (80, 80, False, 25)])
def test_plain_lse_matches_jax_logsumexp(Sq, Sk, causal, window):
    """`mha_ref_with_lse`'s lse against jax's logsumexp of the
    reference's masked scores (-1e30 where masked, scaled by 1/sqrt(hd)),
    and its output against `mha_ref`."""
    rng = np.random.default_rng(20)
    q = rng.standard_normal((2, Sq, 6, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, Sk, 2, 32)).astype(np.float32)
            for _ in range(2))
    out, lse = mha_ref_with_lse(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, window=window)
    assert torch.equal(out, mha_ref(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, window=window))
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q) / math.sqrt(32),
                   jnp.repeat(jnp.asarray(k), 3, axis=2))
    qp, kp = jnp.arange(Sq)[:, None], jnp.arange(Sk)[None, :]
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= (qp - kp) < window
    want = jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1)
    assert lse.shape == (2, 6, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bwd_body_is_the_forward_rule():
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (16, 32, 64, 128):
            assert flash_ops.bwd_body(dtype, hd) == flash_ops.body(dtype, hd)
    assert flash_ops.bwd_body(torch.bfloat16, 128) == "wgmma"
    assert flash_ops.bwd_body(torch.bfloat16, 64) == "wgmma"
    assert flash_ops.bwd_body(torch.bfloat16, 32) == "simt"
    assert flash_ops.bwd_body(torch.float32, 128) == "simt"


def test_mha_bwd_raises_on_cpu_tensors_and_without_lse():
    """The backward kernel runs only on a card: CPU tensors raise before
    anything is built, and so does a missing or misshapen lse; on CPU
    tensors `mha_with_lse` is the plain version."""
    g = torch.Generator().manual_seed(11)
    q, dout = (torch.randn((1, 40, 4, 16), generator=g) for _ in range(2))
    k, v = (torch.randn((1, 40, 2, 16), generator=g) for _ in range(2))
    out, lse = mha_with_lse(q, k, v)
    want = mha_ref_with_lse(q, k, v)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    b0 = flash_ops.bwd_launches
    with pytest.raises(ValueError, match="CUDA device"):
        mha_bwd(q, k, v, out, dout, lse=lse)
    with pytest.raises(TypeError):
        mha_bwd(q, k, v, out, dout)                 # lse is required
    assert flash_ops.bwd_launches == b0


def test_mha_is_differentiable_on_the_cpu():
    """On CPU tensors `mha` is the plain version under autograd."""
    g = torch.Generator().manual_seed(10)
    q = torch.randn((1, 40, 4, 16), generator=g, requires_grad=True)
    k = torch.randn((1, 40, 2, 16), generator=g, requires_grad=True)
    v = torch.randn((1, 40, 2, 16), generator=g, requires_grad=True)
    dout = torch.randn((1, 40, 4, 16), generator=g)
    got = torch.autograd.grad(mha(q, k, v, window=9), (q, k, v), dout)
    want = mha_ref_bwd(q, k, v, None, dout, window=9)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------- families and driver

@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_families_refuse_to_train_on_the_card(arch, monkeypatch):
    """The ssm and hybrid families train on the card: nothing refuses them
    (``lm.check_trainable`` is gone with its refusal), and the scan's
    wrapper takes its autograd Function whenever grad is on, whatever the
    device. On CPU tensors one `forward_train` of the smoke config goes
    through the Function: the plain forward once per layer and its
    recompute under the remat policy, the plain backward once per layer."""
    assert not hasattr(lm, "check_trainable")
    counts = {"forward": 0, "backward": 0}
    fwd, bwd = scan_ops.ssm_scan_ref, scan_ops.ssm_scan_ref_bwd

    def spy(fn, key):
        def call(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(scan_ops, "ssm_scan_ref", spy(fwd, "forward"))
    monkeypatch.setattr(scan_ops, "ssm_scan_ref_bwd", spy(bwd, "backward"))
    _, _, port, pparams = _pair(arch)
    _, pbatch = _batches(port.cfg, np.random.default_rng(3))
    loss, _, grads = _port_loss_and_grads(port, pparams, pbatch)
    L = port.cfg.num_layers
    recompute = 0 if port.cfg.remat_policy == "none" else 1
    assert counts == {"forward": L * (1 + recompute), "backward": L}
    assert math.isfinite(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_train_driver_runs_and_resumes_on_the_cpu():
    """`launch/train.main` on llama3-8b smoke: 4 finite steps with a
    checkpoint every 2; a second `run` on the same runtime resumes from
    step 4 with the state equal bit for bit."""
    result = train.main(["--arch", "llama3-8b", "--smoke", "--steps", "4",
                         "--batch", "2", "--seq", "64", "--ckpt-every", "2",
                         "--device", "cpu"])
    assert [r["step"] for r in result["records"]] == [0, 1, 2, 3]
    assert all(math.isfinite(r["loss"]) for r in result["records"])
    assert result["checkpointer"].saves == 2
    resumed = train.run(registry.get_smoke("llama3-8b"), steps=0, batch=2,
                        seq=64, resume=True, device="cpu",
                        runtime=result["runtime"])
    assert resumed["start_step"] == 4
    a, b = result["state"], resumed["state"]
    assert int(b.step) == 4
    for name in ("params", "mu", "nu"):
        for x, y in zip(serialize.leaves(getattr(a, name)),
                        serialize.leaves(getattr(b, name))):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_train_driver_refuses_embeddings_archs():
    for arch in ("internvl2-2b", "seamless-m4t-large-v2"):
        with pytest.raises(SystemExit, match="token-LM"):
            train.run(registry.get_smoke(arch), steps=1, batch=1, seq=8,
                      device="cpu")


def test_train_driver_has_no_mesh_flag():
    """Without ``--mesh`` the driver trains on one device; ``--mesh
    debug`` on one process (no process group, a mesh of one rank) is
    that same one-device step: the losses bit for bit, no mesh, no
    sharding. Sharded runs: tests/test_torch_mesh_*.py."""
    args = ["--arch", "llama3-8b", "--smoke", "--steps", "2", "--batch",
            "2", "--seq", "32", "--device", "cpu"]
    a = train.main(args)
    b = train.main(args + ["--mesh", "debug"])
    assert a["mesh"] is None and b["mesh"] is None and b["tp"] is None
    assert [r["loss"] for r in a["records"]] == \
        [r["loss"] for r in b["records"]]
