"""SeamlessM4T-large-v2's serving steps (the encoder-decoder: the encoder
over precomputed frame embeddings, the decoder's causal self-attention
and its cross-attention over the encoder's output) on the CPU meshes
(1, 2), (1, 4) and (2, 2): the port's sharded ``prefill`` and
``decode_step`` on gloo ranks against the reference's jitted steps under
the dry run's shardings (params, batch, the self and cross caches with W
and Ss over ``model`` in the prefill layout and head_dim over ``model``
in the decode layout, the logits), from the same params, embeddings and
tokens (tests/_torch_mesh.py `ServeCases`), smoke in f32; at B 1 on
(2, 2), the ``long_500k`` layout; with an odd vocab of 509 on (1, 2)
(seamless's own 256206 is odd over ``model`` 4); with a source of 24
frames longer than the 16-token target on (1, 2); and with a source of
22 frames on (1, 4), which ``model`` does not divide (the prefill layout
keeps every source slot on each rank). The decode steps start from the
reference's one-device prefill cache placed by the decode rules. One
reference subprocess for every case, one spawn a world size."""
import pytest

from tests._torch_mesh import (B, MESHES, ServeCases, embed_sums,
                               serve_cases, serve_lengths, serve_rows)

ARCH = "seamless-m4t-large-v2"
#: {key: (arch, overrides, meshes[, batch[, (St, Ss)]])}
CASES = {"seamless": (ARCH, {}, MESHES),
         "seamless B 1": (ARCH, {}, ((2, 2),), 1),
         "seamless vocab 509": (ARCH, {"vocab_size": 509}, ((1, 2),)),
         "seamless Ss 24 St 16": (ARCH, {}, ((1, 2),), B, (16, 24)),
         "seamless Ss 22 St 16": (ARCH, {}, ((1, 4),), B, (16, 22))}
RUNS = [(key, shape) for key, case in CASES.items() for shape in case[2]]


@pytest.fixture(scope="module")
def serves(tmp_path_factory):
    return serve_cases(CASES, tmp_path_factory.mktemp("serve_encdec"))


@pytest.mark.parametrize("key, shape", RUNS,
                         ids=[f"{k}-{s[0]}x{s[1]}" for k, s in RUNS])
class TestEncDecServeOnMesh(ServeCases):
    CASES = CASES

    def test_collectives_by_kind(self, serves, key, shape):
        """A prefill sends each decoder layer's k, v, cross_k and cross_v
        by one ``all_to_all`` each and sums over ``model`` each encoder
        layer's ``wo`` and MLP, each decoder layer's self ``wo``, cross
        ``wo`` and MLP, and the target's embedding where its vocab is
        split over ``model`` (not the odd vocab's). A
        decode step moves q, k, v and the outputs of its self-attention
        (four ``all_to_all`` a layer) and q and the outputs of its
        cross-attention (two), sums the f32 scores of both over ``model``
        (rows, H, W) and (rows, H, Ss) (their own kind; nothing is
        written into the cross cache), and each layer's three
        row-parallel products (rows, 1, D) and the split embedding."""
        cfg = self.cfg(key)
        L, Le, D, H = (cfg.num_layers, cfg.num_encoder_layers, cfg.d_model,
                       cfg.num_heads)
        rows = serve_rows(CASES[key], shape)
        St, Ss = serve_lengths(CASES[key])
        emb = embed_sums(cfg, shape)
        for rank in serves[key][1][shape]:
            calls = rank["prefill_collectives"]["calls"]
            assert calls["all_to_all"] == 4 * L
            assert calls["all_reduce"] == 2 * Le + emb + 3 * L
            for c in rank["decode_collectives"]:
                assert c["calls"]["all_to_all"] == 6 * L
                assert c["calls"]["score_all_reduce"] == 2 * L
                assert c["bytes_by"]["score_all_reduce"] == (
                    L * rows * H * (St + Ss) * 4)
                assert c["calls"]["all_reduce"] == 3 * L + emb
                assert c["bytes_by"]["all_reduce"] == (
                    (3 * L + emb) * rows * D * 4)


@pytest.mark.parametrize("key, shape, want", [
    ("seamless Ss 24 St 16", (1, 2), {"k": (2, 2, 8, 4, 32),
                                      "cross_k": (2, 2, 12, 4, 32),
                                      "decode": (2, 2, 24, 4, 16)}),
    ("seamless Ss 22 St 16", (1, 4), {"k": (2, 2, 4, 4, 32),
                                      "cross_k": (2, 2, 22, 4, 32),
                                      "decode": (2, 2, 22, 4, 8)}),
], ids=["Ss24-1x2", "Ss22-1x4"])
def test_the_cross_cache_takes_the_source_s_length(serves, key, shape,
                                                    want):
    """The cross leaves are the source's Ss long, not the self cache's W:
    Ss 24 over ``model`` 2 in the prefill layout (12 slots a rank); Ss
    22, which ``model`` 4 does not divide, whole (the rule's guard),
    while the self cache's 16 slots split; in the decode layout every
    source slot and a head_dim slice, in both packages."""
    ref, port = serves[key]
    for shapes in [ref["meshes"][shape]] + port[shape]:
        assert shapes["prefill_shapes"]["k"] == want["k"]
        assert shapes["prefill_shapes"]["cross_k"] == want["cross_k"]
        assert shapes["decode_shapes"]["cross_k"] == want["decode"]


def test_a_head_dim_that_model_does_not_divide_raises():
    """seamless's smoke head_dim of 32 over ``model`` 3: the decode
    cache's rules leave the self and cross caches' head_dim whole, so
    both serving steps raise before any work, naming the leaf."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import get_model
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.registry import param_structs

    cfg = registry.get_smoke(ARCH)
    tp = SH.serve_placement(Mesh(("data", "model"), (1, 3)),
                            param_structs(cfg),
                            kvc.init_cache(cfg, 2, 64, device="meta"))
    model = get_model(cfg, device="cpu")
    batch = {"src_embeds": torch.zeros((2, 64, cfg.d_model)),
             "tgt_tokens": torch.zeros((2, 64), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="cache's k .* head_dim of "
                       "32, which model 3 does not split"):
        model.prefill(None, batch, tp=tp)
    with pytest.raises(NotImplementedError, match="head_dim of 32"):
        model.decode_step(None, {}, torch.zeros((2, 1), dtype=torch.int32),
                          tp=tp)
