"""InternVL2-2B's serving steps (the vlm family: the dense decoder fed
precomputed embeddings) on the CPU meshes (1, 2), (1, 4) and (2, 2): the
port's sharded ``prefill`` of an ``inputs_embeds`` batch (its rows over
``data``) and ``decode_step`` on gloo ranks against the reference's
jitted steps under the dry run's shardings, from the same params, embeddings
and tokens (tests/_torch_mesh.py `ServeCases`), smoke in f32; at B 1 on
(2, 2), the ``long_500k`` layout (the batch replicated over ``data``);
and with an odd vocab of 509 on (1, 2), as internvl2-2b's own 92553:
``model`` does not divide it, so the embedding and head stay replicated
over ``model`` and the logits' vocab whole. The decode steps start from
the reference's one-device prefill cache placed by the decode rules. One
reference subprocess for every case, one spawn a world size."""
import pytest

from tests._torch_mesh import (MESHES, S, ServeCases, embed_sums,
                               serve_cases, serve_rows)

ARCH = "internvl2-2b"
#: {key: (arch, overrides, meshes[, batch])}
CASES = {"internvl2-2b": (ARCH, {}, MESHES),
         "internvl2-2b B 1": (ARCH, {}, ((2, 2),), 1),
         "internvl2-2b vocab 509": (ARCH, {"vocab_size": 509}, ((1, 2),))}
RUNS = [(key, shape) for key, case in CASES.items() for shape in case[2]]


@pytest.fixture(scope="module")
def serves(tmp_path_factory):
    return serve_cases(CASES, tmp_path_factory.mktemp("serve_vlm"))


@pytest.mark.parametrize("key, shape", RUNS,
                         ids=[f"{k}-{s[0]}x{s[1]}" for k, s in RUNS])
class TestVlmServeOnMesh(ServeCases):
    CASES = CASES

    def test_collectives_by_kind(self, serves, key, shape):
        """A prefill of embeddings sums no embedding: each layer's k and
        v go by one ``all_to_all`` each and its row-parallel ``wo`` and
        MLP are summed over ``model``. A decode step embeds its tokens
        vocab-parallel, as the dense family's: four ``all_to_all`` a
        layer (q, k, v, the outputs), each layer's f32 scores (rows, H,
        W) summed over ``model`` (their own kind), and each layer's two
        row-parallel products (rows, 1, D) and the embedding where its
        vocab is split over ``model`` (not the odd vocab's)."""
        cfg = self.cfg(key)
        L, D = cfg.num_layers, cfg.d_model
        rows = serve_rows(CASES[key], shape)
        emb = embed_sums(cfg, shape)
        for rank in serves[key][1][shape]:
            calls = rank["prefill_collectives"]["calls"]
            assert calls["all_to_all"] == 2 * L
            assert calls["all_reduce"] == 2 * L
            for c in rank["decode_collectives"]:
                assert c["calls"]["all_to_all"] == 4 * L
                assert c["calls"]["score_all_reduce"] == L
                assert c["bytes_by"]["score_all_reduce"] == (
                    L * rows * cfg.num_heads * S * 4)
                assert c["calls"]["all_reduce"] == 2 * L + emb
                assert c["bytes_by"]["all_reduce"] == (
                    (2 * L + emb) * rows * D * 4)


def test_odd_vocab_is_replicated_over_model(serves):
    """vocab 509 on (1, 2): the reference's guards leave the embedding's
    and the head's vocab and the logits' whole, and so do the port's
    (every rank holds all 509 columns, in the prefill and each step), so
    a decode step sums no embedding over ``model``."""
    from repro_torch.configs import registry

    assert embed_sums(registry.get_smoke(ARCH).replace(vocab_size=509),
                      (1, 2)) == 0
    ref, port = serves["internvl2-2b vocab 509"]
    want = ref["meshes"][(1, 2)]
    assert want["prefill_shapes"]["logits"][2] == 509
    assert want["decode_shapes"]["logits"][2] == 509
    for rank in port[(1, 2)]:
        assert rank["prefill"]["logits"][0].shape[2] == 509
        assert all(got.shape[2] == 509
                   for got, _ in rank["decode"]["logits"])
