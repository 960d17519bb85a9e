"""The port's training substrates against the reference's: the data
pipeline (``repro_torch.data``) and checkpointing (``repro_torch.checkpoint``
with ``launch/train.unflatten_into``), on the CPU.

Port copies of tests/test_substrate.py's TestDataPipeline and
TestCheckpoint and of tests/test_distributed_extras.py's
TestElasticRestart, then the cross-package checks: the same corpus spec
gives the same shards and batches in both packages, and a checkpoint of
the same state written by either package has the same object names, the
same manifest bytes and the same shard bytes; each package restores the
other's objects (copied store to store) to an equal state.
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import AsyncCheckpointer as RefAsyncCheckpointer
from repro.checkpoint import restore_checkpoint as ref_restore_checkpoint
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.core import metrics as RM
from repro.core.backend import NexusBackend as RefNexusBackend
from repro.core.storage import ObjectStore as RefObjectStore
from repro.core.storage import RemoteStorage as RefRemoteStorage
from repro.data import DataPipeline as RefDataPipeline
from repro.data import SyntheticCorpus as RefSyntheticCorpus
from repro.data.pipeline import CorpusSpec as RefCorpusSpec
from repro.launch.train import unflatten_into as ref_unflatten_into
from repro.models import get_model as ref_get_model
from repro.optim import adamw_init as ref_adamw_init
from repro.configs import registry as ref_registry
from repro_torch.checkpoint import (AsyncCheckpointer, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import registry
from repro_torch.core import metrics as M
from repro_torch.core.backend import NexusBackend
from repro_torch.core.storage import ObjectStore, RemoteStorage
from repro_torch.data import DataPipeline, SyntheticCorpus
from repro_torch.data.pipeline import CorpusSpec
from repro_torch.launch.train import build_runtime, unflatten_into
from repro_torch.models import get_model, serialize
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import TrainState


def make_backend(transport="tcp"):
    store = ObjectStore()
    acct = M.CycleAccount()
    remote = RemoteStorage(store, transport, acct)
    return store, NexusBackend(remote, acct, transport_name=transport)


def make_ref_backend(transport="tcp"):
    store = RefObjectStore()
    acct = RM.CycleAccount()
    remote = RefRemoteStorage(store, transport, acct)
    return store, RefNexusBackend(remote, acct, transport_name=transport)


class TestDataPipeline:
    """Port copy of tests/test_substrate.py::TestDataPipeline."""

    def test_batches_deterministic_and_complete(self):
        store, be = make_backend()
        spec = CorpusSpec("corpus", vocab_size=1000, shard_tokens=4096,
                          num_shards=4, seed=7)
        corpus = SyntheticCorpus(store, spec)
        corpus.materialize()
        pipe = DataPipeline(corpus, be, batch=4, seq_len=128)
        b1 = pipe.next_batch()
        assert b1["tokens"].shape == (4, 128)
        assert b1["targets"].shape == (4, 128)
        # next-token alignment
        np.testing.assert_array_equal(b1["tokens"][:, 1:],
                                      b1["targets"][:, :-1])
        assert b1["tokens"].max() < 1000

    def test_prefetch_overlap_hides_io(self):
        """With compute between batches, the pipeline never blocks."""
        store, be = make_backend()
        spec = CorpusSpec("corpus", vocab_size=100, shard_tokens=2080,
                          num_shards=8, seed=1)
        corpus = SyntheticCorpus(store, spec)
        corpus.materialize()
        pipe = DataPipeline(corpus, be, batch=4, seq_len=64,
                            prefetch_depth=3)
        time.sleep(0.08)                 # step-0 compile hides the prime
        for _ in range(12):
            pipe.next_batch()
            time.sleep(0.01)             # "compute" hides the fetches
        assert pipe.blocking_waits <= 1  # scheduler jitter headroom
        assert pipe.overlap_efficiency() >= 0.8


@pytest.mark.parametrize("compressed", [True, False])
def test_batches_equal_the_reference_pipelines(compressed):
    """The same spec: the same shard objects, byte for byte, and the
    same batches, across shard boundaries and the corpus's wrap."""
    spec = dict(name="corpus", vocab_size=517, shard_tokens=1000,
                num_shards=3, seed=11, compressed=compressed)
    store, be = make_backend()
    rstore, rbe = make_ref_backend()
    corpus = SyntheticCorpus(store, CorpusSpec(**spec))
    rcorpus = RefSyntheticCorpus(rstore, RefCorpusSpec(**spec))
    corpus.materialize()
    rcorpus.materialize()
    assert store.list_bucket("corpus") == rstore.list_bucket("corpus")
    pipe = DataPipeline(corpus, be, batch=3, seq_len=70)
    rpipe = RefDataPipeline(rcorpus, rbe, batch=3, seq_len=70)
    for _ in range(20):                  # 4260 tokens: past the wrap
        got, want = pipe.next_batch(), rpipe.next_batch()
        for key in ("tokens", "targets"):
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
    assert pipe.shard_takes == rpipe.shard_takes


def test_pipeline_constants_are_the_reference_values():
    spec = CorpusSpec("c", 10, 10, 1)
    rspec = RefCorpusSpec("c", 10, 10, 1)
    assert (spec.seed, spec.compressed) == (rspec.seed, rspec.compressed)
    store, be = make_backend()
    corpus = SyntheticCorpus(store, spec)
    corpus.materialize()
    pipe = DataPipeline(corpus, be, batch=1, seq_len=4)
    assert (pipe.depth, pipe.tenant) == (2, "train-pipeline")
    assert corpus.shard_key(3) == "shard-00000"


class TestCheckpoint:
    """Port copy of tests/test_substrate.py::TestCheckpoint."""

    def _tiny_state(self):
        return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                "b": torch.ones((4,), dtype=torch.bfloat16),
                "step": torch.tensor(3, dtype=torch.int32)}

    def test_sync_roundtrip(self):
        store = ObjectStore()
        state = self._tiny_state()
        save_checkpoint(store, "ck", 3, state)
        step, flat = restore_checkpoint(store, "ck")
        assert step == 3
        assert torch.equal(flat["w"], state["w"])
        assert flat["b"].dtype == state["b"].dtype

    def test_async_commit_is_atomic(self):
        store, be = make_backend()
        ck = AsyncCheckpointer(be, bucket="ck")
        state = self._tiny_state()
        ck.save(5, state)
        ck.wait()
        step, flat = restore_checkpoint(store, "ck")
        assert step == 5
        assert torch.equal(flat["w"], state["w"])

    def test_restore_via_backend_prefetch(self):
        store, be = make_backend()
        state = self._tiny_state()
        save_checkpoint(store, "ck", 9, state)
        step, flat = restore_checkpoint(store, "ck", backend=be)
        assert step == 9
        assert be.stats["prefetches"] == len(flat)

    def test_latest_pointer_tracks_newest(self):
        store = ObjectStore()
        save_checkpoint(store, "ck", 1, self._tiny_state())
        save_checkpoint(store, "ck", 2, self._tiny_state())
        step, _ = restore_checkpoint(store, "ck")
        assert step == 2


class TestElasticRestart:
    """Port copy of tests/test_distributed_extras.py::TestElasticRestart."""

    def test_trainstate_checkpoint_roundtrip(self):
        cfg = registry.get_smoke("granite-8b")
        model = get_model(cfg, device="cpu")
        params = model.init_params(torch.Generator().manual_seed(3))
        state = adamw_init(params)
        state = TrainState(step=torch.tensor(7, dtype=torch.int32),
                           params=state.params, mu=state.mu, nu=state.nu,
                           err=state.err)
        store, be = build_runtime()[:2]
        ck = AsyncCheckpointer(be, bucket="ckpts")
        ck.save(7, state)
        ck.wait()

        fresh = adamw_init(model.init_params(torch.Generator().manual_seed(99)))
        step, flat = restore_checkpoint(store, "ckpts", backend=be)
        restored = unflatten_into(fresh, flat)
        assert step == 7
        assert int(restored.step) == 7
        for a, b in zip(serialize.leaves(restored.params),
                        serialize.leaves(state.params)):
            assert torch.equal(a, b)


# ------------------------------------------------------ across packages

def _states(compression):
    """The same TrainState in both packages: llama3-8b smoke's bf16
    params from the reference's init, f32 moments (and error feedback)
    from numpy, step 7."""
    cfg = ref_registry.get_smoke("llama3-8b")
    rparams = ref_get_model(cfg).init_params(jax.random.PRNGKey(5))
    rng = np.random.default_rng(12)
    rinit = ref_adamw_init(rparams, compression=compression)

    def noise(tree):
        return jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), tree)

    rstate = rinit.__class__(
        step=jnp.asarray(7, jnp.int32), params=rparams, mu=noise(rinit.mu),
        nu=noise(rinit.nu),
        err=noise(rinit.err) if compression else None)

    def port(tree):
        return (None if tree is None
                else params_from_numpy(jax.tree.map(np.asarray, tree)))

    pstate = TrainState(step=torch.tensor(7, dtype=torch.int32),
                        params=port(rstate.params), mu=port(rstate.mu),
                        nu=port(rstate.nu), err=port(rstate.err))
    return rstate, pstate


def _assert_states_equal(pstate, rstate):
    pleaves = [pstate.step] + [x for name in ("params", "mu", "nu", "err")
                               for x in serialize.leaves(
                                   getattr(pstate, name))]
    rleaves = jax.tree.leaves(rstate)
    assert len(pleaves) == len(rleaves)
    for a, b in zip(pleaves, rleaves):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[-1] == b.dtype.name
        assert tuple(a.shape) == b.shape
        if a.dtype == torch.bfloat16:
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("compression", [False, True],
                         ids=["no-err", "err"])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_checkpoint_bytes_equal_the_reference(compression, mode):
    """The same state written by both packages: the same object names, the
    same manifest bytes and the same shard bytes."""
    rstate, pstate = _states(compression)
    store, be = make_backend()
    rstore, rbe = make_ref_backend()
    if mode == "sync":
        save_checkpoint(store, "ck", 7, pstate)
        ref_save_checkpoint(rstore, "ck", 7, rstate)
    else:
        ck, rck = AsyncCheckpointer(be, "ck"), RefAsyncCheckpointer(rbe, "ck")
        ck.save(7, pstate)
        rck.save(7, rstate)
        ck.wait()
        rck.wait()
    got, want = store.list_bucket("ck"), rstore.list_bucket("ck")
    assert sorted(got) == sorted(want)
    assert got["step-00000007/MANIFEST"] == want["step-00000007/MANIFEST"]
    for name in want:
        assert got[name] == want[name], name
    keys = list(json.loads(got["step-00000007/MANIFEST"])["leaves"])
    assert keys[0] == "step" and keys[1] == "params/embed"
    assert any(k.startswith("err/") for k in keys) == compression


@pytest.mark.parametrize("compression", [False, True],
                         ids=["no-err", "err"])
def test_each_package_restores_the_others_checkpoint(compression):
    """Objects written by one package, copied into the other's store,
    restore (through the backend's prefetch) into an equal state."""
    rstate, pstate = _states(compression)
    # written by the reference, restored by the port
    rstore, rbe = make_ref_backend()
    rck = RefAsyncCheckpointer(rbe, "ck")
    rck.save(7, rstate)
    rck.wait()
    store, be = make_backend()
    for name, raw in rstore.list_bucket("ck").items():
        store.put("ck", name, raw)
    fresh = adamw_init(params_from_numpy(jax.tree.map(
        lambda x: np.zeros_like(np.asarray(x)), rstate.params)),
        compression=compression)
    step, flat = restore_checkpoint(store, "ck", backend=be)
    assert step == 7 and be.stats["prefetches"] == len(flat)
    _assert_states_equal(unflatten_into(fresh, flat), rstate)
    # written by the port, restored by the reference
    wstore, wbe = make_backend()
    ck = AsyncCheckpointer(wbe, "ck")
    ck.save(7, pstate)
    ck.wait()
    ref_store, ref_be = make_ref_backend()
    for name, raw in wstore.list_bucket("ck").items():
        ref_store.put("ck", name, raw)
    rfresh = ref_adamw_init(jax.tree.map(jnp.zeros_like, rstate.params),
                            compression=compression)
    rstep, rflat = ref_restore_checkpoint(ref_store, "ck", backend=ref_be)
    assert rstep == 7
    _assert_states_equal(pstate, ref_unflatten_into(rfresh, rflat))
