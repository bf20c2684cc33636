"""The port's serving path on the CPU, end to end, against the JAX
package: ``ModelRegistry(..., device="cpu")`` + ``ServingFrontend`` +
``ServeClient`` answer ragged and concurrent requests with the JAX model's
``predict`` on the same converted parameters (f32, within 1e-5); typed
error replies; and the wire works across the two packages in both
directions."""

import threading
import time

import jax
import numpy as np
import pytest

from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu.netps import wire as jax_wire
from distkeras_tpu.serving import ModelRegistry as JaxRegistry
from distkeras_tpu.serving import ServeClient as JaxClient
from distkeras_tpu.serving import ServingFrontend as JaxFrontend
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models import imdb_lstm
from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.errors import RPCTimeoutError
from distkeras_tpu_torch.serving import (
    BucketedModel,
    ModelRegistry,
    OverloadedError,
    ServeClient,
    ServingError,
    ServingFrontend,
)

SMALL = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
BUCKETS = (1, 4, 16)
FAST = dict(timeout=5.0, retries=3, backoff=0.01)


@pytest.fixture(scope="module")
def jax_model():
    return jax_imdb_lstm(**SMALL, cell_impl="pallas")


def port_model(jm):
    pm = imdb_lstm(**SMALL, device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return pm


def tokens(rows, seed):
    return np.random.default_rng(seed).integers(0, 50, (rows, 6)).astype(
        np.int32)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture
def served(jax_model):
    registry = ModelRegistry(port_model(jax_model), BUCKETS, device="cpu")
    frontend = ServingFrontend(registry, max_wait_s=0.005).start()
    try:
        yield registry, frontend
    finally:
        frontend.close()
        registry.close()


def test_ragged_requests_match_jax_predict(served, jax_model):
    _registry, frontend = served
    client = ServeClient(frontend.endpoint, **FAST)
    for k, rows in enumerate((1, 3, 7)):
        x = tokens(rows, k)
        out, version = client.infer(x)
        assert version == -1
        np.testing.assert_allclose(out, np.asarray(jax_model.predict(x)),
                                   rtol=1e-5, atol=1e-5)
    stats = client.stats()
    client.close()
    assert stats["served"] == 3 and stats["compiles"] == len(BUCKETS)
    assert stats["caps"] == {"codecs": ["none", "bf16", "int8"],
                             "striping": True, "replication": True,
                             "serving": True, "sharding": True,
                             "shm": True, "mesh": True, "tree": True,
                             "tuner": True, "tracing": True}
    assert stats["ring"] == [] and stats["ready"] is True
    counters = telemetry.get().snapshot()["counters"]
    assert counters.get("serving.retrace_after_warmup", 0) == 0
    assert counters["serving.answered"] == 3


def test_concurrent_clients_coalesce(served, jax_model):
    _registry, frontend = served
    results = {}

    def one(k):
        c = ServeClient(frontend.endpoint, **FAST)
        results[k] = c.infer(tokens(2, 100 + k))[0]
        c.close()

    threads = [threading.Thread(target=one, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for k in range(4):
        np.testing.assert_allclose(
            results[k], np.asarray(jax_model.predict(tokens(2, 100 + k))),
            rtol=1e-5, atol=1e-5)
    counters = telemetry.get().snapshot()["counters"]
    assert counters["serving.answered"] == 4
    assert counters["serving.batches"] <= 4
    assert counters.get("serving.retrace_after_warmup", 0) == 0


def test_overload_is_a_typed_reply(jax_model):
    registry = ModelRegistry(port_model(jax_model), (1, 4), device="cpu")
    frontend = ServingFrontend(registry, max_wait_s=5.0,
                               max_queue_rows=1).start()
    blocker = ServeClient(frontend.endpoint, **FAST)

    def _block():
        # Parked in the never-dispatched queue; teardown answers it with a
        # typed error or drops its connection — not this test's assertion.
        try:
            blocker.infer(tokens(1, 0))
        except (ServingError, RPCTimeoutError):
            pass

    t = threading.Thread(target=_block)
    t.start()
    try:
        deadline = time.monotonic() + 5.0
        while frontend.batcher.depth_rows() < 1:
            assert time.monotonic() < deadline
            time.sleep(0.002)
        client = ServeClient(frontend.endpoint, **FAST)
        with pytest.raises(OverloadedError):
            client.infer(tokens(4, 1))
        client.close()
    finally:
        frontend.close()
        registry.close()
        t.join(timeout=30)
        blocker.close()
    assert telemetry.get().snapshot()["counters"]["serving.shed"] == 1


def test_unknown_op_empty_infer_and_failed_forward_are_typed(served):
    _registry, frontend = served
    client = ServeClient(frontend.endpoint, **FAST)
    with pytest.raises(ServingError, match="unknown serving op"):
        client._rpc({"op": "bogus"}, [])
    with pytest.raises(ServingError, match="no input arrays"):
        client._rpc({"op": "infer"}, [])
    # Float tokens make the embedding raise inside the dispatch loop: the
    # request is answered with a typed error, never dropped.
    with pytest.raises(ServingError, match="dispatch failed"):
        client.infer(np.zeros((2, 6), np.float32))
    client.close()


def test_unseen_shape_after_warmup_is_counted(jax_model):
    bm = BucketedModel(port_model(jax_model), (1, 4))
    assert bm.warmup() == 2
    bm.infer([tokens(3, 0)])  # pads to 4: a warmed shape
    assert telemetry.get().snapshot()["counters"].get(
        "serving.retrace_after_warmup", 0) == 0
    bm._forward((tokens(3, 0),))  # bypasses the padding: unseen shape
    assert telemetry.get().snapshot()["counters"][
        "serving.retrace_after_warmup"] == 1
    assert bm.compiles() == 3


def test_client_walks_to_the_next_replica(jax_model):
    registry = ModelRegistry(port_model(jax_model), BUCKETS, device="cpu")
    a = ServingFrontend(registry, max_wait_s=0.002).start()
    b = ServingFrontend(registry, max_wait_s=0.002).start()
    try:
        client = ServeClient(f"{a.endpoint},{b.endpoint}", **FAST)
        x = tokens(2, 5)
        want = np.asarray(jax_model.predict(x))
        np.testing.assert_allclose(client.infer(x)[0], want,
                                   rtol=1e-5, atol=1e-5)
        a.kill()
        np.testing.assert_allclose(client.infer(x)[0], want,
                                   rtol=1e-5, atol=1e-5)
        assert client.endpoints[client._walker.index % 2] == \
            client.endpoints[1]
        counters = telemetry.get().snapshot()["counters"]
        assert counters["serving.client_failovers"] >= 1
        client.close()
        # A dead replica sinks behind the live one in the walk order.
        order = ServeClient(f"{a.endpoint},{b.endpoint}",
                            **FAST).prefer_ready()
        assert order == [wire.split_endpoint(b.endpoint),
                         wire.split_endpoint(a.endpoint)]
    finally:
        a.close()
        b.close()
        registry.close()


# ---------------------------------------------------------------------------
# The wire across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_frames_are_byte_identical(codec):
    a = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    b = np.arange(6, dtype=np.int32).reshape(2, 3)
    arrays = [wire.codec_encode(a, codec), b]
    header = {"op": "infer", "req": 7, "version": -1}
    ours = wire.encode_frame(wire.KIND_REQUEST, header, arrays)
    theirs = jax_wire.encode_frame(jax_wire.KIND_REQUEST, header,
                                   [jax_wire.codec_encode(a, codec), b])
    assert ours == theirs
    kind, hdr, out = jax_wire.decode_frame(ours)
    kind2, hdr2, out2 = wire.decode_frame(theirs)
    assert kind == kind2 == wire.KIND_REQUEST and hdr == hdr2
    for x, y in zip(out, out2):
        np.testing.assert_array_equal(x, y)


def test_port_client_reads_jax_frontend(jax_model):
    registry = JaxRegistry(jax_model, BUCKETS)
    frontend = JaxFrontend(registry, max_wait_s=0.005).start()
    try:
        client = ServeClient(frontend.endpoint, **FAST)
        x = tokens(3, 7)
        out, version = client.infer(x)
        assert version == -1
        np.testing.assert_allclose(out, np.asarray(jax_model.predict(x)),
                                   rtol=1e-6, atol=1e-6)
        assert client.stats()["caps"]["serving"] is True
        client.close()
    finally:
        frontend.close()
        registry.close()


def test_jax_client_reads_port_frontend(served, jax_model):
    _registry, frontend = served
    client = JaxClient(frontend.endpoint, **FAST)
    for k, rows in enumerate((1, 5)):
        x = tokens(rows, 20 + k)
        out, version = client.infer(x)
        assert version == -1
        np.testing.assert_allclose(out, np.asarray(jax_model.predict(x)),
                                   rtol=1e-5, atol=1e-5)
    assert client.stats(ring=4)["ring"] == []
    client.close()
