"""The port's replica sets and the serving fleet tenant
(``distkeras_tpu_torch/serving/replica.py``) on the CPU, against the JAX
package's (``distkeras_tpu/serving/replica.py``): a client walks the
endpoint list to a survivor when a replica is killed; the service runs as
a fleet tenant the scheduler shrinks to its floor but never drains; the
served logits equal the JAX package's replica set's on the same converted
parameters within rtol = atol = 1e-5 (f32, ``tests/test_torch_serving.py``'s
limit)."""

import threading
import time

import jax
import numpy as np
import pytest

from distkeras_tpu.fleet import FleetJob as JaxFleetJob
from distkeras_tpu.fleet import FleetScheduler as JaxFleetScheduler
from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu.serving import ServeClient as JaxClient
from distkeras_tpu.serving.replica import ServingReplicaSet as JaxReplicaSet
from distkeras_tpu.serving.replica import ServingService as JaxService
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.fleet import FleetJob, FleetScheduler
from distkeras_tpu_torch.models import imdb_lstm
from distkeras_tpu_torch.serving import (
    ServeClient,
    ServingReplicaSet,
    ServingService,
)
from distkeras_tpu_torch.telemetry.health import registered_targets

SMALL = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
BUCKETS = (1, 4, 16)
FAST = dict(timeout=5.0, retries=3, backoff=0.01)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jm = jax_imdb_lstm(**SMALL, cell_impl="pallas", seed=2)
    pm = imdb_lstm(**SMALL, device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    return jm, pm


def _rows(n, seed=0):
    return np.random.default_rng(seed).integers(0, 50, (n, 6)).astype(
        np.int32)


@pytest.mark.parametrize("kill", [0, 1])
def test_client_walks_to_a_survivor_when_a_replica_dies(models, kill):
    jm, pm = models
    rs = ServingReplicaSet(pm, n=2, buckets=BUCKETS, device="cpu").start()
    try:
        eps = rs.endpoints()
        assert len(eps.split(",")) == 2
        assert {t: e for t, e in registered_targets().items()
                if t in ("serve0", "serve1")} == {
            "serve0": rs.replicas[0].endpoint,
            "serve1": rs.replicas[1].endpoint}
        client = ServeClient(eps, **FAST)
        x = _rows(3)
        np.testing.assert_allclose(client.infer(x)[0],
                                   np.asarray(jm.predict(x)), **TOL)
        rs.kill(kill)
        assert rs.replicas[kill] is None
        assert len(rs.endpoints().split(",")) == 1
        for n in (1, 5, 16):
            x = _rows(n, seed=n)
            np.testing.assert_allclose(client.infer(x)[0],
                                       np.asarray(jm.predict(x)), **TOL)
        front = rs.start_replica(kill)  # a supervisor's restart
        assert rs.start_replica(kill) is front  # idempotent
        assert registered_targets()[f"serve{kill}"] == front.endpoint
        assert rs.served() >= 3
        client.close()
    finally:
        rs.close()
    assert rs.endpoints() == ""
    assert "serve0" not in registered_targets()


def test_served_outputs_equal_the_jax_replica_set(models):
    jm, pm = models
    ours = ServingReplicaSet(pm, n=2, buckets=BUCKETS, device="cpu").start()
    theirs = JaxReplicaSet(jm, n=2, buckets=BUCKETS).start()
    try:
        a = ServeClient(ours.endpoints(), **FAST)
        b = JaxClient(theirs.endpoints(), **FAST)
        for n in (1, 3, 4, 11, 16):
            x = _rows(n, seed=10 + n)
            got, ref = a.infer(x)[0], b.infer(x)[0]
            assert got.shape == ref.shape == (n, 2)
            np.testing.assert_allclose(got, ref, **TOL)
        a.close()
        b.close()
    finally:
        ours.close()
        theirs.close()


def test_stop_replica_drains_and_unfiles(models):
    _jm, pm = models
    rs = ServingReplicaSet(pm, n=2, buckets=BUCKETS, device="cpu").start()
    try:
        ep1 = rs.replicas[1].endpoint
        rs.stop_replica(0)
        assert rs.endpoints() == ep1
        assert "serve0" not in registered_targets()
        out, _v = ServeClient(rs.endpoints(), **FAST).infer(_rows(2))
        assert out.shape == (2, 2)
    finally:
        rs.close()


class JaxServiceShim(JaxService):
    """The JAX package's service with its resize hook out of the
    scheduler's way: the reference names it ``worker_slots``, which its
    own ``FleetScheduler.submit`` reads as the runtime's integer slot
    bound (``int(method)``: a TypeError; see
    ``test_reference_service_is_refused_by_its_own_scheduler``)."""

    worker_slots = None

    def worker_main(self, worker_id, should_run):
        JaxService.worker_slots(self, worker_id + 1)
        self.replica_set.start_replica(worker_id)
        try:
            while should_run() and not self._closed:
                time.sleep(0.02)
        finally:
            self.replica_set.stop_replica(worker_id)


def test_reference_service_is_refused_by_its_own_scheduler(models):
    """Where the port departs from the reference: the JAX package's
    ``ServingService`` cannot be submitted to its ``FleetScheduler``; the
    port's can (its hook is ``grow_slots``)."""
    jm, pm = models
    with pytest.raises(TypeError, match="method"):
        JaxFleetScheduler(capacity=2).submit(JaxFleetJob(
            "s", "web", JaxService(jm, buckets=BUCKETS), kind="serving"))
    svc = ServingService(pm, buckets=BUCKETS, device="cpu")
    sched = FleetScheduler(capacity=2)
    job = sched.submit(FleetJob("s", "web", svc, kind="serving"))
    assert job.state == "queued" and not hasattr(svc, "worker_slots")
    sched.close()


def _tenant_run(pkg, model, x):
    """One package's scheduler with the serving tenant (floor 1, up to 2
    replicas) beside a training stand-in; a priority-5 gang of 3 arrives
    and must take the serving job to its floor, never below. A client
    walks the live endpoints for the whole run."""
    if pkg == "port":
        sched_cls, job_cls = FleetScheduler, FleetJob
        svc = ServingService(model, buckets=BUCKETS, device="cpu")
        client_cls = ServeClient
    else:
        sched_cls, job_cls = JaxFleetScheduler, JaxFleetJob
        svc = JaxServiceShim(model, buckets=BUCKETS)
        client_cls = JaxClient

    class Work:
        def __init__(self, total):
            self.total, self.n = total, 0
            self.lock = threading.Lock()

        def ensure_started(self):
            pass

        def worker_main(self, wid, should_run):
            while should_run():
                with self.lock:
                    if self.n >= self.total:
                        return
                    self.n += 1
                time.sleep(0.004)

        def progress(self):
            return self.n

        def done(self):
            return self.n >= self.total

        def revoke(self, wid):
            pass

        def close(self):
            pass

    sched = sched_cls(capacity=3, tick_s=0.01)
    serve = sched.submit(job_cls("serve", "web", svc, min_gang=1,
                                 max_workers=2, kind="serving"))
    train = sched.submit(job_cls("train", "lo", Work(200), min_gang=1,
                                 max_workers=1))
    outs, errors, floor = [], [], []
    stop = threading.Event()

    def client_loop():
        while not stop.is_set():
            eps = svc.endpoints()
            if not eps:
                time.sleep(0.01)
                continue
            c = client_cls(eps, **FAST)
            try:
                outs.append(c.infer(x)[0])
            except Exception as e:  # noqa: BLE001 - counted below
                errors.append(e)
            finally:
                c.close()

    sched.start()
    t = threading.Thread(target=client_loop)
    try:
        deadline = time.monotonic() + 60
        while sched.stats()["web/serve"]["active"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        t.start()
        hot = sched.submit(job_cls("hot", "hi", Work(60), priority=5,
                                   min_gang=2, max_workers=2))
        while hot.state != "done" or train.state != "done":
            assert time.monotonic() < deadline, sched.stats()
            floor.append(sched.stats()["web/serve"]["active"])
            time.sleep(0.005)
        assert serve.state == "running"  # never drained
    finally:
        stop.set()
        if t.is_alive() or t.ident is not None:
            t.join()
        sched.close()
    return serve, floor, outs, errors


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_service_is_a_fleet_tenant_never_drained_below_its_floor(models,
                                                                 pkg):
    jm, pm = models
    telemetry.reset()
    x = _rows(4, seed=7)
    serve, floor, outs, errors = _tenant_run(
        pkg, pm if pkg == "port" else jm, x)
    assert serve.shrinks >= 1  # the arrival took a replica
    assert min(floor) >= 1  # ... and never the last one
    assert serve.expands >= 1  # re-expanded once capacity freed
    assert outs, "the serving tenant answered nothing"
    want = np.asarray(jm.predict(x))
    for o in outs:
        np.testing.assert_allclose(o, want, **TOL)
    if pkg == "port":
        snap = telemetry.get().snapshot()["counters"]
        assert snap.get("fleet.preemptions.web.serve", 0) >= 1
        assert serve.runtime.progress() >= len(outs)


def test_serving_drain_is_refused_and_counted(models):
    """A gang that needs the serving tenant's last replica: the scheduler
    refuses the drain (``fleet.serving_drains_refused``) and the head
    waits; the service keeps answering."""
    _jm, pm = models
    telemetry.reset()
    svc = ServingService(pm, buckets=BUCKETS, device="cpu")
    sched = FleetScheduler(capacity=2, tick_s=0.01)
    serve = sched.submit(FleetJob("serve", "web", svc, min_gang=1,
                                  max_workers=1, kind="serving"))
    try:
        for _ in range(200):
            sched.tick()
            if svc.endpoints():
                break
            time.sleep(0.01)
        hog = sched.submit(FleetJob("hog", "hi", ServingService(
            pm, buckets=BUCKETS, device="cpu"), priority=9, min_gang=2,
            max_workers=2, kind="serving"))
        for _ in range(5):
            sched.tick()
            time.sleep(0.01)
        assert hog.state == "queued" and serve.state == "running"
        assert telemetry.get().counter(
            "fleet.serving_drains_refused").value >= 1
        out, _v = ServeClient(svc.endpoints(), **FAST).infer(_rows(2))
        assert out.shape == (2, 2)
    finally:
        sched.close()
    assert svc.done() and svc.endpoints() == ""
