"""The port's network chaos (``DKTPU_NET_FAULTS``) on the CPU, against the
JAX package: the port's ``ChaosProxy`` in front of the port's server for
every wire kind (the same schedule through the JAX proxy and server gives
the same commit log and center), the JAX client through the port's proxy,
the server's own ``ps_hang``/``ps_crash`` in a child CLI server (whose
fired-fault journal keeps the restarted life from crashing again), the
ring's ``shm_delay``/``shm_corrupt``, the mesh dispatch's ``mesh_down``
and the serving frontend's ``serve_slow``/``serve_drop``. Every scheduled
fault must fire, and every commit fold exactly once."""

import os
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu.netps import ChaosProxy as JaxChaosProxy
from distkeras_tpu.netps import PSClient as JaxPSClient
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from distkeras_tpu_torch import resilience, telemetry
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models import imdb_lstm
from distkeras_tpu_torch.netps import ChaosProxy, NetPSError, PSClient, \
    PSServer
from distkeras_tpu_torch.netps import shm
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.resilience.faults import FaultPlan
from distkeras_tpu_torch.serving import ModelRegistry, ServeClient, \
    ServingFrontend
from distkeras_tpu_torch.serving import frontend as frontend_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = dict(timeout=0.3, retries=10, backoff=0.05)


@pytest.fixture(autouse=True)
def _fault_hygiene(monkeypatch):
    for var in ("DKTPU_FAULTS", "DKTPU_NET_FAULTS", "DKTPU_FAULTS_STATE"):
        monkeypatch.delenv(var, raising=False)
    resilience.reset()
    telemetry.reset()
    yield
    resilience.reset()
    telemetry.reset()


def _fired(plan) -> set:
    return set(plan._fired)


def _delta(i: int):
    return [np.full(3, float(i + 1), np.float32),
            np.arange(4, dtype=np.float32) * (i + 1)]


def _drive(client, n=3):
    """Join, then ``n`` commit + pull pairs; returns the last pull."""
    _, upd = client.join(init=[np.zeros(3, np.float32),
                               np.zeros(4, np.float32)])
    for i in range(n):
        client.commit(_delta(i), upd)
        center, upd = client.pull()
    return center


#: one wire kind a case, each on a frame of the commit/pull stream
#: (frame 0 is the join, then commit, pull, commit, pull, ...).
WIRE_SPECS = ["drop@1", "dup@1", "truncate@1", "delay@1:0.05",
              "partition@3:0.3", "drop_r@1", "dup_r@2", "truncate_r@1",
              "delay_r@3:0.05"]


@pytest.mark.parametrize("spec", WIRE_SPECS)
def test_proxy_kind_folds_exactly_once_as_the_jax_proxy(spec):
    """Each wire kind through the port's proxy in front of the port's
    server: it fires, every commit folds once, and the commit log and
    center equal the JAX proxy's in front of the JAX server under the same
    schedule."""
    out = {}
    for name, srv_cls, px_cls, cl_cls, plan_cls, kw in (
            ("port", PSServer, ChaosProxy, PSClient, FaultPlan,
             {"device": "cpu"}),
            ("jax", JaxPSServer, JaxChaosProxy, JaxPSClient, JaxFaultPlan,
             {})):
        srv = srv_cls(discipline="downpour", **kw).start()
        plan = plan_cls.parse_net(spec)
        px = px_cls(srv.endpoint, plan=plan).start()
        c = cl_cls(px.endpoint, worker_id=0, **FAST)
        try:
            center = _drive(c)
            out[name] = (list(srv.commit_log), srv.center(), center)
            assert _fired(plan) == set(plan.faults), (name, plan._fired)
        finally:
            c.close()
            px.close()
            srv.close()
    log, srv_center, pulled = out["port"]
    assert log == [(0, s, 0) for s in range(3)], log
    assert log == out["jax"][0]
    for a, b, c in zip(srv_center, out["jax"][1], pulled):
        assert a.tobytes() == b.tobytes() == c.tobytes()


def test_jax_client_through_the_port_proxy():
    srv = PSServer(discipline="downpour", device="cpu").start()
    plan = FaultPlan.parse_net("drop_r@1;dup@2;truncate@3")
    px = ChaosProxy(srv.endpoint, plan=plan).start()
    c = JaxPSClient(px.endpoint, worker_id=0, **FAST)
    try:
        _drive(c)
        assert _fired(plan) == set(plan.faults)
        assert srv.commit_log == [(0, s, 0) for s in range(3)]
        np.testing.assert_array_equal(srv.center()[0], np.full(3, 6.0))
    finally:
        c.close()
        px.close()
        srv.close()


def test_ambient_net_plan_drives_the_proxy(monkeypatch):
    monkeypatch.setenv("DKTPU_NET_FAULTS", "drop_r@1")
    srv = PSServer(discipline="downpour", device="cpu").start()
    px = ChaosProxy(srv.endpoint).start()
    c = PSClient(px.endpoint, worker_id=0, **FAST)
    try:
        _drive(c, n=1)
        assert px.plan is faults.active_net_plan()
        assert _fired(px.plan) == {("drop_r", 1)}
        assert srv.commit_log == [(0, 0, 0)]
        assert telemetry.get().counter(
            "resilience.faults_injected").value == 1
    finally:
        c.close()
        px.close()
        srv.close()


# ---------------------------------------------------------------------------
# The server's own kinds, in a child process
# ---------------------------------------------------------------------------

def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _cli(port, state_dir, env_extra):
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    return subprocess.Popen(
        [sys.executable, "-m", "distkeras_tpu_torch.netps", "--host",
         "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--discipline", "downpour", "--state-dir", state_dir],
        stdout=subprocess.PIPE, env=env, text=True, cwd=REPO)


def test_ps_hang_and_ps_crash_in_a_child_server(tmp_path):
    """``ps_hang@1:0.4`` wedges commit 1 while holding the center lock;
    ``ps_crash@3`` SIGKILLs the server before it folds commit 3. The
    server restarted on the same directory and fault journal recovers the
    three folds and does not crash again at commit 3."""
    state = str(tmp_path / "fired")
    env = {"DKTPU_NET_FAULTS": "ps_hang@1:0.4;ps_crash@3",
           "DKTPU_FAULTS_STATE": state}
    port = _free_port()
    d = str(tmp_path / "ps")
    proc = _cli(port, d, env)
    try:
        ready = proc.stdout.readline()
        assert ready.startswith("NETPS_READY "), ready
        ep = ready.split()[1]
        c = PSClient(ep, worker_id=0, timeout=5.0, retries=0, backoff=0.01)
        try:
            _, upd = c.join(init=[np.zeros(3, np.float32)])
            c.commit([np.ones(3, np.float32)], upd)
            t0 = time.monotonic()
            c.commit([np.ones(3, np.float32)], upd)
            assert time.monotonic() - t0 >= 0.4, "ps_hang did not wedge"
            c.commit([np.ones(3, np.float32)], upd)
            time.sleep(0.3)  # the journal writer drains the acked folds
            with pytest.raises(NetPSError):
                c.commit([np.ones(3, np.float32)], upd)
        finally:
            c.close()
        assert proc.wait(timeout=10) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    with open(state) as f:
        assert sorted(f.read().split()) == ["ps_crash@3", "ps_hang@1"]
    proc = _cli(port, d, env)
    try:
        ready = proc.stdout.readline()
        assert ready.startswith("NETPS_READY "), ready
        with PSClient(ready.split()[1], worker_id=0, timeout=5.0,
                      retries=2, backoff=0.01) as c:
            center, upd = c.join()
            assert upd == 3
            np.testing.assert_array_equal(center[0], np.full(3, 3.0))
            assert c.commit([np.ones(3, np.float32)], upd).applied
            center, upd = c.pull()
            assert upd == 4 and proc.poll() is None
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# ---------------------------------------------------------------------------
# The ring and the mesh dispatch inject their own faults
# ---------------------------------------------------------------------------

def _shm_pair(**kw):
    srv = PSServer(discipline="adag", device="cpu", transport="shm").start()
    return srv, PSClient(srv.endpoint, worker_id=0, transport="shm",
                         **dict(dict(timeout=1.0, retries=5, backoff=0.01),
                                **kw))


@pytest.mark.parametrize("spec", ["shm_corrupt@0", "shm_delay@0:0.2"])
def test_ring_faults_fold_exactly_once(spec):
    """``shm_corrupt``: the server rejects the frame whose slot crc was
    flipped and drops the connection; the client reattaches with fresh
    segments and retransmits the same seq. ``shm_delay`` holds the frame.
    One fold either way, still on the ring."""
    srv, c = _shm_pair(timeout=0.5)
    try:
        _, upd = c.join(init=[np.zeros(3, np.float32)])
        shm.reset_frames()
        plan = FaultPlan.parse_net(spec)
        faults.set_net_plan(plan)
        t0 = time.monotonic()
        res = c.commit([np.ones(3, np.float32)], upd)
        assert res.applied or res.duplicate
        if "delay" in spec:
            assert time.monotonic() - t0 >= 0.2
        assert _fired(plan) == set(plan.faults)
        assert srv.commit_log == [(0, 0, 0)], srv.commit_log
        np.testing.assert_allclose(srv.center()[0], 1.0)
        assert c.active_transport == "shm"
    finally:
        faults.set_net_plan(None)
        c.close()
        srv.close()


def test_mesh_down_demotes_once_and_folds_exactly_once():
    """``mesh_down@4``: commit seq 4's dispatch raises as a lost device
    would; the client demotes to the ring and retransmits the same seq.
    Every commit folds once and the center equals a TCP run's."""
    n = 8

    def run(transport, plan=None):
        srv = PSServer(discipline="adag", device="cpu",
                       transport="mesh" if transport == "mesh" else "tcp"
                       ).start()
        faults.set_net_plan(plan)
        rng = np.random.default_rng(1)
        c = PSClient(srv.endpoint, worker_id=0, transport=transport,
                     timeout=1.0, retries=3, backoff=0.01)
        try:
            center, upd = c.join(init=[np.zeros((4, 3), np.float32)])
            for _ in range(n):
                c.commit([rng.normal(size=(4, 3)).astype(np.float32)], upd)
                center, upd = c.pull()
            return srv, c.active_transport, list(srv.commit_log), \
                srv.center()
        finally:
            faults.set_net_plan(None)
            c.close()
            srv.close()

    _, _, ref_log, ref = run("tcp")
    telemetry.reset()
    plan = FaultPlan.parse_net("mesh_down@4")
    _srv, active, log, center = run("mesh", plan)
    assert _fired(plan) == {("mesh_down", 4)}
    assert active == "shm"
    assert log == ref_log and [s for _w, s, _t in log] == list(range(n))
    assert center[0].tobytes() == ref[0].tobytes()
    reg = telemetry.get()
    assert reg.counter("netps.mesh.demotions").value == 1
    assert reg.counter("netps.mesh.folds").value == 4


# ---------------------------------------------------------------------------
# The serving frontend
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)


def test_serve_slow_and_serve_drop():
    """``serve_slow@1:0.3`` holds request 1's reply; ``serve_drop@2``
    closes request 2's connection before admission, and the client's
    retry gets the answer (as request 3). Every answer equals the model's
    own forward."""
    jm = jax_imdb_lstm(**SMALL)
    pm = imdb_lstm(**SMALL, device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), pm.module))
    registry = ModelRegistry(pm, (1, 4), device="cpu")
    fe = ServingFrontend(registry, max_wait_s=0.002).start()
    frontend_mod.reset_request_index()
    plan = FaultPlan.parse_net("serve_slow@1:0.3;serve_drop@2")
    faults.set_net_plan(plan)
    client = ServeClient(fe.endpoint, timeout=5.0, retries=3, backoff=0.01)
    try:
        rng = np.random.default_rng(0)
        times = []
        for _ in range(4):
            x = rng.integers(0, 50, (3, 6)).astype(np.int32)
            t0 = time.monotonic()
            out, _v = client.infer(x)
            times.append(time.monotonic() - t0)
            want = pm.predict(x).numpy()
            np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
        assert times[1] >= 0.3, times
        assert _fired(plan) == set(plan.faults)
        assert telemetry.get().counter(
            "serving.client_failovers").value == 1
        assert fe.served == 4
    finally:
        faults.set_net_plan(None)
        client.close()
        fe.close()
        registry.close()
