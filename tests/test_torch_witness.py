"""The port's runtime lock-order witness (``distkeras_tpu_torch.analysis.
witness``) and static lock graph (``rules_concurrency.build_lock_graph``),
as ``tests/test_analysis.py`` and ``tests/test_netps.py`` hold the JAX
package's: the witness's own cases, the fixture's witnessed edges within
its static graph, the port package's graph acyclic with a live telemetry
burst's edges within it, and the port's parameter server (centers on the
CPU) under the witness: drain racing eviction, and four clients racing
five commits each."""

import pathlib
import threading
import time

import numpy as np
import pytest

from distkeras_tpu_torch.analysis import core, witness
from distkeras_tpu_torch.analysis.rules_concurrency import (
    _find_cycles, build_lock_graph)
from distkeras_tpu_torch.netps import PSClient, PSServer, ServerDrainingError

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "distkeras_tpu_torch"
FIXTURES = ROOT / "tests" / "fixtures" / "analysis"
FAST = dict(timeout=1.0, retries=3, backoff=0.01)


@pytest.fixture(scope="module")
def static_edges():
    modules, errs = core.parse_modules([str(PKG)])
    assert not errs
    edges, _, _ = build_lock_graph(modules)
    return edges


def make_server(**kw):
    kw.setdefault("discipline", "adag")
    kw.setdefault("device", "cpu")
    return PSServer(**kw).start()


def test_witness_detects_inversion():
    with witness() as w:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
    assert w.edges()
    with pytest.raises(AssertionError, match="inversion"):
        w.assert_no_inversions()


def test_witness_clean_order_passes():
    with witness() as w:
        a = threading.Lock()
        b = threading.Lock()
        for _ in range(3):
            with a:
                with b:
                    pass
    w.assert_no_inversions()
    assert len(w.edges()) == 1


def test_witness_ignores_preexisting_locks():
    before = threading.Lock()
    with witness() as w:
        with before:
            pass
    assert w.edges() == set()


def test_static_graph_matches_witnessed_order():
    """The port's DK201 graph and witness agree on the fixture: every
    observed edge is in the static graph, and the planted inversion is
    visible to both."""
    path = str(FIXTURES / "concurrency_violations.py")
    modules, errs = core.parse_modules([path])
    assert not errs
    edges, _, _ = build_lock_graph(modules)
    with open(path) as f:
        src = f.read()
    ns = {}
    with witness() as w:
        exec(compile(src, path, "exec"), ns)
        ns["forward"]()
        ns["backward"]()
        pool = ns["Pool"]()
        pool.take()
        pool.drain()
    observed = {e for e in w.edges()
                if e[0].startswith("concurrency_violations.")}
    assert observed, "witness saw no fixture lock nesting"
    assert observed <= edges, observed - edges
    assert w.cycles(), "planted inversion must be dynamically visible"


def test_package_lock_graph_is_acyclic_and_witnessed_subset(static_edges):
    """No DK201 cycle in the port, and a live telemetry burst under the
    witness observes no inversion and no edge the static graph lacks."""
    assert _find_cycles(static_edges) == []
    from distkeras_tpu_torch.telemetry.core import Telemetry

    with witness() as w:
        tele = Telemetry(enabled=True)

        def worker():
            for i in range(50):
                tele.counter("c").add(1)
                tele.gauge("g").set(i)
                with tele.span("s"):
                    tele.histogram("h").observe(0.001)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        tele.snapshot()
    w.assert_no_inversions()
    observed = {e for e in w.edges()
                if e[0].split(".")[0] == "core" or e[1].split(".")[0] == "core"}
    assert observed <= static_edges, observed - static_edges


def test_drain_vs_eviction_race_no_resurrection_no_deadlock():
    """Lease expiry firing while ``drain()`` is mid-flight must not
    resurrect an evicted worker or deadlock the monitor thread; the drain
    flag and the eviction sweep share one lock, witnessed live. (The
    port's client has no ``auto_rejoin`` switch: the sleeper never
    commits, so it never rejoins.)"""
    with witness() as w:
        srv = make_server(lease_s=0.15)
        keeper = sleeper = None
        try:
            keeper = PSClient(srv.endpoint, worker_id=0, **FAST)
            sleeper = PSClient(srv.endpoint, worker_id=1, **FAST)
            _, upd = keeper.join(init=[np.zeros(4, np.float32)])
            sleeper.join()
            stop = threading.Event()

            def drainer():
                while not stop.is_set():
                    srv.drain()
                    time.sleep(0.01)

            t = threading.Thread(target=drainer)
            t.start()
            deadline = time.monotonic() + 5.0
            while 1 in srv.members() and time.monotonic() < deadline:
                time.sleep(0.02)
            stop.set()
            t.join()
            assert 1 not in srv.members(), "eviction lost to the drain race"
            assert srv.evictions >= 1
            with pytest.raises(ServerDrainingError):
                sleeper.join()
            assert 1 not in srv.members()
            with pytest.raises(ServerDrainingError):
                keeper.commit([np.ones(4, np.float32)], upd)
            closer = threading.Thread(target=srv.close)
            closer.start()
            closer.join(timeout=10.0)
            assert not closer.is_alive(), (
                "close() deadlocked against the monitor thread")
        finally:
            for c in (keeper, sleeper):
                if c is not None:
                    c.close()
            srv.close()
    w.assert_no_inversions()


def test_server_handler_threads_under_lock_witness(static_edges):
    """The witness over the port server's per-connection handler threads
    and lease monitor: 4 clients x 5 commits fold 20 times, no inversion,
    and every witnessed ``server.PSServer`` edge is in the port's static
    graph."""
    with witness() as w:
        srv = make_server(lease_s=5.0)
        errors = []

        def worker(wid):
            try:
                c = PSClient(srv.endpoint, worker_id=wid, **FAST)
                _, upd = c.join(init=[np.zeros(8, np.float32)])
                for _ in range(5):
                    _center, upd = c.pull()
                    c.commit([np.ones(8, np.float32)], upd)
                c.leave()
                c.close()
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        srv.close()
    assert not errors, errors
    assert len(srv.commit_log) == 20
    w.assert_no_inversions()
    netps_edges = {e for e in w.edges()
                   if "server.PSServer" in e[0] or "server.PSServer" in e[1]}
    assert netps_edges <= static_edges, netps_edges - static_edges
