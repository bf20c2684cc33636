"""The port's self-tuning data plane (``distkeras_tpu_torch/netps/tuner/``,
the ``probe`` op, ``PSClient.probe``/``retune``, ``DKTPU_NET_AUTOTUNE`` in
``run_remote`` and a tree uplink's codec sweep) held to the JAX package's
``tests/test_netps_tuner.py``, case by case, and across the wire: a JAX
client against a port server and the reverse. Every port server here folds
on the CPU (``device="cpu"``), so the probe's decode runs the fold's plain
twin into the scratch window.

Which codec wins a sweep depends on the clock, so no test compares winners
across packages: the sweeps are held by their structure (one result a
codec, in ``wire.CODECS`` order, equal payload bytes). The controllers are
compared by feeding both the same proposals and the same gauge readings.
Tolerances: decodes and centers bit for bit (``tobytes``); the trained
runs with the tuner aboard fold in an order the clock decides, so their
centers are held to the JAX package's replay of the port server's own
journal, bit for bit, as the overlapped loop's are in
``tests/test_torch_remote.py``."""

import socket
import threading
import time

import numpy as np
import pytest

from distkeras_tpu import telemetry as jax_telemetry
from distkeras_tpu.netps import PSClient as JaxPSClient
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu.netps import state as jax_state
from distkeras_tpu.netps import tree as jax_tree
from distkeras_tpu.netps import tuner as jax_tuner
from distkeras_tpu.netps import wire as jax_wire
from distkeras_tpu.netps.fold import decode_entry as jax_decode_entry
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import PSClient, PSServer
from distkeras_tpu_torch.netps import state as netps_state
from distkeras_tpu_torch.netps import tree, tuner, wire
from distkeras_tpu_torch.netps.fold import decode_entry
from distkeras_tpu_torch.ops.kernels import fold as F
from distkeras_tpu_torch.runtime import config

FAST = dict(timeout=1.0, retries=3, backoff=0.01)

#: each package's pieces, so one script runs against either.
PKGS = {
    "port": dict(server=lambda **kw: PSServer(device="cpu", **kw),
                 client=PSClient, tuner=tuner, wire=wire,
                 telemetry=telemetry, state=netps_state, tree=tree,
                 node_kw=dict(device="cpu")),
    "jax": dict(server=JaxPSServer, client=JaxPSClient, tuner=jax_tuner,
                wire=jax_wire, telemetry=jax_telemetry, state=jax_state,
                tree=jax_tree, node_kw={}),
}
#: (client package, server package)
PAIRINGS = [("port", "port"), ("jax", "port"), ("port", "jax"),
            ("jax", "jax")]


def make_server(pkg, **kw):
    kw.setdefault("discipline", "adag")
    return PKGS[pkg]["server"](**kw).start()


def leaves(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def cfg(pkg, **over):
    """A deterministic TunerConfig (no environment), the JAX test's."""
    base = dict(interval=1, cooldown=1, probes=1, max_retunes=8,
                osc_limit=3, hier_fanin=4, min_gain=0.1,
                hidden_floor=0.5, stale_ceiling=4.0)
    base.update(over)
    return PKGS[pkg]["tuner"].TunerConfig(**base)


def same_bits(a, b) -> bool:
    return len(a) == len(b) and all(
        np.asarray(x).tobytes() == np.asarray(y).tobytes()
        and np.shape(x) == np.shape(y) for x, y in zip(a, b))


def wait_for(cond, seconds=8.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def reset_both():
    telemetry.reset()
    jax_telemetry.reset()


# ---------------------------------------------------------------------------
# The wire surface: the caps bit, the op, the registries, the knobs
# ---------------------------------------------------------------------------

def test_tuner_caps_op_and_reply_fields_are_the_jax_rows():
    assert wire.CAPS["tuner"] is True and jax_wire.CAPS["tuner"] is True
    assert wire.OP_PROBE == jax_wire.OP_PROBE == "probe"
    assert wire.OP_REGISTRY[wire.OP_PROBE] == \
        tuple(jax_wire.OP_REGISTRY[jax_wire.OP_PROBE])
    assert {"probe_bytes", "decode_s"} <= wire.HEADER_KEYS
    assert wire.HEADER_KEYS <= jax_wire.HEADER_KEYS


@pytest.mark.parametrize("name,kind", [
    ("DKTPU_NET_AUTOTUNE", "bool"), ("DKTPU_TUNE_INTERVAL", "int"),
    ("DKTPU_TUNE_COOLDOWN", "int"), ("DKTPU_TUNE_PROBES", "int"),
    ("DKTPU_TUNE_MAX_RETUNES", "int"), ("DKTPU_TUNE_OSC_LIMIT", "int"),
    ("DKTPU_TUNE_HIER_FANIN", "int"), ("DKTPU_TUNE_MIN_GAIN", "float"),
    ("DKTPU_TUNE_HIDDEN_FLOOR", "float"), ("DKTPU_TUNE_STALE_CEIL", "float")])
def test_tuner_knobs_are_the_jax_registry_rows(monkeypatch, name, kind):
    from distkeras_tpu.runtime import config as jax_config

    monkeypatch.delenv(name, raising=False)
    mine, theirs = config.ENV_REGISTRY[name], jax_config.ENV_REGISTRY[name]
    assert (mine.kind, mine.default) == (theirs.kind, theirs.default) == \
        (kind, theirs.default)
    assert not config.env_is_set(name)
    monkeypatch.setenv(name, "1")
    assert config.env_is_set(name) and jax_config.env_is_set(name)
    read = getattr(config, f"env_{kind}")
    assert read(name) == getattr(jax_config, f"env_{kind}")(name)
    assert tuner.TunerConfig.from_env() == tuple(
        jax_tuner.TunerConfig.from_env())


def test_autotune_switch_is_read_as_jax_reads_it(monkeypatch):
    monkeypatch.delenv("DKTPU_NET_AUTOTUNE", raising=False)
    assert tuner.autotune_enabled() is jax_tuner.autotune_enabled() is False
    monkeypatch.setenv("DKTPU_NET_AUTOTUNE", "1")
    assert tuner.autotune_enabled() is jax_tuner.autotune_enabled() is True


# ---------------------------------------------------------------------------
# Join-time micro A/B probes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client_pkg,server_pkg", PAIRINGS)
def test_probe_none_against_capability_less_server(monkeypatch, client_pkg,
                                                   server_pkg):
    """A server without the ``tuner`` bit is never probed: ``probe`` is
    None, the sweep is empty, the static knobs stand (the JAX test's case,
    in every package pairing)."""
    monkeypatch.setattr(PKGS[server_pkg]["wire"], "CAPS", {})
    srv = make_server(server_pkg)
    try:
        with PKGS[client_pkg]["client"](srv.endpoint, worker_id=0,
                                        **FAST) as c:
            init = leaves((8,))
            c.join(init=init)
            assert c.probe(init) is None
            tun = PKGS[client_pkg]["tuner"]
            assert tun.probe_codecs(c, init) == []
            assert tun.best_codec([]) is None
    finally:
        srv.close()


def _capture_port_decodes(srv):
    """Record what the port server's probe window decoded (a copy of each
    decoded tensor, read back under the window's lock)."""
    seen = []
    real = srv._probe.decode

    def decode(delta, keep=False):
        nbytes, decoded = real(delta, keep=True)
        seen.append(([e for e in delta], decoded))
        return nbytes, decoded if keep else None

    srv._probe.decode = decode
    return seen


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRINGS)
def test_probe_pays_decode_but_never_touches_server_state(
        tmp_path, client_pkg, server_pkg):
    """The probe op decodes as a commit decodes but leaves the center's
    bits, the commit log, the dedup table, the update counter, the journal
    and the membership exactly as they were, in all four pairings. A port
    server's decode (the fold's twin into the ``-0.0`` window) is the
    numpy ``decode_entry`` of each entry, bit for bit, under every codec,
    in both packages' ``decode_entry``."""
    srv = make_server(server_pkg, state_dir=str(tmp_path / "state"))
    seen = _capture_port_decodes(srv) if server_pkg == "port" else None
    read_journal = PKGS[server_pkg]["state"].read_journal
    try:
        with PKGS[client_pkg]["client"](srv.endpoint, worker_id=0,
                                        **FAST) as c:
            init = leaves((16, 3), (5,), (2, 2, 2))
            _, upd = c.join(init=init)
            assert c.commit([np.ones_like(a) for a in init], upd).applied
            center_before, upd_before = c.pull()
            center_before = [np.array(a) for a in center_before]
            log_before = list(srv.commit_log)
            seq_before = dict(srv._last_seq)
            members_before = sorted(srv._members)
            # The journal's writer is asynchronous: wait for the commit's
            # record before taking the length the sweep must not move.
            journal = str(tmp_path / "state")
            assert wait_for(lambda: len(read_journal(journal)) == 1)
            journal_before = len(read_journal(journal))
            payload = leaves((16, 3), (5,), (2, 2, 2), seed=7)
            for codec in wire.CODECS:
                hdr = c.probe(payload, codec=codec)
                assert hdr is not None and hdr["ok"]
                # probe_bytes is the LOGICAL f32 payload, codec-independent.
                assert hdr["probe_bytes"] == sum(a.nbytes for a in payload)
                assert hdr["decode_s"] >= 0.0
            # A non-member's probe (a pre-join A/B) creates nothing.
            with PKGS[client_pkg]["client"](srv.endpoint, **FAST) as other:
                other.peer_caps = c.peer_caps
                assert other.probe(payload)["ok"]
            center_after, upd_after = c.pull()
            assert srv.commit_log == log_before
            assert dict(srv._last_seq) == seq_before
            assert sorted(srv._members) == members_before
            assert upd_after == upd_before
            assert same_bits(center_before, center_after)
            time.sleep(0.2)  # anything the sweep queued would land now
            assert len(read_journal(journal)) == journal_before
    finally:
        srv.close()
    if seen is not None:
        assert len(seen) == len(wire.CODECS) + 1
        for entries, decoded in seen:
            assert same_bits(decoded, [decode_entry(e) for e in entries])
            assert same_bits(decoded, [jax_decode_entry(e) for e in entries])


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_probe_window_decode_is_decode_entry_bit_for_bit(codec):
    """The probe's decode on its own, at the payloads the exactness hangs
    on: signed zeros, an int8 tensor of scale 0 (the kernel skips it; the
    window must still hold ``q * 0.0``'s ``±0``), an empty tensor, a
    scalar, subnormals; and a smaller probe after a larger one reuses the
    window, which is refilled with ``-0.0`` first."""
    from distkeras_tpu_torch.netps.fold import ProbeWindow

    rng = np.random.default_rng(3)
    big = [rng.normal(size=(300, 7)).astype(np.float32)]
    small = [np.array([0.0, -0.0, 1e-40, -1e-40, 3.5], np.float32),
             np.zeros((0, 4), np.float32), np.float32(-2.25).reshape(()),
             np.zeros(6, np.float32), rng.normal(size=33).astype(np.float32)]
    win = ProbeWindow("cpu")
    for payload in (big, small, big):
        items = []
        for a in payload:
            q, spec = wire.codec_encode(a, codec)
            items.append((q, spec) if spec else q)
        if codec == "int8":
            items.append((np.array([-3, 0, 5], np.int8),
                          {"codec": "int8", "scale": 0.0}))
        nbytes, decoded = win.decode(items, keep=True)
        ref = [np.asarray(decode_entry(e), np.float32) for e in items]
        assert nbytes == sum(r.nbytes for r in ref)
        assert same_bits(decoded, ref)
        assert same_bits(decoded, [np.asarray(jax_decode_entry(e), np.float32)
                                   for e in items])
    assert F.launch_counts()["fold_commit"] == 0  # the CPU takes the twin


def test_probe_of_a_malformed_payload_is_a_protocol_error():
    """A probe whose spec is malformed (an unknown codec, int8 without a
    scale) is answered with the typed ``protocol`` error, as the JAX
    server answers it, and changes nothing."""
    from distkeras_tpu_torch.netps import ProtocolError

    for pkg in ("port", "jax"):
        srv = make_server(pkg)
        try:
            with PSClient(srv.endpoint, worker_id=0, **FAST) as c:
                c.join(init=leaves((4,)))
                for spec in ({"codec": "zstd"}, {"codec": "int8"}):
                    with pytest.raises(ProtocolError, match="bad probe"):
                        c._rpc(wire.OP_PROBE, c._stamped({}),
                               [(np.zeros(4, np.int8), spec)])
                assert srv.commit_log == []
        finally:
            srv.close()


def _raw(endpoint, header, arrays=()):
    """One request frame, sent raw; returns the reply header."""
    with socket.create_connection(wire.split_endpoint(endpoint),
                                  timeout=2.0) as s:
        wire.send_frame(s, wire.KIND_REQUEST, dict(header, req=1),
                        list(arrays))
        s.settimeout(2.0)
        _, hdr, _ = wire.read_frame(s)
    return hdr


def test_standby_answers_a_probe_not_primary():
    """An unpromoted standby answers the probe as the JAX package's does:
    the typed ``not_primary`` (the client walks on it), and no more."""
    from distkeras_tpu.netps.standby import StandbyServer as JaxStandby
    from distkeras_tpu_torch.netps import StandbyServer

    replies = {}
    for pkg, make in (("port", lambda ep: StandbyServer(
            ep, device="cpu", promote_after=30.0)),
            ("jax", lambda ep: JaxStandby(ep, promote_after=30.0))):
        srv = make_server(pkg, center=leaves((4,)))
        sb = make(srv.endpoint).start()
        try:
            hdr = _raw(sb.endpoint, {"op": wire.OP_PROBE}, leaves((4,)))
            replies[pkg] = {k: hdr.get(k) for k in ("ok", "error")}
            assert sb.commit_log == [] and not sb.promoted
        finally:
            sb.close()
            srv.close()
    assert replies["port"] == replies["jax"] == {"ok": None,
                                                 "error": "not_primary"}


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRINGS)
def test_probe_sweep_structure_matches_jax(client_pkg, server_pkg):
    """One ``ProbeResult`` per advertised codec, in ``wire.CODECS`` order,
    each with its probe count and the same logical payload bytes whatever
    the package; the winner is one of them (which one is the clock's)."""
    reset_both()
    srv = make_server(server_pkg)
    tel = PKGS[client_pkg]["telemetry"]
    try:
        with PKGS[client_pkg]["client"](srv.endpoint, worker_id=0,
                                        **FAST) as c:
            init = leaves((64, 8), (3,))
            c.join(init=init)
            results = PKGS[client_pkg]["tuner"].probe_codecs(c, init,
                                                             probes=2)
    finally:
        srv.close()
    assert [r.codec for r in results] == list(wire.CODECS)
    assert all(r.score > 0 and r.probes == 2 for r in results)
    assert {r.payload_bytes for r in results} == {
        2 * sum(a.nbytes for a in init)}
    assert tuner.best_codec(results) in wire.CODECS
    assert tuner.best_codec(results) == jax_tuner.best_codec(results)
    reg = tel.get()
    assert reg.counter("tuner.probes").value == 2 * len(wire.CODECS)
    assert [e["codec"] for e in reg.events()
            if e["kind"] == "tuner_probe"] == list(wire.CODECS)
    assert PKGS[server_pkg]["telemetry"].get().counter(
        "netps.probes").value == 2 * len(wire.CODECS)
    reset_both()


# ---------------------------------------------------------------------------
# Mid-run renegotiation: exactly-once and torn-pull safety
# ---------------------------------------------------------------------------

def _retune_in_flight_script(pkg):
    srv = make_server(pkg)
    try:
        with PKGS[pkg]["client"](srv.endpoint, worker_id=0, **FAST) as c:
            init = [np.zeros(6, np.float32)]
            _, upd = c.join(init=init)
            assert c.commit([np.ones(6, np.float32)], upd).applied  # seq 0
            changed = c.retune(codec="int8")
            assert changed == {"codec": ("none", "int8")}
            assert c._residual is None  # error feedback restarts
            # The retransmit of seq 0 after the retune (its reply was
            # "lost"): the ORIGINAL seq, answered by the dedup table.
            hdr, _ = c._rpc("commit", {"seq": 0, "pulled": 0},
                            [np.ones(6, np.float32)])
            assert hdr["duplicate"] is True
            _, upd = c.pull()
            delta = leaves((6,), seed=5)
            assert c.commit(delta, upd).applied
            log = [(w, s) for w, s, _st in srv.commit_log]
            return log, srv.center()
    finally:
        srv.close()


def test_retune_with_commits_in_flight_preserves_exactly_once():
    """The JAX test's scenario in both packages: each seq folds once, and
    the port's center (an f32 fold, then an int8 one) is the JAX
    package's, bit for bit."""
    mine, theirs = (_retune_in_flight_script(p) for p in ("port", "jax"))
    assert mine[0] == theirs[0] == [(0, 0), (0, 1)]
    assert same_bits(mine[1], theirs[1])


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRINGS)
def test_retune_survives_rejoin_with_the_retuned_preference(client_pkg,
                                                            server_pkg):
    """A rejoin renegotiates from the RETUNED codec, not the
    construction-time one: a walk must not undo the controller."""
    srv = make_server(server_pkg)
    try:
        with PKGS[client_pkg]["client"](srv.endpoint, worker_id=0,
                                        **FAST) as c:
            init = leaves((4,))
            c.join(init=init)
            c.retune(codec="bf16")
            assert c.requested_codec == "bf16"
            c.join()  # an explicit rejoin renegotiates the dialect
            assert c.codec == "bf16"
    finally:
        srv.close()


def _restripe_script(pkg):
    srv = make_server(pkg, discipline="downpour")
    client = PKGS[pkg]["client"]
    try:
        init = leaves((40, 3), (7,), (2, 2), (90,))
        with client(srv.endpoint, worker_id=0, shards=2, **FAST) as c, \
                client(srv.endpoint, worker_id=1, **FAST) as plain:
            _, upd = c.join(init=init)
            plain.join()
            assert c.active_shards == 2
            assert c.commit([np.ones_like(a) for a in init], upd).applied
            assert c.retune(shards=1, template=init) == {"shards": (2, 1)}
            striped_off, u1 = c.pull()
            ref, u2 = plain.pull()
            assert u1 == u2 and same_bits(striped_off, ref)
            _, upd = c.pull()
            assert c.commit(leaves((40, 3), (7,), (2, 2), (90,), seed=2),
                            upd).applied
            assert c.retune(shards=2, template=init) == {"shards": (1, 2)}
            assert c._striped() and len(c._stripes) == 2
            striped_on, u3 = c.pull()
            ref, u4 = plain.pull()
            assert u3 == u4 and same_bits(striped_on, ref)
            _, upd = c.pull()
            assert c.commit([np.ones_like(a) for a in init], upd).applied
        log = [(w, s) for w, s, _ in srv.commit_log]
        return log, srv.center()
    finally:
        srv.close()


def test_striping_retune_midrun_without_torn_pull():
    """Flipping the stripe count mid-run (2 -> 1 -> 2): every pull before
    and after reassembles the center an unstriped observer sees, each
    logical commit folds once, and the port's center is the JAX
    package's run of the same script, bit for bit."""
    mine, theirs = (_restripe_script(p) for p in ("port", "jax"))
    assert mine[0] == theirs[0] == [(0, 0), (0, 1), (0, 2)]
    assert same_bits(mine[1], theirs[1])


def test_striped_pull_after_a_restripe_sees_the_new_stripes(monkeypatch):
    """A torn striped pull is re-read over the stripes of the moment: after
    a 1 -> 2 retune the retry loop reads the new stripe set, never the
    old one, and a pull torn by a fold between its stripes is re-read
    (``netps.pull_torn_retries``) into a consistent center."""
    telemetry.reset()
    srv = make_server("port", discipline="downpour")
    try:
        init = leaves((40, 3), (7,), (90,))
        with PSClient(srv.endpoint, worker_id=0, shards=2, **FAST) as c, \
                PSClient(srv.endpoint, worker_id=1, **FAST) as other:
            _, upd = c.join(init=init)
            other.join()
            c.retune(shards=1, template=init)
            c.retune(shards=2, template=init)
            real = c._rpc
            torn = {"left": 1}
            first_read = threading.Event()
            widths = []

            def rpc(op, header, arrays=(), conn_idx=0):
                # The first striped pull is torn on purpose: stripe 1 is
                # sent only after stripe 0 was read and a fold landed.
                if op == wire.OP_PULL and "shard" in header:
                    widths.append(header["num_shards"])
                if (op == wire.OP_PULL and header.get("shard") == 1
                        and torn["left"]):
                    torn["left"] -= 1
                    assert first_read.wait(5.0)
                    _, u = other.pull()
                    other.commit([np.ones_like(a) for a in init], u)
                out = real(op, header, arrays, conn_idx)
                if op == wire.OP_PULL and header.get("shard") == 0:
                    first_read.set()
                return out

            monkeypatch.setattr(c, "_rpc", rpc)
            center, u = c.pull()
            ref, u_ref = other.pull()
        assert u == u_ref == 1 and same_bits(center, ref)
        assert widths == [2] * 4  # the torn read and its re-read
        assert telemetry.get().counter("netps.pull_torn_retries").value == 1
    finally:
        srv.close()
        telemetry.reset()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_retune_clamps_unknown_codec_and_out_of_range_shards(pkg):
    srv = make_server(pkg)
    try:
        with PKGS[pkg]["client"](srv.endpoint, worker_id=0, **FAST) as c:
            init = leaves((4,))
            c.join(init=init)
            assert c.retune(codec="zstd") == {}  # never advertised
            assert c.codec == "none"
            # One connection: a 4-way stripe target clamps to 1 (no-op).
            assert c.retune(shards=4, template=init) == {}
            assert c.active_shards == 1
    finally:
        srv.close()


def test_retune_clamps_against_a_peer_without_striping(monkeypatch):
    """A peer that never advertised ``striping`` clamps any stripe target
    to 1, and a peer that never advertised a codec refuses it, in both
    packages' clients against the port's server."""
    monkeypatch.setattr(wire, "CAPS", {k: v for k, v in wire.CAPS.items()
                                       if k != "striping"} | {
        "codecs": ["none", "bf16"]})
    srv = make_server("port")
    try:
        for client in (PSClient, JaxPSClient):
            with client(srv.endpoint, shards=2, **FAST) as c:
                init = leaves((4,), (6,))
                c.join(init=init)
                assert c.active_shards == 1
                assert c.retune(shards=2, template=init) == {}
                assert c.retune(codec="int8") == {}
                assert c.retune(codec="bf16") == {"codec": ("none", "bf16")}
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Controller guardrails: both Tuners fed the same proposals and gauges
# ---------------------------------------------------------------------------

class FakeClient:
    walk_count = 0

    def __init__(self):
        self.calls = []

    def retune(self, codec=None, shards=None, template=None):
        self.calls.append((codec, shards))
        return {"codec": (None, codec)}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_apply_to_during_failover_walk_is_deferred_not_lost(pkg):
    tun, tel = PKGS[pkg]["tuner"], PKGS[pkg]["telemetry"]
    tel.reset()
    t = tun.Tuner(4, cfg=cfg(pkg))
    assert t.propose("codec", "none", "int8", "test", 0)
    assert t.generation == 1
    fc, st = FakeClient(), tun.TunerState()
    fc.walk_count = 2  # the endpoint walker moved since st.walks == 0
    assert t.apply_to(fc, [], st) is None
    assert fc.calls == [] and st.generation == 0  # deferred...
    assert t.deferred == 1
    assert tel.get().counter("tuner.deferred").value == 1
    # ...and retried next round (no further walk): the generation lands.
    assert t.apply_to(fc, [], st) == {"codec": (None, "int8")}
    assert fc.calls == [("int8", None)] and st.generation == 1
    assert t.apply_to(fc, [], st) is None  # nothing left to adopt
    tel.reset()


#: proposal scripts ``(knob, old, new, round)``, each run on a fresh Tuner
#: of both packages under the given config and peer codecs.
SCRIPTS = {
    "floors": (dict(), ("none", "bf16"), 2, [
        ("inflight", 2, 0, 0), ("codec", "none", "int8", 0),
        ("shards", 1, 3, 0), ("inflight", 2, 5, 1), ("codec", "none",
                                                      "bf16", 1)]),
    "cooldown_budget": (dict(cooldown=5, max_retunes=2), wire.CODECS, 1, [
        ("inflight", 1, 2, 0), ("inflight", 2, 3, 2), ("inflight", 2, 3, 5),
        ("inflight", 3, 4, 20), ("codec", "none", "int8", 21)]),
    "oscillation": (dict(osc_limit=2, max_retunes=100), wire.CODECS, 1, [
        ("inflight", 1, 2, 0), ("inflight", 2, 1, 10), ("inflight", 1, 2, 20),
        ("inflight", 1, 3, 40), ("codec", "none", "bf16", 40),
        ("codec", "bf16", "none", 41), ("codec", "none", "bf16", 42)]),
    "no_change_and_topology": (dict(max_retunes=1), wire.CODECS, 1, [
        ("inflight", 1, 1, 0), ("shards", 1, 2, 0), ("shards", 2, 1, 3),
        ("topology", None, "hier", 4)]),
}

_COUNTERS = ("tuner.decisions", "tuner.floor_violations",
             "tuner.oscillation_fallbacks", "tuner.decision.inflight",
             "tuner.decision.codec", "tuner.decision.shards",
             "tuner.decision.topology")


def _run_script(pkg, name):
    over, codecs, inflight, proposals = SCRIPTS[name]
    tel = PKGS[pkg]["telemetry"]
    tel.reset()
    t = PKGS[pkg]["tuner"].Tuner(4, inflight=inflight, cfg=cfg(pkg, **over))
    t.peer_codecs = tuple(codecs)
    outcomes = [t.propose(k, old, new, "script", r)
                for k, old, new, r in proposals]
    reg = tel.get()
    state = dict(outcomes=outcomes,
                 decisions=[tuple(d) for d in t.decisions],
                 knobs=(t.inflight, t.codec, t.shards, t.generation),
                 tallies=(t.retunes, t.fallbacks, t.deferred),
                 counters=[reg.counter(c).value for c in _COUNTERS],
                 fallbacks=[{k: e[k] for k in ("knob", "restored", "round",
                                               "reason")}
                            for e in reg.events()
                            if e["kind"] == "tuner_fallback"],
                 gauges={k: v["value"] for k, v in
                         reg.snapshot()["gauges"].items()
                         if k.startswith("tuner.")})
    tel.reset()
    return state


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_guardrails_decide_as_the_jax_tuner_decides(name):
    """Floors (a dropped proposal still spends budget and counts a floor
    violation), cooldown and the retune budget, and the oscillation
    fallback to the static initial value: the port's Tuner takes exactly
    the JAX Tuner's decisions on the same proposals, with the same
    counters, events and knob gauges."""
    mine, theirs = _run_script("port", name), _run_script("jax", name)
    assert mine == theirs
    if name == "oscillation":
        assert mine["knobs"][0] == 1 and mine["tallies"][1] == 2


def test_floor_violating_proposal_is_dropped_and_counted():
    """The JAX test's case, on the port alone."""
    telemetry.reset()
    t = tuner.Tuner(4, inflight=2, cfg=cfg("port"))
    assert not t.propose("inflight", 2, 0, "test", 0)  # below floor
    assert t.inflight == 2
    t.peer_codecs = ("none", "bf16")
    assert not t.propose("codec", "none", "int8", "test", 0)  # unadvertised
    assert t.codec is None
    assert telemetry.get().counter("tuner.floor_violations").value == 2
    telemetry.reset()


class FakeAgg:
    def __init__(self):
        self.fan_in = None
        self.calls = []

    def set_fan_in(self, fan_in):
        self.calls.append(fan_in)
        self.fan_in = fan_in


#: per round: (transport, hidden_fraction, staleness_mean, hier fan-in);
#: None leaves the gauge unset (never set means no evidence).
GAUGES = [("tcp", None, None, None), ("tcp", 0.2, 1.0, 3.0),
          ("tcp", 0.3, 1.5, 3.0), ("tcp", 0.9, 6.0, 5.0),
          ("tcp", 0.9, 6.0, 5.0), ("shm", 0.1, 2.0, 2.0),
          ("shm", 0.8, 1.0, 4.0), ("mesh", 0.2, 5.0, 4.0),
          ("tcp", 0.1, 0.0, 1.0), ("tcp", 0.1, 0.0, 1.0),
          ("tcp", 0.95, 0.5, 6.0), ("mesh", 0.1, 9.0, 2.0)]


def _run_loop(pkg, interval, stripe_ceiling):
    tel = PKGS[pkg]["telemetry"]
    tel.reset()
    t = PKGS[pkg]["tuner"].Tuner(
        4, inflight=2, cfg=cfg(pkg, interval=interval, cooldown=2,
                               max_retunes=20))
    t.stripe_ceiling = stripe_ceiling
    agg = FakeAgg()
    t.attach_aggregator(agg)
    published = []
    for r, (transport, hidden, stale, fan) in enumerate(GAUGES):
        for name, v in (("netps.overlap.hidden_fraction", hidden),
                        ("discipline.staleness_mean", stale),
                        ("netps.hier.fan_in", fan)):
            if v is not None:
                tel.gauge(name).set(v)
        published.append(t.maybe_decide(r, transport))
    state = dict(published=published,
                 decisions=[tuple(d) for d in t.decisions],
                 knobs=(t.inflight, t.codec, t.shards, t.generation),
                 tallies=(t.retunes, t.fallbacks), agg=agg.calls)
    tel.reset()
    return state


@pytest.mark.parametrize("interval,stripe_ceiling", [(1, 1), (1, 2), (3, 2)])
def test_control_loop_reads_the_same_gauges_into_the_same_decisions(
        interval, stripe_ceiling):
    """The online loop of both packages over one gauge sequence (overlap,
    staleness and the aggregator's fan-in across TCP, the ring and the
    mesh): the same evaluations published, the same Decision list, the
    same knobs and the same aggregator retunes. The first evaluation
    lands at ``r == interval``: round 0's gauges are not evidence."""
    mine = _run_loop("port", interval, stripe_ceiling)
    theirs = _run_loop("jax", interval, stripe_ceiling)
    assert mine == theirs
    assert not mine["published"][0]
    assert any(mine["published"])


@pytest.mark.parametrize("workers,crossover", [(1, 4), (3, 4), (4, 4),
                                               (8, 4), (2, None), (4, None),
                                               (5, 6), (6, 6)])
def test_recommended_topology_flips_at_the_fan_in_crossover(workers,
                                                            crossover):
    want = jax_tuner.recommended_topology(workers, crossover)
    assert tuner.recommended_topology(workers, crossover) == want
    assert want == ("hier" if workers >= (crossover or 4) else "flat")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_choose_topology_is_recorded_as_a_decision(pkg):
    t = PKGS[pkg]["tuner"].Tuner(8, cfg=cfg(pkg))
    assert t.choose_topology() == "hier"
    assert t.decisions[-1].knob == "topology"
    assert t.decisions[-1].old is None  # chosen, not changed
    assert t.generation == 0  # topology travels through no client


# ---------------------------------------------------------------------------
# The marginal-throughput expansion gate
# ---------------------------------------------------------------------------

#: one job's scheduler ticks: (workers, progress, now), with the
#: allow_expand question asked after each.
TICKS = [(1, 0, 0.0), (1, 100, 1.0), (2, 100, 1.0), (2, 205, 2.0),
         (2, 350, 3.0), (3, 350, 3.1), (3, 360, 3.2), (3, 500, 4.0),
         (2, 500, 4.0), (2, 600, 4.1), (2, 800, 5.0)]


def _run_policy(pkg, min_gain):
    tel = PKGS[pkg]["telemetry"]
    tel.reset()
    p = PKGS[pkg]["tuner"].MarginalThroughputPolicy(min_gain=min_gain)
    answers = [p.allow_expand("t/j", 1)]
    for workers, progress, now in TICKS:
        p.observe("t/j", workers, progress, now=now)
        answers.append(p.allow_expand("t/j", workers))
    reg = tel.get()
    state = dict(answers=answers, rates=dict(p._jobs["t/j"]["rates"]),
                 blocked=reg.counter("tuner.expand_blocked").value,
                 events=[{k: v for k, v in e.items() if k != "ts"}
                         for e in reg.events()
                         if e["kind"] == "tuner_expand_blocked"],
                 gauge=reg.gauge("tuner.marginal_tput.t/j").value)
    tel.reset()
    return state


@pytest.mark.parametrize("min_gain", [0.1, 0.0, 0.5])
def test_marginal_throughput_policy_matches_jax(min_gain):
    """The same observe sequence into both policies: the same expansion
    answers, the same rate table, the same blocked count and events."""
    mine, theirs = _run_policy("port", min_gain), _run_policy("jax", min_gain)
    assert mine == theirs
    if min_gain == 0.1:
        assert mine["answers"][:5] == [True, True, True, True, False]


def test_marginal_throughput_policy_reads_its_gain_from_the_environment(
        monkeypatch):
    monkeypatch.setenv("DKTPU_TUNE_MIN_GAIN", "0.25")
    assert tuner.MarginalThroughputPolicy().min_gain == 0.25
    monkeypatch.delenv("DKTPU_TUNE_MIN_GAIN")
    assert tuner.MarginalThroughputPolicy().min_gain == \
        jax_tuner.MarginalThroughputPolicy().min_gain == 0.1


# ---------------------------------------------------------------------------
# The tree uplink's codec pick
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("node_pkg,root_pkg", PAIRINGS)
def test_tree_uplink_probes_its_codec(node_pkg, root_pkg):
    """A tree node with ``probe_links`` (the default) sweeps the codecs
    over its uplink with its center as the payload and retunes to the
    winner: its ``netps_tree_link_codec`` event reads ``how="probed"``
    and names the codec its uplink client runs; the root's probe counter
    shows the sweep (one probe a codec a round, ``DKTPU_TUNE_PROBES``)."""
    reset_both()
    p = PKGS[node_pkg]
    r = make_server(root_pkg, center=leaves((64,), (8,)))
    n = p["tree"].TreeNode(r.endpoint, fan_in=1, flush_interval=0.05,
                           **FAST, **p["node_kw"]).start()
    try:
        ev = [e for e in p["telemetry"].get().events()
              if e["kind"] == "netps_tree_link_codec"]
        assert [e["how"] for e in ev] == ["probed"]
        assert ev[0]["codec"] == n.link_codec == n._up.codec
        assert n.link_codec in wire.CODECS
        probes = config.env_int("DKTPU_TUNE_PROBES")
        assert PKGS[root_pkg]["telemetry"].get().counter(
            "netps.probes").value == probes * len(wire.CODECS)
    finally:
        n.close()
        r.close()
        reset_both()


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("how", ["pinned", "off"])
def test_tree_uplink_pinned_or_unprobed_sends_no_probe(pkg, how):
    """A pinned codec is retuned to without a sweep (``how="pinned"``);
    ``probe_links=False`` keeps the negotiated default
    (``how="default"``). Neither sends a probe."""
    reset_both()
    p = PKGS[pkg]
    r = make_server("port", center=leaves((64,), (8,)))
    kw = (dict(link_codec="int8") if how == "pinned"
          else dict(probe_links=False))
    n = p["tree"].TreeNode(r.endpoint, fan_in=1, flush_interval=0.05,
                           **FAST, **p["node_kw"], **kw).start()
    try:
        ev = [e for e in p["telemetry"].get().events()
              if e["kind"] == "netps_tree_link_codec"]
        want = ("pinned", "int8") if how == "pinned" else ("default", "none")
        assert [(e["how"], e["codec"]) for e in ev] == [want]
        assert n._up.codec == want[1]
        assert telemetry.get().counter("netps.probes").value == 0
    finally:
        n.close()
        r.close()
        reset_both()


def test_tree_uplink_keeps_its_default_against_a_peer_without_the_bit(
        monkeypatch):
    """Against a root without the ``tuner`` bit the sweep is empty: the
    link keeps its negotiated codec and says ``how="default"``."""
    reset_both()
    r = make_server("port", center=leaves((8,)))
    monkeypatch.setattr(wire, "CAPS", {k: v for k, v in wire.CAPS.items()
                                       if k != "tuner"})
    n = tree.TreeNode(r.endpoint, fan_in=1, flush_interval=0.05,
                      device="cpu", **FAST).start()
    try:
        ev = [e for e in telemetry.get().events()
              if e["kind"] == "netps_tree_link_codec"]
        assert [(e["how"], e["codec"]) for e in ev] == [("default", "none")]
    finally:
        n.close()
        r.close()
        reset_both()


def test_tree_probe_failure_leaves_a_working_default_link(monkeypatch):
    """A sweep that fails mid-way (here the first probe raises a transport
    error) is abandoned: the link keeps its f32 default and still folds."""
    from distkeras_tpu_torch.netps.errors import RPCTimeoutError

    reset_both()
    r = make_server("port", center=[np.zeros(4, np.float32)])

    def broken(self, arrays, codec=None):
        raise RPCTimeoutError("probe lost", attempts=1)

    monkeypatch.setattr(PSClient, "probe", broken)
    n = tree.TreeNode(r.endpoint, fan_in=1, flush_interval=0.05,
                      device="cpu", **FAST).start()
    try:
        ev = [e for e in telemetry.get().events()
              if e["kind"] == "netps_tree_link_codec"]
        assert [(e["how"], e["codec"]) for e in ev] == [("default", "none")]
        with PSClient(n.endpoint, **FAST) as c:
            _, u = c.join()
            assert c.commit([np.ones(4, np.float32)], u).applied
        n.close()
        np.testing.assert_array_equal(r.center()[0], 1.0)
    finally:
        n.close()
        r.close()
        reset_both()


# ---------------------------------------------------------------------------
# DKTPU_NET_AUTOTUNE through run_remote, against the JAX package's run
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
K_STEPS, B = 2, 5


def _columns(W, rounds, seed=0):
    rng = np.random.default_rng(seed)
    n = W * K_STEPS * B * rounds
    return {"features": rng.integers(0, 50, (n, 6)).astype(np.int32),
            "label": rng.integers(0, 2, n).astype(np.int32)}


def _kw(W):
    return dict(worker_optimizer="sgd",
                loss="sparse_categorical_crossentropy", num_workers=W,
                batch_size=B, communication_window=K_STEPS,
                learning_rate=0.1)


def _summaries(tel):
    return [{k: e.get(k) for k in ("inflight", "codec", "shards",
                                   "transport")}
            for e in tel.get().events() if e["kind"] == "tuner_run_summary"]


def _decisions(tel, knob):
    return [e for e in tel.get().events()
            if e["kind"] == "tuner_decision" and e["knob"] == knob]


@pytest.mark.parametrize("transport", ["tcp", "shm"])
def test_autotuned_dynsgd_trains_exactly_once_and_replays_in_jax(
        monkeypatch, tmp_path, transport):
    """``DynSGD(..., remote=)`` with ``DKTPU_NET_AUTOTUNE=1`` trains instead
    of raising, in both packages, on TCP (the probe sweep at join) and the
    ring (the ring's rule). With the tuner aboard both comms lanes run, so
    the fold order is the clock's: each package's run folds every commit
    once, the port's model is its server's center, and that center is the
    JAX package's replay of the port server's journal, bit for bit. Both
    runs converge to the same dialect by the same decisions where the
    decisions do not depend on the clock (the ring's rule; the interval is
    past the last round, so nothing is decided mid-run)."""
    import distkeras_tpu as dk
    from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
    from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch import trainers as T
    from distkeras_tpu_torch.data import DataFrame

    monkeypatch.setenv("DKTPU_NET_AUTOTUNE", "1")
    monkeypatch.setenv("DKTPU_NET_TRANSPORT", transport)
    monkeypatch.setenv("DKTPU_TUNE_INTERVAL", "100")
    monkeypatch.setenv("DKTPU_NET_TIMEOUT", "5.0")
    W, rounds = 1, 4
    cols = _columns(W, rounds, seed=6)
    reset_both()
    d = str(tmp_path / "state")
    tsrv = PSServer(discipline="dynsgd", device="cpu", state_dir=d,
                    snapshot_every=100).start()
    try:
        pt = T.DynSGD(imdb_lstm(**SMALL, device="cpu", seed=3), **_kw(W),
                      remote=tsrv.endpoint)
        pout = pt.train(DataFrame(cols))
        log, center = list(tsrv.commit_log), tsrv.center()
    finally:
        tsrv.close()
    jsrv = JaxPSServer(discipline="dynsgd", transport=transport).start()
    try:
        jt = dk.DynSGD(jax_imdb_lstm(**SMALL, seed=3), **_kw(W),
                       remote=jsrv.endpoint)
        jt.train(JaxDataFrame(cols))
        jlog = list(jsrv.commit_log)
    finally:
        jsrv.close()
    assert sorted((w, s) for w, s, _ in log) == sorted(
        (w, s) for w, s, _ in jlog) == [(0, s) for s in range(rounds)]
    for p, c in zip(pout.params.values(), center):
        np.testing.assert_array_equal(p.numpy(), c)
    assert np.isfinite(pt.get_worker_histories()).all()
    rec = jax_state.StateStore(d).recover("dynsgd")
    assert rec.updates == rec.commits_total == rounds
    assert same_bits(center, rec.center), "JAX replay differs from the port"
    mine, theirs = _summaries(telemetry), _summaries(jax_telemetry)
    assert len(mine) == len(theirs) == 1
    assert mine[0]["transport"] == theirs[0]["transport"] == transport
    assert mine[0]["inflight"] == theirs[0]["inflight"] == 2
    assert [e["to"] for e in _decisions(telemetry, "topology")] == \
        [e["to"] for e in _decisions(jax_telemetry, "topology")] == ["flat"]
    if transport == "shm":
        assert mine == theirs
        assert mine[0]["codec"] == "none" and mine[0]["shards"] == 1
    else:
        # One sweep of every codec on each side; each side's winner is
        # its clock's, and what it runs at the end.
        for tel in (telemetry, jax_telemetry):
            assert [e["codec"] for e in tel.get().events()
                    if e["kind"] == "tuner_probe"] == list(wire.CODECS)
        assert mine[0]["codec"] in wire.CODECS
    reset_both()


@pytest.mark.parametrize("workers,topology", [(2, "flat"), (4, "hier")])
def test_choose_topology_puts_an_aggregator_in_at_the_crossover(
        monkeypatch, workers, topology):
    """An unpinned ``hier`` under autotune is the fan-in crossover's
    (``DKTPU_TUNE_HIER_FANIN``, 4): at W = 4 the root sees one committer,
    the aggregator, at W = 2 every worker's own commits, in both
    packages."""
    import distkeras_tpu as dk
    from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
    from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch import trainers as T
    from distkeras_tpu_torch.data import DataFrame

    monkeypatch.setenv("DKTPU_NET_AUTOTUNE", "1")
    monkeypatch.setenv("DKTPU_NET_TRANSPORT", "shm")
    monkeypatch.setenv("DKTPU_TUNE_INTERVAL", "100")
    monkeypatch.setenv("DKTPU_NET_TIMEOUT", "5.0")
    monkeypatch.delenv("DKTPU_NET_HIER", raising=False)
    rounds = 2
    cols = _columns(workers, rounds, seed=8)
    reset_both()
    logs = {}
    for pkg in ("port", "jax"):
        srv = make_server(pkg, discipline="adag", transport="shm")
        try:
            if pkg == "port":
                T.ADAG(imdb_lstm(**SMALL, device="cpu", seed=3),
                       **_kw(workers), remote=srv.endpoint).train(
                    DataFrame(cols))
            else:
                dk.ADAG(jax_imdb_lstm(**SMALL, seed=3), **_kw(workers),
                        remote=srv.endpoint).train(JaxDataFrame(cols))
            logs[pkg] = list(srv.commit_log)
        finally:
            srv.close()
    for pkg, tel in (("port", telemetry), ("jax", jax_telemetry)):
        assert [e["to"] for e in _decisions(tel, "topology")] == [topology]
        ids = {w for w, _s, _st in logs[pkg]}
        if topology == "hier":
            # One committer, the aggregator, each of its seqs once.
            assert len(ids) == 1
            assert [s for _w, s, _st in logs[pkg]] == list(
                range(len(logs[pkg])))
        else:
            assert sorted((w, s) for w, s, _ in logs[pkg]) == [
                (w, s) for w in range(workers) for s in range(rounds)]
    reset_both()


def test_autotune_against_a_shard_matrix_trains_in_neither_package(
        monkeypatch):
    """The sharded client has no codec, probe or retune in either package:
    the JAX package's run fails in its worker (``AttributeError``) and
    folds nothing; the port refuses the combination with a ``ValueError``
    that names it, before any worker joins a shard."""
    import distkeras_tpu as dk
    from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
    from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
    from distkeras_tpu.netps.shards import ShardSet as JaxShardSet
    from distkeras_tpu_torch import imdb_lstm
    from distkeras_tpu_torch import trainers as T
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.netps import ShardSet

    monkeypatch.setenv("DKTPU_NET_AUTOTUNE", "1")
    cols = _columns(1, 2)
    with JaxShardSet(2, discipline="dynsgd") as jss:
        with pytest.raises(AttributeError):
            dk.DynSGD(jax_imdb_lstm(**SMALL, seed=1), **_kw(1),
                      remote=jss.endpoint).train(JaxDataFrame(cols))
        assert [s.commit_log for s in jss.servers] == [[], []]
    with ShardSet(2, discipline="dynsgd", device="cpu") as ss:
        with pytest.raises(ValueError, match="sharded endpoint"):
            T.DynSGD(imdb_lstm(**SMALL, device="cpu"), **_kw(1),
                     remote=ss.endpoint).train(DataFrame(cols))
        assert [s.commit_log for s in ss.servers] == [[], []]
        assert [s.members() for s in ss.servers] == [[], []]
