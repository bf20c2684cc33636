"""The port's ``mesh`` dialect (``netps/mesh.py``), mirrored from the JAX
package's ``tests/test_netps_mesh.py``: a same-process client hands its
requests to the server's in-process dispatch and every commit folds into
the device center (here the CPU: the fold's plain twin) as every server
folds, with dedup, leases and the journal unchanged; ``MeshFolder`` is
that fold as a standalone entry.

Held here:

* **Negotiation is live**: the ``mesh`` advertisement is honoured only
  when its ``proc`` is this process's ``torch:`` token; a mesh client
  negotiates the shm ring too (its demotion target); the port and the JAX
  package never upgrade against each other's mesh and land on the ring.
* **The fold is the oracle's, bit for bit**: the port's ``MeshFolder``
  equals the JAX package's exact ``MeshFolder`` byte for byte for codecs
  ``none``, ``bf16`` and ``int8``, and the JAX one's fused formulation
  (``fold_traced`` through Pallas in interpret mode) within that test's
  own bar (rtol 1e-6, atol 1e-7: XLA:CPU may contract ``c + s*d`` into one
  rounding).
* **Demotion is one strike and exactly-once**: the server's token
  unregistered mid-run (what ``close`` does first) sweeps the dialect,
  the same seq lands on the ring, and the center equals a TCP run's.
* **The transport does not change the result**: a config #8-shaped
  transformer (AEASGD, 2 layers, narrow) under ``run_remote`` at
  ``inflight=1`` ends bit-identical over ``tcp``, ``shm`` and ``mesh``,
  and within 1e-5 of the JAX package's ``run_remote`` over the same
  transport (dense attention and sgd, the limit
  ``tests/test_torch_transformer_train.py`` holds the sgd case to; adam's
  normalised step turns rounding noise into whole steps, which that file
  explains).
"""

import types
import warnings

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.netps import PSClient as JaxPSClient
from distkeras_tpu.netps import PSServer as JaxPSServer
from distkeras_tpu.netps import mesh as jax_mesh
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import PSClient, PSServer, wire
from distkeras_tpu_torch.netps import client as client_mod
from distkeras_tpu_torch.netps import fold as nfold
from distkeras_tpu_torch.netps import mesh as _mesh
from distkeras_tpu_torch.netps.client import (_BAD_KNOB_COMBOS_WARNED,
                                              _validate_knob_combo)
from distkeras_tpu_torch.netps.fold import fold_compressed_numpy
from distkeras_tpu_torch.ops.kernels import fold as F

FAST = dict(timeout=1.0, retries=3, backoff=0.01)
CODECS = ("none", "bf16", "int8")


def leaves():
    rng = np.random.default_rng(7)
    return [rng.normal(size=(4, 3)).astype(np.float32),
            rng.normal(size=(8,)).astype(np.float32)]


def span_count(snap, name):
    """Calls of span ``name``, wherever it nested (a mesh server's span
    runs on the client's thread, under the client's RPC span)."""
    return sum(v["count"] for k, v in snap["spans"].items()
               if k == name or k.endswith("/" + name))


def server(transport="mesh", **kw):
    return PSServer(discipline=kw.pop("discipline", "adag"), device="cpu",
                    transport=transport, **kw).start()


def drive_commits(endpoint, n, *, compress="none", worker_id=0, after=None,
                  **kw):
    """Join and fold ``n`` deterministic commits; ``after(i)`` runs after
    commit ``i``. Returns the (open) client and its last pull."""
    rng = np.random.default_rng(worker_id + 1)
    c = PSClient(endpoint, worker_id=worker_id, compress=compress,
                 **dict(FAST, **kw))
    center, upd = c.join(init=leaves())
    for i in range(n):
        delta = [rng.normal(scale=0.1, size=a.shape).astype(np.float32)
                 for a in center]
        c.commit(delta, upd)
        if after is not None:
            after(i)
        center, upd = c.pull()
    return c, center, upd


# ---------------------------------------------------------------------------
# Negotiation + observability
# ---------------------------------------------------------------------------

def test_mesh_negotiation_upgrades_and_stats():
    telemetry.reset()
    srv = server()
    try:
        c, center, _ = drive_commits(srv.endpoint, 3, transport="mesh")
        try:
            assert c.active_transport == "mesh"
            assert c.mesh_info["proc"] == _mesh.local_mesh_id()
            assert c.mesh_info["proc"].startswith("torch:")
            assert c.mesh_info["backend"] == "cpu"
            assert c.shm_info is not None, \
                "a mesh client negotiates its shm demotion target"
            assert c.stats()["fold_backend"] == "torch-cpu"
        finally:
            c.close()
        for a, b in zip(srv.center(), center):
            assert a.tobytes() == b.tobytes()
        reg = telemetry.get()
        assert reg.counter("netps.mesh.upgrades").value == 1
        assert reg.counter("netps.mesh.folds").value == 3
        snap = reg.snapshot()
        assert snap["spans"]["netps.rpc.commit.mesh"]["count"] == 3
        assert span_count(snap, "netps.server.commit.mesh") == 3
        # A TCP client of the same server never sees the dialect; its
        # commit folds into the same center, and not through the dispatch.
        t = PSClient(srv.endpoint, worker_id=1, transport="tcp", **FAST)
        try:
            _, upd = t.join()
            assert t.active_transport == "tcp" and t.mesh_info is None
            assert t.commit([np.ones_like(a) for a in srv.center()],
                            upd).applied
        finally:
            t.close()
        assert srv.commits_total == 4
        assert reg.counter("netps.mesh.folds").value == 3
        assert span_count(reg.snapshot(), "netps.server.commit") == 1
    finally:
        srv.close()
        telemetry.reset()


def test_mesh_advert_refused_across_process_boundary(monkeypatch):
    """An advertisement whose ``proc`` is not this process is ignored: the
    client stays on the ring the same join negotiated."""
    srv = server()
    try:
        monkeypatch.setattr(
            client_mod, "_mesh",
            types.SimpleNamespace(local_mesh_id=lambda: "torch:other:0",
                                  dispatch=_mesh.dispatch))
        c = PSClient(srv.endpoint, worker_id=0, transport="mesh", **FAST)
        try:
            _, upd = c.join(init=leaves())
            assert c.mesh_info is None
            assert c.active_transport == "shm"
            assert c.commit([np.ones_like(a) for a in leaves()],
                            upd).applied
        finally:
            c.close()
    finally:
        srv.close()


@pytest.mark.filterwarnings("ignore:measured-bad knob combination")
def test_cross_package_mesh_adverts_land_on_the_ring_without_demotion():
    """A torch runtime and a JAX runtime in one process share no device
    buffers: the port's ``torch:`` token never matches the JAX client's
    check, nor the JAX token the port client's. Each lands on the ring the
    join negotiated, with no wasted demotion."""
    from distkeras_tpu import telemetry as jax_telemetry

    telemetry.reset()
    jax_telemetry.reset()
    jsrv = JaxPSServer(discipline="adag", transport="mesh").start()
    tsrv = server()
    try:
        for client_cls, srv in ((PSClient, jsrv), (JaxPSClient, tsrv)):
            c = client_cls(srv.endpoint, worker_id=0, transport="mesh",
                           **FAST)
            try:
                _, upd = c.join(init=leaves())
                assert c.mesh_info is None and c.shm_info is not None
                assert c.active_transport == "shm"
                assert c.commit([np.ones_like(a) for a in leaves()],
                                upd).applied
            finally:
                c.close()
        assert len(jsrv.commit_log) == len(tsrv.commit_log) == 1
    finally:
        jsrv.close()
        tsrv.close()
    for reg in (telemetry.get(), jax_telemetry.get()):
        assert reg.counter("netps.mesh.demotions").value == 0
        assert reg.counter("netps.mesh.upgrades").value == 0
    telemetry.reset()
    jax_telemetry.reset()


# ---------------------------------------------------------------------------
# The fold: the port's MeshFolder against the JAX package's
# ---------------------------------------------------------------------------

def _commits(codec, center, rng, n=3):
    """``n`` wire-form commits of ``codec`` shaped like ``center``."""
    out = []
    for _ in range(n):
        entries = []
        for a in center:
            d = rng.normal(scale=0.2, size=a.shape).astype(np.float32)
            if codec == "none":
                entries.append(d)
            else:
                q, spec = wire.codec_encode(d, codec)
                entries.append((q, spec))
        out.append(entries)
    return out


def _oracle(center, commits, scale):
    ref = [a.copy() for a in center]
    for entries in commits:
        for r, e in zip(ref, entries):
            if isinstance(e, tuple):
                fold_compressed_numpy(r, e[0], e[1], scale)
            else:
                r += np.float32(scale) * e
    return ref


@pytest.mark.parametrize("codec", CODECS)
def test_port_mesh_folder_is_the_jax_exact_folder_bit_for_bit(codec):
    rng = np.random.default_rng(11)
    center = [rng.normal(size=(16, 4)).astype(np.float32),
              rng.normal(size=(8,)).astype(np.float32),
              rng.normal(size=(3, 5)).astype(np.float32)]
    commits = _commits(codec, center, rng)
    scale = 0.25
    ours = _mesh.MeshFolder([a.copy() for a in center], device="cpu")
    theirs = jax_mesh.MeshFolder([a.copy() for a in center])
    try:
        for entries in commits:
            ours.fold(entries, scale)
            theirs.fold(entries, scale)
        assert ours.folds == theirs.folds == len(commits)
        for i, (a, b, c) in enumerate(zip(ours.center_host(),
                                          theirs.center_host(),
                                          _oracle(center, commits, scale))):
            assert a.tobytes() == b.tobytes() == c.tobytes(), \
                f"tensor {i} diverged under codec {codec!r}"
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("codec", CODECS)
def test_port_mesh_folder_within_the_jax_traced_fold(codec):
    """The JAX folder's fused formulation runs ``fold_traced`` (the Pallas
    fold kernel, in interpret mode) inside its collective: the port's fold
    lies within that test's own bar of it."""
    rng = np.random.default_rng(12)
    center = [rng.normal(size=(16, 4)).astype(np.float32),
              rng.normal(size=(8,)).astype(np.float32)]
    commits = _commits(codec, center, rng)
    ours = _mesh.MeshFolder([a.copy() for a in center], device="cpu")
    theirs = jax_mesh.MeshFolder([a.copy() for a in center], interpret=True)
    try:
        for entries in commits:
            ours.fold(entries, 0.25)
            theirs.fold(entries, 0.25)
        for i, (a, b) in enumerate(zip(ours.center_host(),
                                       theirs.center_host())):
            np.testing.assert_allclose(
                a, b, rtol=1e-6, atol=1e-7,
                err_msg=f"tensor {i} diverged under codec {codec!r}")
    finally:
        ours.close()
        theirs.close()


def _two_virtual_devices(monkeypatch):
    """The JAX folder lays its center over every ``jax.devices()``: two of
    the conftest's eight here."""
    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices[:2])


@pytest.mark.parametrize("codec", CODECS)
def test_mesh_folder_over_two_devices_is_bit_equal(codec, monkeypatch):
    """``devices=["cpu", "cpu"]``: the tensors whose length two divides
    split along axis 0 (one plain fold a device), the others replicate;
    the center is bit-equal to the one-device folder's, to the JAX
    ``MeshFolder``'s on two virtual devices and to the numpy oracle."""
    _two_virtual_devices(monkeypatch)
    rng = np.random.default_rng(13)
    center = [rng.normal(size=(16, 4)).astype(np.float32),
              rng.normal(size=(8,)).astype(np.float32),
              rng.normal(size=(3, 5)).astype(np.float32)]
    commits = _commits(codec, center, rng)
    two = _mesh.MeshFolder([a.copy() for a in center],
                           devices=["cpu", "cpu"])
    one = _mesh.MeshFolder([a.copy() for a in center], device="cpu")
    theirs = jax_mesh.MeshFolder([a.copy() for a in center])
    assert theirs.num_devices == two.num_devices == 2
    assert [any(s) for s in two._specs] == [True, True, False]
    assert [any(a is not None for a in s) for s in theirs._specs] == \
        [True, True, False]
    assert [v.shape for v in two._seats[1].views] == [(8, 4), (4,), (3, 5)]
    try:
        for entries in commits:
            two.fold(entries, 0.25)
            one.fold(entries, 0.25)
            theirs.fold(entries, 0.25)
        for i, (a, b, c, d) in enumerate(zip(
                two.center_host(), one.center_host(), theirs.center_host(),
                _oracle(center, commits, 0.25))):
            assert a.tobytes() == b.tobytes() == c.tobytes() == d.tobytes(), \
                f"tensor {i} diverged under codec {codec!r}"
        assert two.folds == len(commits)
    finally:
        for f in (two, one, theirs):
            f.close()


def test_mesh_folder_takes_the_plan_as_its_layout(monkeypatch):
    """``PartitionPlan.to_partition_specs`` gives the JAX plan's specs
    (one exact-match rule a tensor, row-split tensors over the ``fold``
    axis), and a folder built with the plan splits exactly those tensors
    and folds bit-equal to numpy; a split commit of the wrong size fails
    the conservation check with nothing folded."""
    from distkeras_tpu.netps.shards.plan import PartitionPlan as JaxPlan
    from distkeras_tpu_torch.netps.shards.plan import SPLIT, PartitionPlan

    _two_virtual_devices(monkeypatch)
    rng = np.random.default_rng(3)
    center = [rng.normal(size=(8, 3)).astype(np.float32),
              rng.normal(size=(6,)).astype(np.float32)]
    args = (["big", "small"], [(8, 3), (6,)], 2)
    plan = PartitionPlan.build(*args, rules=[("^big$", SPLIT)])
    jplan = JaxPlan.build(*args, rules=[("^big$", SPLIT)])
    ours = plan.to_partition_specs()
    theirs = jplan.to_partition_specs()
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    assert [tuple(s) for _, s in ours] == [tuple(s) for _, s in theirs]
    folder = _mesh.MeshFolder([a.copy() for a in center],
                              devices=["cpu", "cpu"], plan=plan)
    jfolder = jax_mesh.MeshFolder([a.copy() for a in center], plan=jplan)
    try:
        assert [any(s) for s in folder._specs] == [True, False]
        delta = [rng.normal(scale=0.1, size=a.shape).astype(np.float32)
                 for a in center]
        with pytest.raises(RuntimeError, match="conservation"):
            folder.fold([delta[0][:6], delta[1]], 0.5)
        folder.fold(delta, 0.5)
        jfolder.fold(delta, 0.5)
        want = [c + np.float32(0.5) * d for c, d in zip(center, delta)]
        for a, b, c in zip(folder.center_host(), jfolder.center_host(),
                           want):
            assert a.tobytes() == b.tobytes() == c.tobytes()
        assert folder.folds == 1
    finally:
        folder.close()
        jfolder.close()


def test_mesh_folder_conservation_check_and_refusals(monkeypatch):
    center = leaves()
    folder = _mesh.MeshFolder(center, device="cpu")
    assert folder.backend == "cpu"
    with pytest.raises(ValueError, match="tensors"):
        folder.fold([np.ones(12, np.float32)], 1.0)
    short = [np.ones(12, np.float32), np.ones(7, np.float32)]
    with pytest.raises(RuntimeError, match="conservation"):
        folder.fold(short, 1.0)
    for a, b in zip(folder.center_host(), center):  # untouched
        assert a.tobytes() == b.tobytes()
    assert folder.folds == 0
    # The same check guards every server's fold, whatever its dialect.
    views = [torch.from_numpy(a.copy()) for a in center]
    with pytest.raises(RuntimeError, match="conservation"):
        nfold.fold_delta(views, short, "adag", 0)
    for a, b in zip(views, center):
        assert a.numpy().tobytes() == b.tobytes()
    launched = F.launch_counts()
    folder.fold([np.ones_like(a) for a in center], 1.0)
    assert F.launch_counts() == launched  # CPU tensors: the plain twin
    host = folder.center_host()
    assert not host[0].flags.writeable
    np.testing.assert_array_equal(host[1], center[1] + 1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not _mesh.mesh_available()
    assert _mesh.mesh_available("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _mesh.MeshFolder(center)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSServer(transport="mesh")


def test_a_fold_that_fails_raises_and_never_folds_on_the_host(monkeypatch):
    """The reference server demotes to a host fold when its device fold
    fails; the port's center is on its device in every dialect, so the
    failure reaches the committer and nothing is folded."""
    srv = server()
    c = PSClient(srv.endpoint, worker_id=0, transport="mesh", **FAST)
    try:
        _, upd = c.join(init=leaves())
        before = srv.center()

        def broken(*_a, **_k):
            raise RuntimeError("synthetic launch failure")

        monkeypatch.setattr(nfold, "fold_commit_", broken)
        with pytest.raises(RuntimeError, match="synthetic launch failure"):
            c.commit([np.ones_like(a) for a in leaves()], upd)
        assert srv.commit_log == [] and srv.commits_total == 0
        for a, b in zip(srv.center(), before):
            assert a.tobytes() == b.tobytes()
    finally:
        c.close()
        srv.close()


# ---------------------------------------------------------------------------
# Parity across dialects, demotion
# ---------------------------------------------------------------------------

@pytest.mark.filterwarnings("ignore:measured-bad knob combination")
@pytest.mark.parametrize("compress", CODECS)
def test_mesh_parity_bit_identical_across_codecs(compress):
    ref_srv = server(transport="tcp")
    mesh_srv = server()
    try:
        rc, ref_center, _ = drive_commits(ref_srv.endpoint, 8,
                                          compress=compress, transport="tcp")
        rc.close()
        mc, mesh_center, _ = drive_commits(mesh_srv.endpoint, 8,
                                           compress=compress,
                                           transport="mesh")
        try:
            assert mc.active_transport == "mesh"
        finally:
            mc.close()
        assert mesh_srv.commits_total == ref_srv.commits_total == 8
        for a, b in zip(ref_srv.center(), mesh_srv.center()):
            assert a.tobytes() == b.tobytes()
        for a, b in zip(ref_center, mesh_center):
            assert a.tobytes() == b.tobytes()
    finally:
        mesh_srv.close()
        ref_srv.close()


def test_unregistered_token_demotes_midrun_exactly_once():
    """The "server closed" drill: the token is unregistered after commit 4
    (what ``close`` does first); the next RPC's dispatch raises
    ``ConnectionError``, the client sweeps the dialect (ONE strike) and
    the same RPC lands on the ring. Every commit folds once and the center
    equals a TCP run's, bit for bit."""
    n = 8
    ref_srv = server(transport="tcp")
    try:
        rc, _, _ = drive_commits(ref_srv.endpoint, n, transport="tcp")
        rc.close()
        ref = ref_srv.center()
    finally:
        ref_srv.close()
    telemetry.reset()
    srv = server()

    def after(i):
        if i == 3:
            _mesh.unregister(srv._mesh_token)

    try:
        c, center, _ = drive_commits(srv.endpoint, n, transport="mesh",
                                     after=after)
        try:
            assert c.mesh_info is None
            assert c.active_transport == "shm"
        finally:
            c.close()
        assert srv.commits_total == n
        assert [s for _w, s, _t in srv.commit_log] == list(range(n))
        for a, b in zip(ref, srv.center()):
            assert a.tobytes() == b.tobytes()
        for a, b in zip(ref, center):
            assert a.tobytes() == b.tobytes()
        reg = telemetry.get()
        assert reg.counter("netps.mesh.demotions").value == 1
        # Commits 0..3 came through the dispatch, the rest over the ring.
        assert reg.counter("netps.mesh.folds").value == 4
        snap = reg.snapshot()
        assert span_count(snap, "netps.server.commit.mesh") == 4
        assert span_count(snap, "netps.server.commit.shm") == n - 4
        whys = [e["why"] for e in reg.events()
                if e["kind"] == "netps_mesh_demotion"]
        assert len(whys) == 1 and "ConnectionError" in whys[0]
    finally:
        srv.close()
        telemetry.reset()


def test_mesh_knob_combos_warn_once_per_process():
    _BAD_KNOB_COMBOS_WARNED.clear()
    telemetry.reset()
    with pytest.warns(RuntimeWarning, match="int8\\+mesh"):
        _validate_knob_combo("int8", "mesh")
    with pytest.warns(RuntimeWarning, match="int8\\+shm"):
        _validate_knob_combo("int8", "shm")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _validate_knob_combo("int8", "mesh")  # once per process: silent
        _validate_knob_combo("none", "mesh")
        _validate_knob_combo("bf16", "mesh")
        _validate_knob_combo("int8", "tcp")
    reg = telemetry.get()
    assert reg.counter("tuner.knob_warnings").value == 2
    combos = [e["combo"] for e in reg.events()
              if e["kind"] == "netps_knob_warning"]
    assert combos == ["int8+mesh", "int8+shm"]
    _BAD_KNOB_COMBOS_WARNED.clear()
    telemetry.reset()


# ---------------------------------------------------------------------------
# A config #8-shaped transformer under run_remote, over each transport
# ---------------------------------------------------------------------------

LM = dict(vocab_size=256, num_layers=2, d_model=64, num_heads=2, d_ff=128,
          max_seq_len=32)
LM_L, LM_BATCH, LM_WINDOW, LM_ROUNDS = 32, 2, 2, 3
TRANSPORTS = ("tcp", "shm", "mesh")


@pytest.fixture(scope="module")
def lm_setup():
    """The JAX model (dense attention) and one jitted local loop shared by
    every JAX run, the token frame as ``bench.py`` makes config #8's."""
    import optax

    from distkeras_tpu.ops.losses import get_loss
    from distkeras_tpu.workers import make_local_loop

    jm = _jax_lm()
    tx = optax.sgd(0.05)
    loss_fn = get_loss("sparse_categorical_crossentropy")
    loop = jax.jit(make_local_loop(jm.module, loss_fn, tx))
    return dict(jm=jm, tx=tx, loss_fn=loss_fn, loop=loop, cols=_lm_cols())


def _port_lm_run(setup, transport, optimizer="sgd", lr=0.05):
    from distkeras_tpu_torch import small_transformer_lm
    from distkeras_tpu_torch.convert import params_from_jax
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.data.batching import make_batches
    from distkeras_tpu_torch.netps.remote import run_remote
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    pm = small_transformer_lm(**LM, attn_impl="dense", seq_len=LM_L,
                              device="cpu")
    pm.module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, setup["jm"].params), pm.module))
    plan = make_batches(DataFrame(setup["cols"]), "features", "label",
                        LM_BATCH, num_workers=1, window=LM_WINDOW)
    srv = server(transport=transport, discipline="aeasgd")
    try:
        params, losses = run_remote(
            endpoint=srv.endpoint, model=pm,
            tx=get_optimizer(optimizer, lr),
            loss_fn=get_loss("sparse_categorical_crossentropy"), plan=plan,
            discipline="aeasgd", window=LM_WINDOW, alpha=0.05, inflight=1,
            transport=transport, compress="none")
        assert [s for _w, s, _t in srv.commit_log] == list(range(LM_ROUNDS))
        for p, c in zip(params.values(), srv.center()):
            assert p.numpy().tobytes() == c.tobytes()
    finally:
        srv.close()
    assert np.isfinite(losses).all()
    return pm, params


def test_config8_shaped_run_is_bit_identical_across_transports():
    """Config #8's optimizer (adam) through each dialect: one center."""
    setup = {"jm": _jax_lm(), "cols": _lm_cols()}
    centers = {t: _port_lm_run(setup, t, "adam", 1e-4)[1]
               for t in TRANSPORTS}
    for t in TRANSPORTS[1:]:
        for k, v in centers["tcp"].items():
            assert v.numpy().tobytes() == centers[t][k].numpy().tobytes(), \
                (t, k)


def _jax_lm():
    import jax.numpy as jnp

    from distkeras_tpu.models.base import Model as JaxModel
    from distkeras_tpu.models.transformer import TransformerLM as JaxLM

    return JaxModel.build(JaxLM(**LM, attn_impl="dense"),
                          jnp.zeros((1, 1), jnp.int32), seed=3)


def _lm_cols():
    rng = np.random.default_rng(8)
    toks = rng.integers(0, LM["vocab_size"],
                        (LM_ROUNDS * LM_WINDOW * LM_BATCH, LM_L))
    return {"features": toks.astype(np.int32),
            "label": np.roll(toks, -1, 1).astype(np.int32)}


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_config8_shaped_run_matches_jax_over_the_same_transport(lm_setup,
                                                                 transport):
    from distkeras_tpu.data.batching import make_batches as jax_batches
    from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
    from distkeras_tpu.netps.remote import run_remote as jax_run_remote
    from distkeras_tpu_torch.convert import params_from_jax

    pm, params = _port_lm_run(lm_setup, transport)
    plan = jax_batches(JaxDataFrame(lm_setup["cols"]), "features", "label",
                       batch_size=LM_BATCH, num_workers=1, window=LM_WINDOW)
    jsrv = JaxPSServer(discipline="aeasgd", transport=transport).start()
    try:
        jparams, _ = jax_run_remote(
            endpoint=jsrv.endpoint, model=lm_setup["jm"], tx=lm_setup["tx"],
            loss_fn=lm_setup["loss_fn"], plan=plan, discipline="aeasgd",
            window=LM_WINDOW, alpha=0.05, inflight=1, shards=1,
            compress="none", transport=transport, loop_fn=lm_setup["loop"])
        assert len(jsrv.commit_log) == LM_ROUNDS
    finally:
        jsrv.close()
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                          pm.module)
    init = pm.module.state_dict()
    moved = max((params[k] - init[k]).abs().max().item() for k in ref)
    assert moved > 0
    worst = max((params[k] - v).abs().max().item() for k, v in ref.items())
    assert worst <= 1e-5, (worst, moved)
