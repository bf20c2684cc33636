"""Checkpoint and resume in the port (``checkpoint.py``,
``resilience/integrity.py``, the run harness of ``trainers.py``): a
checkpointed and resumed run of each ported trainer is bit-equal to its
uninterrupted run and within 1e-5 of the JAX package's resumed run (f32,
the same sums in another order); the decline rule, a fresh run into a
non-empty directory, the sync resize, and the fallback past a corrupt or
sidecar-less newest step, as the JAX package's tests hold them."""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as dk
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.mlp import MLP as JaxMLP
from distkeras_tpu_torch import DataFrame, telemetry
from distkeras_tpu_torch import trainers as T
from distkeras_tpu_torch.checkpoint import (
    Checkpointer,
    latest_step,
    resume_candidates,
    scan_steps,
)
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models.base import Model
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.parallel.disciplines import EnsembleFold
from distkeras_tpu_torch.parallel.engine import EngineState
from distkeras_tpu_torch.resilience import integrity
from distkeras_tpu_torch.resilience.errors import CheckpointCorruptError

D, C = 4, 3


def _jax_model(seed=0):
    return JaxModel.build(JaxMLP(hidden=(8,), num_outputs=C),
                          jnp.zeros((1, D), jnp.float32), seed=seed)


def _port_model(seed=0):
    """The port's MLP on the CPU with the JAX model's weights."""
    jm = _jax_model(seed)
    module = MLP(hidden=(8,), num_outputs=C, in_features=D)
    module.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), module))
    return Model.build(module, np.zeros((1, D), np.float32), device="cpu")


def _columns(n=256):
    rng = np.random.default_rng(0)
    return {"features": rng.normal(size=(n, D)).astype(np.float32),
            "label": rng.integers(0, C, size=n).astype(np.int32)}


COMMON = dict(loss="sparse_categorical_crossentropy", batch_size=8,
              learning_rate=0.05, num_workers=4)
TRAINERS = {
    "DOWNPOUR": dict(communication_window=2),
    "ADAG": dict(communication_window=2),
    "DynSGD": dict(communication_window=2),
    "AEASGD": dict(communication_window=2),
    "SynchronousDistributedTrainer": dict(steps_per_program=2),
}


def _counter(name):
    return telemetry.get().snapshot()["counters"].get(name, 0.0)


@pytest.mark.parametrize("name", list(TRAINERS))
def test_checkpoint_resume_matches_uninterrupted(tmp_path, name):
    """4 epochs straight vs 2 epochs + checkpoint + resume: the resumed run
    runs only the second half and lands on the uninterrupted run's weights
    bit for bit; the JAX package's resumed run within 1e-5."""
    cols = _columns()
    kw = dict(COMMON, **TRAINERS[name])
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    full_t = getattr(T, name)(_port_model(), num_epoch=4, **kw)
    full = full_t.train(DataFrame(cols))
    first = getattr(T, name)(_port_model(), num_epoch=2, checkpoint_dir=ck,
                             checkpoint_every=1, **kw)
    first.train(DataFrame(cols))
    resumed_t = getattr(T, name)(_port_model(), num_epoch=4,
                                 checkpoint_dir=ck, checkpoint_every=1,
                                 resume=True, **kw)
    resumed = resumed_t.train(DataFrame(cols))
    assert len(resumed_t.get_history()) == (len(full_t.get_history())
                                            - len(first.get_history())) > 0
    for k, v in full.params.items():
        assert torch.equal(resumed.params[k], v), k
    np.testing.assert_array_equal(
        resumed_t.get_history(),
        full_t.get_history()[len(first.get_history()):])

    getattr(dk, name)(_jax_model(), num_epoch=2, checkpoint_dir=jck,
                      checkpoint_every=1, **kw).train(dk.DataFrame(cols))
    jt = getattr(dk, name)(_jax_model(), num_epoch=4, checkpoint_dir=jck,
                           checkpoint_every=1, resume=True, **kw)
    jm = jt.train(dk.DataFrame(cols))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                           resumed.module)
    for k, v in want.items():
        np.testing.assert_allclose(resumed.params[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(resumed_t.get_history(), jt.get_history(),
                               rtol=1e-5, atol=1e-5)


def test_checkpointer_save_decline_signals(tmp_path):
    """A save at step <= latest_step is declined: False, a warning, and no
    stale meta sidecar."""
    ck = Checkpointer(str(tmp_path / "ck"))
    state = {"w": torch.arange(4, dtype=torch.float32)}
    assert ck.save(5, state, meta={"round": 5}) is True
    with pytest.warns(UserWarning, match="declined"):
        assert ck.save(3, state, meta={"round": 3}) is False
    with pytest.warns(UserWarning, match="declined"):
        assert ck.save(5, state) is False
    assert ck.latest_step() == 5 and ck.all_steps() == [5]
    assert ck.meta(3) is None  # no sidecar for the unwritten step
    assert ck.meta(5) == {"round": 5}


def test_fresh_run_into_nonempty_checkpoint_dir_still_saves(tmp_path):
    """resume=False into a dir holding prior checkpoints: rounds restart at
    0 but saves are not declined (steps offset past the existing ones)."""
    cols = _columns()
    ck = str(tmp_path / "ck")
    common = dict(COMMON, num_epoch=2, communication_window=2,
                  checkpoint_dir=ck, checkpoint_every=2)
    T.DOWNPOUR(_port_model(), **common).train(DataFrame(cols))
    first_latest = Checkpointer(ck).latest_step()
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        T.DOWNPOUR(_port_model(), **common).train(DataFrame(cols))
    reader = Checkpointer(ck)
    assert reader.latest_step() > first_latest
    assert reader.meta(reader.latest_step())["round"] == 7


def test_sync_resume_resized_rescales_data_progress(tmp_path):
    """The sync engine's state does not depend on W, so a resized resume
    restores exactly, and data progress rescales (with a warning)."""
    cols = _columns()
    common = dict(loss="sparse_categorical_crossentropy", batch_size=8,
                  learning_rate=0.05, checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_every=1, steps_per_program=2)
    t1 = T.SynchronousDistributedTrainer(_port_model(), num_workers=4,
                                         num_epoch=2, **common)
    t1.train(DataFrame(cols))
    assert len(t1.get_history()) == 8
    with pytest.warns(UserWarning, match="rescaled"):
        t2 = T.SynchronousDistributedTrainer(
            _port_model(), num_workers=2, num_epoch=4, resume=True, **common)
        t2.train(DataFrame(cols))
    assert len(t2.get_history()) == 32 - 16


@pytest.mark.parametrize("saved_w,resumed_w", [(8, 4), (4, 8)])
def test_async_resize_resumes_as_the_jax_package(tmp_path, saved_w,
                                                 resumed_w):
    """An async engine's checkpoint resumed at another W (the elastic
    re-topology, ``host_state``/``adopt_state``): every worker re-joins
    from the restored center with a fresh optimizer, the fold state and
    rng carry over, data progress rescales, and the run lands within 1e-5
    of the JAX package's resized resume."""
    cols = _columns(512)
    kw = dict(COMMON, communication_window=2, checkpoint_every=2)
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "jck")
    for pkg, d in ((T, ck), (dk, jck)):
        model = _port_model() if pkg is T else _jax_model()
        frame = DataFrame(cols) if pkg is T else dk.DataFrame(cols)
        pkg.DynSGD(model, num_epoch=1, checkpoint_dir=d,
                   **dict(kw, num_workers=saved_w)).train(frame)
    resumed_t = T.DynSGD(_port_model(), num_epoch=2, resume=True,
                         checkpoint_dir=ck, **dict(kw, num_workers=resumed_w))
    resumed = resumed_t.train(DataFrame(cols))
    jt = dk.DynSGD(_jax_model(), num_epoch=2, resume=True, checkpoint_dir=jck,
                   **dict(kw, num_workers=resumed_w))
    jm = jt.train(dk.DataFrame(cols))
    rounds = 2 * 512 // (resumed_w * 2 * 8)
    assert len(resumed_t.get_history()) == rounds // 2
    assert len(jt.get_history()) == rounds // 2
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                           resumed.module)
    for k, v in want.items():
        np.testing.assert_allclose(resumed.params[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(resumed_t.get_history(), jt.get_history(),
                               rtol=1e-5, atol=1e-5)


class _Ensemble(T.AsynchronousDistributedTrainer):
    def _discipline(self):
        return EnsembleFold()


def test_elastic_resume_rejects_a_center_that_is_not_trained(tmp_path):
    cols = _columns()
    common = dict(COMMON, communication_window=2,
                  checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    _Ensemble(_port_model(), num_epoch=1, **common).train(DataFrame(cols))
    common["num_workers"] = 2
    with pytest.raises(ValueError, match="cannot elastically resume"):
        _Ensemble(_port_model(), num_epoch=1, resume=True,
                  **common).train(DataFrame(cols))


NUM_ROUNDS = 4  # 256 rows / (4 workers * window 2 * batch 8)


def _train_with_checkpoints(tmp_path):
    cols = _columns()
    t = T.ADAG(_port_model(), num_epoch=1, communication_window=2,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
               **COMMON)
    t.train(DataFrame(cols), shuffle=True)
    return cols


def test_corrupt_checkpoint_falls_back_to_previous_step(tmp_path):
    cols = _train_with_checkpoints(tmp_path)
    ck = Checkpointer(str(tmp_path / "ck"))
    latest = ck.latest_step()
    assert latest == NUM_ROUNDS - 1
    integrity.corrupt_step_dir(str(tmp_path / "ck" / str(latest)))
    before = _counter("resilience.ckpt_fallback_steps")
    t2 = T.ADAG(_port_model(), num_epoch=1, communication_window=2,
                checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
                resume=True, **COMMON)
    with pytest.warns(UserWarning, match="falling back to the previous"):
        t2.train(DataFrame(cols), shuffle=True)
    assert _counter("resilience.ckpt_fallback_steps") - before >= 1
    # resumed from the previous step (round 2): one round left to run
    assert len(t2.get_history()) == 1
    # the rerun of the last round was saved past the corrupt step
    assert Checkpointer(str(tmp_path / "ck")).latest_step() > latest


def test_missing_meta_sidecar_falls_back_to_intact_step(tmp_path):
    cols = _train_with_checkpoints(tmp_path)
    latest = Checkpointer(str(tmp_path / "ck")).latest_step()
    os.remove(tmp_path / "ck" / "meta" / f"{latest}.json")
    before = _counter("resilience.ckpt_fallback_steps")
    t2 = T.ADAG(_port_model(), num_epoch=1, communication_window=2,
                checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
                resume=True, **COMMON)
    with pytest.warns(UserWarning, match="intact sidecar"):
        t2.train(DataFrame(cols), shuffle=True)
    assert _counter("resilience.ckpt_fallback_steps") - before == 1
    assert len(t2.get_history()) == NUM_ROUNDS - latest


# -- the Checkpointer itself -------------------------------------------------

def _state():
    g = torch.Generator().manual_seed(0)
    center = {"w": torch.randn(3, 4, generator=g),
              "b": torch.randn(4, generator=g)}
    adam = {"count": 3, "mu": {k: torch.ones_like(v)
                               for k, v in center.items()},
            "nu": {k: torch.zeros_like(v) for k, v in center.items()}}
    return EngineState(center, [center] * 2, [((), adam), ((), adam)], 5,
                       1234)


def test_restore_rebuilds_the_target_and_shares_what_was_shared(tmp_path):
    st = _state()
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    assert ck.save(1, st, meta={"round": 1})
    st.center["w"].add_(1.0)  # the save copied: a later edit is not in it
    got = ck.restore(_state(), verify=True)
    assert isinstance(got, EngineState) and got.rng == 1234
    assert got.fold_state == 5 and got.opt_state[0][1]["count"] == 3
    assert isinstance(got.opt_state[0], tuple) and got.opt_state[0][0] == ()
    assert torch.equal(got.center["w"], _state().center["w"])
    assert got.locals_[1]["w"] is got.center["w"]  # one tensor, as saved
    host = ck.restore_host(_state(), step=1)
    assert host.center["w"].device.type == "cpu"


@pytest.mark.parametrize("edit,match", [
    (lambda s: s.center.pop("b"), "not in the target"),
    (lambda s: s.center.update(extra=torch.zeros(1)), "no entry"),
    (lambda s: s.center.update(w=torch.zeros(4, 3)), "checkpoint holds"),
    (lambda s: s.center.update(w=torch.zeros(3, 4, dtype=torch.float64)),
     "checkpoint holds"),
])
def test_restore_refuses_a_target_of_another_structure(tmp_path, edit, match):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state())
    target = _state()
    target = target._replace(center=dict(target.center))
    edit(target)
    with pytest.raises(ValueError, match=match):
        ck.restore(target)


def test_max_to_keep_and_sidecars(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        assert ck.save(s, {"x": torch.full((2,), float(s))},
                       meta={"round": s})
    assert ck.all_steps() == [3, 4] and ck.steps_desc() == [4, 3]
    assert sorted(os.listdir(tmp_path / "meta")) == [
        "3.digest.json", "3.json", "4.digest.json", "4.json"]
    assert ck.digest(4)["algo"] == "sha256"
    spans = telemetry.get().snapshot()["spans"]
    for part in ("", "/copy", "/digest", "/write"):
        assert spans[f"checkpoint.save{part}"]["count"] >= 4
    assert scan_steps(str(tmp_path)) == [4, 3]
    assert latest_step(str(tmp_path)) == 4
    assert resume_candidates([4, 3], lambda s: s == 3) == [3]
    assert resume_candidates([4, 3], lambda s: False) == [4, 3]


def test_digest_off_and_orphans_reaped(tmp_path, monkeypatch):
    os.makedirs(tmp_path / f".7.tmp-{os.getpid()}")
    os.makedirs(tmp_path / ".8.tmp-1")  # a live peer's: kept while young
    monkeypatch.setenv("DKTPU_CKPT_DIGEST", "0")
    ck = Checkpointer(str(tmp_path))
    assert ck.save(9, {"x": torch.zeros(2)}, meta={"round": 9})
    assert ck.digest(9) is None
    names = sorted(os.listdir(tmp_path))
    assert names == [".8.tmp-1", "9", "meta"]
    assert scan_steps(str(tmp_path)) == [9]
    # no sidecar: a verified restore has nothing to hold it to
    assert torch.equal(ck.restore({"x": torch.ones(2)}, verify=True)["x"],
                       torch.zeros(2))


def test_verified_restore_detects_a_flipped_payload(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state())
    before = _counter("resilience.ckpt_corrupt_detected")
    flat = torch.load(tmp_path / "1" / "state.pt", weights_only=True)
    flat["center/w"][0, 0] += 1.0
    torch.save(flat, tmp_path / "1" / "state.pt")
    with pytest.raises(CheckpointCorruptError, match="integrity"):
        ck.restore(_state(), verify=True)
    assert _counter("resilience.ckpt_corrupt_detected") - before == 1
    ck.restore(_state())  # unverified, it loads


def test_tree_digest_detects_tamper():
    tree = {"w": torch.arange(8, dtype=torch.float32), "b": np.zeros(3),
            "n": 3}
    digest = integrity.tree_digest(tree)
    assert digest["leaves"] == 3
    assert integrity.matches(tree, digest)
    assert integrity.matches({"n": 3, "b": np.zeros(3), "w": tree["w"]},
                             digest)  # dict keys are sorted
    tampered = dict(tree, w=tree["w"].clone())
    tampered["w"][3] += 1e-3
    assert not integrity.matches(tampered, digest)
    assert not integrity.matches(dict(tree, w=tree["w"].double()), digest)
    assert not integrity.matches(dict(tree, w=tree["w"].reshape(2, 4)),
                                 digest)
    bf = {"w": tree["w"].to(torch.bfloat16)}
    assert integrity.matches(bf, integrity.tree_digest(bf))
    assert integrity.matches(tree, None)


def test_tree_digest_hashes_a_shared_tensor_once():
    """A tensor met twice is hashed once and then referenced: the digest
    holds the sharing a checkpoint restores."""
    t = torch.arange(6, dtype=torch.float32)
    shared = {"a": t, "b": t}
    digest = integrity.tree_digest(shared)
    assert digest["leaves"] == 2 and digest["bytes"] == 24
    assert not integrity.matches({"a": t.clone(), "b": t}, digest)
    copies = {"a": t, "b": t.clone()}
    assert integrity.tree_digest(copies)["bytes"] == 48
    assert not integrity.matches(copies, digest)
    u = t.clone()
    assert integrity.matches({"a": u, "b": u}, digest)
