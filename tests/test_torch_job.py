"""The port's job deployment (``distkeras_tpu_torch/job_deployment.py``)
against the JAX package's: the same cards render the same launch lines
with ``torch.distributed``'s rendezvous (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK=0``) in place of the ``JAX_*``
coordinator variables and the port's netps CLI in place of the JAX
package's; and real localhost launches through ``Job``: two ranks of
``SynchronousDistributedTrainer`` (``tests/torch_job_worker.py``, one
thread each, gloo), equal to each other and within rtol = atol = 1e-5 of
the JAX trainer in process (``tests/test_torch_sync.py``'s limit), and a
card with a parameter server that launches ``python -m
distkeras_tpu_torch.netps --device cpu`` for two DynSGD workers whose
commits fold exactly once."""

import json
import os
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import distkeras_tpu as dk
from distkeras_tpu.data.dataframe import DataFrame as JaxDataFrame
from distkeras_tpu.job_deployment import Job as JaxJob
from distkeras_tpu.job_deployment import Punchcard as JaxPunchcard
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.mlp import MLP as JaxMLP
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.job_deployment import Job, Punchcard

import torch_rank_workers as RW

_WORKER = os.path.join(os.path.dirname(__file__), "torch_job_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TORCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "LOCAL_RANK")
_JAX_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
             "JAX_PROCESS_ID")


def _env(cmd: str) -> dict:
    words = shlex.split(cmd)
    assert words[0] == "env"
    env = {}
    for w in words[1:]:
        if "=" not in w:
            break
        k, v = w.split("=", 1)
        env[k] = v
    return env


def _tail(cmd: str) -> list:
    words = shlex.split(cmd)
    return words[words.index("python"):]


def test_punchcard_roundtrip_and_job_render():
    """The counterpart of ``tests/test_datasets_jobs.py``'s render case."""
    kw = dict(job_name="train", script="train.py",
              hosts=["10.0.0.1", "10.0.0.2"], env={"FOO": "bar"},
              args=["--epochs", "3"], coordinator_port=8476)
    pc = Punchcard(**kw)
    assert Punchcard.from_json(pc.to_json()).hosts == ["10.0.0.1", "10.0.0.2"]
    assert json.loads(pc.to_json()) == json.loads(JaxPunchcard(**kw).to_json())
    cmds = Job(pc).launch(dry_run=True)
    ref = JaxJob(JaxPunchcard(**kw)).launch(dry_run=True)
    assert len(cmds) == 2
    assert "MASTER_ADDR=10.0.0.1" in cmds[0] and "MASTER_PORT=8476" in cmds[0]
    assert "RANK=0" in cmds[0] and "RANK=1" in cmds[1]
    assert "WORLD_SIZE=2" in cmds[1] and "LOCAL_RANK=0" in cmds[1]
    assert "FOO=bar" in cmds[0] and "--epochs 3" in cmds[0]
    for mine, theirs in zip(cmds, ref):
        got, want = _env(mine), _env(theirs)
        assert not set(_JAX_VARS) & set(got)
        assert {k: v for k, v in got.items() if k not in _TORCH_VARS} == {
            k: v for k, v in want.items() if k not in _JAX_VARS}
        assert _tail(mine) == _tail(theirs)
    i = 1
    assert (_env(cmds[i])["MASTER_ADDR"], _env(cmds[i])["MASTER_PORT"],
            _env(cmds[i])["WORLD_SIZE"], _env(cmds[i])["RANK"]) == (
        *_env(ref[i])["JAX_COORDINATOR_ADDRESS"].split(":"),
        _env(ref[i])["JAX_NUM_PROCESSES"], _env(ref[i])["JAX_PROCESS_ID"])


@pytest.mark.parametrize("ps", [
    {"port": 7077, "discipline": "dynsgd", "lease": 5.0},
    {"port": 7077, "standby_host": "10.0.0.2", "standby_port": 7078,
     "state_dir": "/ckpt/ps", "snapshot_every": 4},
    {"shards": 2, "shard_ports": [7001, 7002], "state_dir": "/s",
     "standby_host": "h2", "standby_ports": [7101, 7102]},
])
def test_ps_plane_lines_are_the_reference_s_with_the_port_s_cli(ps):
    kw = dict(job_name="j", script="t.py", hosts=["10.0.0.1", "10.0.0.2"],
              coordinator_port=8476)
    mine = Job(Punchcard(**kw, ps=dict(ps)))
    ref = JaxJob(JaxPunchcard(**kw, ps=dict(ps)))
    swap = ("distkeras_tpu.netps", "distkeras_tpu_torch.netps")
    assert mine.render_ps_commands() == [
        c.replace(*swap) for c in ref.render_ps_commands()]
    assert mine.render_standby_commands() == [
        c.replace(*swap) for c in ref.render_standby_commands()]
    for a, b in zip(mine.render_commands(), ref.render_commands()):
        assert _env(a)["DKTPU_PS_ENDPOINT"] == _env(b)["DKTPU_PS_ENDPOINT"]


def test_a_ps_device_renders_the_cli_s_device_flag():
    pc = Punchcard(job_name="j", script="t.py", hosts=["localhost"],
                   coordinator_port=8476,
                   ps={"port": 7077, "device": "cpu",
                       "standby_host": "localhost", "standby_port": 7078})
    job = Job(pc)
    assert "--device cpu" in job.render_ps_command()
    assert "--device cpu" in job.render_standby_command()
    assert job.render_ps_command().startswith(
        "python -m distkeras_tpu_torch.netps ")


def test_tree_lines_go_through_the_port_s_placement():
    pc = Punchcard(job_name="j", script="t.py",
                   hosts=[f"h{i}" for i in range(4)], coordinator_port=8476,
                   ps={"port": 7077, "tree": "host:2"})
    job = Job(pc)
    cmds = job.render_tree_commands()
    plan = pc.tree_plan()
    assert cmds and all(c.startswith("python -m distkeras_tpu_torch.netps ")
                        for c in cmds)
    assert len(cmds) == sum(1 + (n.standby_host is not None) for n in plan)
    workers = job.render_commands()
    for i, c in enumerate(workers):
        assert _env(c)["DKTPU_PS_ENDPOINT"] == plan.leaf_endpoint(i)
        assert _env(c)["DKTPU_TREE_SPEC"] == "host:2"
    pc.release_ports()


def _jax_sync(jm, rows):
    t = dk.SynchronousDistributedTrainer(
        jm, worker_optimizer="sgd", loss="sparse_categorical_crossentropy",
        batch_size=4, steps_per_program=2, learning_rate=0.1, num_workers=2)
    out = t.train(JaxDataFrame(RW.columns("mlp", rows)))
    return out, np.asarray(t.get_history())


def _launch(tmp_path, env, ps=None, timeout=240):
    card = Punchcard(job_name="pytest-torch-job", script=_WORKER,
                     hosts=["localhost", "localhost"],
                     coordinator_port=RW.free_port(), ps=ps,
                     env={"PYTHONPATH": _REPO, "DK_OUT": str(tmp_path),
                          "JAX_PLATFORMS": "cpu", **env})
    job = Job(card)
    job.launch(dry_run=False)
    return job, job.supervise(timeout=timeout)


def test_two_ranks_launched_by_job_train_sync_as_jax(tmp_path):
    jm = JaxModel.build(JaxMLP(**RW.MLP_CFG),
                        jnp.zeros((1, 784), jnp.float32), seed=1)
    module = RW.build_model("mlp").module
    init = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), module).items()}
    np.savez(tmp_path / "init.npz", **init)
    job, rcs = _launch(tmp_path, {"DK_MODE": "sync",
                                  "DK_INIT": str(tmp_path / "init.npz")})
    assert rcs == [0, 0], rcs
    procs = [dict(np.load(tmp_path / f"proc{r}.npz")) for r in range(2)]
    hists = [json.loads((tmp_path / f"proc{r}.json").read_text())
             for r in range(2)]
    assert [h["world"] for h in hists] == [2, 2]
    for k in procs[0]:
        np.testing.assert_array_equal(procs[0][k], procs[1][k], err_msg=k)
    assert hists[0]["history"] == hists[1]["history"]
    jout, jhist = _jax_sync(jm, 2 * 2 * 4 * 2)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jout.params),
                          module)
    for k, v in ref.items():
        np.testing.assert_allclose(procs[0][k], v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(hists[0]["history"], jhist, rtol=1e-5,
                               atol=1e-5)


def test_a_ps_card_folds_two_dynsgd_workers_exactly_once(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("PYTHONPATH", _REPO)  # the PS process's
    rounds = 3
    # the workers' join retries outlast the server's start under load
    job, rcs = _launch(tmp_path, {"DK_MODE": "ps", "DK_ROUNDS": str(rounds),
                                  "DKTPU_NET_RETRIES": "12",
                                  "DKTPU_NET_BACKOFF": "0.5"},
                       ps={"discipline": "dynsgd", "device": "cpu"})
    assert rcs == [0, 0], rcs
    assert "--device cpu" in job.render_ps_command()
    assert "--discipline dynsgd" in job.render_ps_command()
    rep = [json.loads((tmp_path / f"proc{r}.json").read_text())
           for r in range(2)]
    for r in rep:
        assert r["results"] == [[True, False, False]] * rounds
    assert rep[0]["before"] == {"updates": 2 * rounds,
                                "commits_total": 2 * rounds}
    assert rep[0]["retransmit"] == [False, True]  # a duplicate: no fold
    assert rep[0]["after"] == rep[0]["before"]
    assert rep[0]["fold_backend"] == "torch-cpu"
    assert job._ps_proc is not None and job._ps_proc.poll() is not None
