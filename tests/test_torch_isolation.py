"""The port stands alone: ``distkeras_tpu_torch``, ``chip_smoke.py`` and
the card's tests import neither JAX nor the JAX package, and the port's
entry points refuse to fall back to the CPU when no card is there and
none was asked for."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "distkeras_tpu_torch"
#: the card's machine has no msgpack and no orbax either: the port keeps
#: its own msgpack codec (``runtime/msgpack.py``) and checkpoint format
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
             "distkeras_tpu")


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import distkeras_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules "
        "if k.startswith('distkeras_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every submodule was imported


@pytest.mark.parametrize("module", [
    "distkeras_tpu_torch.resilience.faults",
    "distkeras_tpu_torch.resilience.supervisor",
    "distkeras_tpu_torch.netps.chaos"])
def test_resilience_plane_modules_load_no_jax(module):
    code = (f"import sys, {module}\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "distkeras_tpu_torch.netps.shards",
    "distkeras_tpu_torch.netps.shards.plan",
    "distkeras_tpu_torch.netps.shards.client",
    "distkeras_tpu_torch.netps.shards.group"])
def test_shard_plane_modules_load_no_jax(module):
    """The sharded center plane, each module on its own: the plan keeps the
    JAX package's canonical JSON, and its ``to_partition_specs`` (the one
    function there that imports jax) gives the port's own specs, loading
    no JAX either."""
    code = (f"import sys, {module}\n"
            "from distkeras_tpu_torch.netps.shards.plan import "
            "PartitionPlan, SPLIT\n"
            "plan = PartitionPlan.build(['a', 'b'], [(4, 2), (3,)], 2, "
            "rules=[('^a$', SPLIT)])\n"
            "specs = [tuple(s) for _, s in plan.to_partition_specs()]\n"
            "assert specs == [('fold',), ()], specs\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    src = (PKG / "netps" / "shards" / "plan.py").read_text()
    assert "def to_partition_specs" in src


@pytest.mark.parametrize("module", [
    "distkeras_tpu_torch.data.shards",
    "distkeras_tpu_torch.data.native_loader",
    "distkeras_tpu_torch.ops.augment",
    "distkeras_tpu_torch.predictors"])
def test_data_plane_modules_load_no_jax_nor_its_native_library(module):
    """The out-of-core data plane, each module on its own, with the native
    loader built and loaded: no JAX, and the process maps the port's own
    library under ``build/native/``, never the JAX package's
    ``distkeras_tpu/native/_loader.so``."""
    code = (f"import sys, {module}\n"
            "from distkeras_tpu_torch.data import native_loader as n\n"
            "lib = n.get_lib()\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert 'distkeras_tpu/native' not in maps\n"
            "assert str(n.library_path()) in maps, maps\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", [
    "distkeras_tpu_torch.fleet",
    "distkeras_tpu_torch.fleet.job",
    "distkeras_tpu_torch.fleet.scheduler",
    "distkeras_tpu_torch.fleet.placement",
    "distkeras_tpu_torch.fleet.run",
    "distkeras_tpu_torch.sim",
    "distkeras_tpu_torch.sim.core",
    "distkeras_tpu_torch.sim.model",
    "distkeras_tpu_torch.sim.cluster",
    "distkeras_tpu_torch.sim.fleet_driver",
    "distkeras_tpu_torch.sim.calibrate",
    "distkeras_tpu_torch.sim.scenarios",
    "distkeras_tpu_torch.sim.__main__",
    "distkeras_tpu_torch.streaming",
    "distkeras_tpu_torch.streaming.items",
    "distkeras_tpu_torch.streaming.source",
    "distkeras_tpu_torch.streaming.journal",
    "distkeras_tpu_torch.streaming.evaluate",
    "distkeras_tpu_torch.streaming.runtime",
    "distkeras_tpu_torch.racelab",
    "distkeras_tpu_torch.utils",
    "distkeras_tpu_torch.serving.replica"])
def test_fleet_and_sim_modules_load_no_jax(module):
    """The fleet control plane, its simulator, the streaming loop, the
    raced server, the utilities and the replica sets, each module on its
    own."""
    code = (f"import sys, {module}\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 20
    for f in files:
        bad = _imports(f) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_raise_without_a_card(monkeypatch):
    from distkeras_tpu_torch import (
        ElasticTraining,
        TransformerLM,
        imdb_lstm,
        resnet50,
        small_transformer_lm,
    )
    from distkeras_tpu_torch.models import Model
    from distkeras_tpu_torch.serving import (
        ModelRegistry,
        ServingReplicaSet,
        ServingService,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = dict(vocab_size=10, embed_dim=4, hidden_size=4, seq_len=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imdb_lstm(**small)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet50(norm_impl="pallas")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model.build(torch.nn.Linear(2, 2), np.zeros((1, 2), np.float32))
    tiny_lm = dict(vocab_size=16, num_layers=1, d_model=32, num_heads=2,
                   d_ff=32, max_seq_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        small_transformer_lm(**tiny_lm, seq_len=8, attn_impl="flash")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model.build(TransformerLM(**tiny_lm), np.zeros((1, 8), np.int32))
    model = imdb_lstm(**small, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRegistry(model, (1, 4))
    assert model.device.type == "cpu"  # the refused registry moved nothing
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingReplicaSet(model, n=1, buckets=(1, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingService(model, buckets=(1, 4))
    from distkeras_tpu_torch.data import DataFrame
    from distkeras_tpu_torch.data.batching import make_batches
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer

    df = DataFrame({"features": np.zeros((8, 3), np.int32),
                    "label": np.zeros(8, np.int32)})
    plan = make_batches(df, "features", "label", 2, num_workers=2, window=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticTraining(model=model, tx=get_optimizer("sgd", 0.1),
                        loss_fn=get_loss("sparse_categorical_crossentropy"),
                        plan=plan)
    assert model.device.type == "cpu"  # nothing was moved
    from distkeras_tpu_torch.models import MLP
    from distkeras_tpu_torch.racelab import RacedParameterServer, run_raced
    from distkeras_tpu_torch.streaming import (
        StreamingTraining,
        StreamProducer,
        SocketSource,
    )

    prod = StreamProducer()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingTraining(
                model=model, tx=get_optimizer("sgd", 0.1),
                loss_fn=get_loss("sparse_categorical_crossentropy"),
                source=SocketSource(prod.endpoint))
    finally:
        prod.close()
    assert model.device.type == "cpu"  # nothing was moved
    center = [np.zeros((2, 2), np.float32)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RacedParameterServer(center, "adag")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_raced(center=center, local_steps=lambda p, b: p,
                  worker_batches=[[None]], window=1)
    # AsyncEngine.run_stream / SyncEngine.run_stream run on the model's
    # device: the model a user builds for them takes the card or raises.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model.build(MLP(hidden=(4,), num_outputs=2, in_features=3),
                    np.zeros((1, 3), np.float32))


def test_serialize_and_checkpoint_without_msgpack(tmp_path):
    """With ``msgpack`` (and orbax, flax) unimportable, as on the card's
    machine, a model serializes, deserializes, trains with checkpoints and
    resumes."""
    code = (
        "import sys\n"
        "for m in ('msgpack', 'orbax', 'flax', 'jax'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from distkeras_tpu_torch import (DataFrame, DynSGD, imdb_lstm,\n"
        "    deserialize_model, serialize_model)\n"
        "small = dict(vocab_size=20, embed_dim=4, hidden_size=4, seq_len=3)\n"
        "m = imdb_lstm(**small, device='cpu')\n"
        "back = deserialize_model(serialize_model(m), device='cpu')\n"
        "assert all(torch.equal(back.params[k], v)\n"
        "           for k, v in m.params.items())\n"
        "rng = np.random.default_rng(0)\n"
        "df = DataFrame({'features': rng.integers(0, 20, (32, 3)).astype(\n"
        "    np.int32), 'label': rng.integers(0, 2, 32).astype(np.int32)})\n"
        "kw = dict(loss='sparse_categorical_crossentropy', num_workers=2,\n"
        "          batch_size=4, communication_window=2,\n"
        f"          checkpoint_dir={str(tmp_path)!r}, checkpoint_every=1)\n"
        "DynSGD(imdb_lstm(**small, device='cpu'), **kw).train(df)\n"
        "t = DynSGD(imdb_lstm(**small, device='cpu'), num_epoch=2,\n"
        "           resume=True, **kw)\n"
        "t.train(df)\n"
        "assert len(t.get_history()) == 2\n"
        "bad = sorted(k for k in sys.modules if sys.modules[k] is not None\n"
        f"             and k.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_keras_is_imported_only_inside_the_adapters_functions():
    """The card's machine has no keras, and keras under another backend
    loads that backend's framework: importing every module of the port
    loads no keras (nor tensorflow), and the one module that names keras
    imports it inside a function."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import distkeras_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('keras', 'tensorflow'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                       ast.ImportFrom))]
        names = [a.name for n in top for a in n.names] + [
            n.module or "" for n in top if isinstance(n, ast.ImportFrom)]
        assert not any(n.split(".")[0] == "keras" for n in names), path
        if path.name != "keras_adapter.py":
            assert "import keras" not in path.read_text(), path


@pytest.mark.parametrize("module", [
    "distkeras_tpu_torch.runtime.mesh",
    "distkeras_tpu_torch.ops.collectives",
    "distkeras_tpu_torch.roofline",
    "distkeras_tpu_torch.job_deployment"])
def test_rank_plane_modules_load_no_jax(module):
    """The process group, its collectives, the scaling model and the job
    launcher, each module on its own."""
    code = (f"import sys, {module}\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_a_group_asked_for_nccl_without_a_card_raises(monkeypatch):
    """No fallback to gloo or to one rank: NCCL without a card (the
    default device is the card) raises, and so does NCCL on the CPU; no
    group is left behind."""
    from distkeras_tpu_torch.runtime import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rendezvous = dict(master_addr="127.0.0.1", master_port=1, world_size=1,
                      rank=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.distributed_initialize(backend="nccl", **rendezvous)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.distributed_initialize(**rendezvous)
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA"):
        mesh.distributed_initialize(backend="nccl", device="cpu",
                                    **rendezvous)
    assert not mesh.group_active() and mesh.rank_device() is None


@pytest.mark.parametrize("module", [
    "distkeras_tpu_torch.parallel.sharding",
    "distkeras_tpu_torch.parallel.runner",
    "distkeras_tpu_torch.parallel.spmd",
    "distkeras_tpu_torch.parallel.gspmd",
    "distkeras_tpu_torch.parallel.pipeline",
    "distkeras_tpu_torch.parallel.pipeline_engine",
    "distkeras_tpu_torch.parallel.async_tp",
    "distkeras_tpu_torch.ops.ring_attention"])
def test_model_parallel_modules_load_no_jax(module):
    """The model-parallel engines, the partition rules and ring attention,
    each module on its own."""
    code = (f"import sys, {module}\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
