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
    JAX package's canonical JSON without its ``to_partition_specs`` (the
    one function there that imports jax)."""
    code = (f"import sys, {module}\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    src = (PKG / "netps" / "shards" / "plan.py").read_text()
    assert "to_partition_specs" in src and "def to_partition_specs" not in src


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
        TransformerLM,
        imdb_lstm,
        resnet50,
        small_transformer_lm,
    )
    from distkeras_tpu_torch.models import Model
    from distkeras_tpu_torch.serving import ModelRegistry

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
