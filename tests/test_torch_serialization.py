"""Model serialization in the port (``runtime/msgpack.py``,
``runtime/serialization.py``, ``convert.params_to_jax``) against the JAX
package's, which goes through flax's msgpack: the codec writes flax's bytes
over hypothesis-drawn trees and each side reads the other's; for every
model family the port's blob of the converted weights is byte-equal to the
JAX package's, and each package's ``deserialize_model`` of the other's blob
predicts within 1e-5 (f32, the same arithmetic in another library)."""

import json
import struct

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import distkeras_tpu as dk
from distkeras_tpu.models.base import Model as JaxModel
from distkeras_tpu.models.cnn import SimpleCNN as JaxSimpleCNN
from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu.models.mlp import mnist_mlp as jax_mnist_mlp
from distkeras_tpu.models.resnet import tiny_resnet as jax_tiny_resnet
from distkeras_tpu.models.transformer import (
    small_transformer_lm as jax_small_lm,
)
from distkeras_tpu_torch import (
    deserialize_model,
    deserialize_params,
    serialize_model,
    serialize_params,
)
from distkeras_tpu_torch.convert import params_from_jax, params_to_jax
from distkeras_tpu_torch.models.base import MODEL_CLASSES, Model
from distkeras_tpu_torch.runtime import msgpack as M

# -- the codec ---------------------------------------------------------------

#: every int size class msgpack-python picks between, at both ends
INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63]
STR_EDGES = ["", "a" * 31, "a" * 32, "a" * 255, "a" * 256, "é" * 16,
             "b" * 65535, "c" * 65536]
BIN_EDGES = [b"", b"x", b"x" * 255, b"x" * 256, b"y" * 65535, b"z" * 65536]
DTYPES = ["float32", "float64", "float16", "int8", "uint8", "int32",
          "int64", "uint16", "bool", "bfloat16"]


def _array(dtype: str, shape: tuple, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bfloat16":
        bits = rng.integers(0, 2 ** 16, shape, dtype=np.uint16)
        return bits.view(ml_dtypes.bfloat16)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if np.dtype(dtype).kind == "f":
        return rng.normal(size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype,
                        endpoint=True)


arrays = st.builds(_array, st.sampled_from(DTYPES),
                   st.lists(st.integers(0, 4), max_size=3).map(tuple),
                   st.integers(0, 2 ** 32 - 1))
scalars = st.builds(lambda v, t: np.dtype(t).type(v),
                    st.integers(0, 100),
                    st.sampled_from(["int32", "float32", "int8", "uint8"]))
leaves = st.one_of(
    st.none(), st.booleans(),
    st.integers(-2 ** 63, 2 ** 64 - 1), st.sampled_from(INT_EDGES),
    st.floats(allow_nan=False), st.text(max_size=40),
    st.sampled_from(STR_EDGES[:6]), st.binary(max_size=40),
    st.sampled_from(BIN_EDGES[:4]), arrays, scalars)
trees = st.recursive(
    leaves,
    lambda kids: st.one_of(st.lists(kids, max_size=20),
                           st.dictionaries(st.text(max_size=8), kids,
                                           max_size=20)),
    max_leaves=40)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def assert_tree_equal(a, b):
    """Structure, types and bits equal (a numpy bf16 array equals a torch
    bf16 tensor of the same bits)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    elif isinstance(a, (np.ndarray, np.generic, torch.Tensor)):
        x, y = _bits(a), _bits(b)
        assert x.shape == y.shape and x.dtype == y.dtype, (x.dtype, y.dtype)
        assert x.tobytes() == y.tobytes()
    else:
        assert type(a) is type(b) and a == b, (a, b)


@settings(max_examples=150, deadline=None)
@given(trees)
def test_codec_writes_flax_bytes_and_each_side_reads_the_other(tree):
    for in_place in (False, True):
        want = flax_ser.msgpack_serialize(_copy(tree), in_place=in_place)
        got = M.msgpack_serialize(tree, in_place=in_place)
        assert got == want
    assert_tree_equal(M.msgpack_restore(want), flax_ser.msgpack_restore(want))
    assert_tree_equal(flax_ser.msgpack_restore(got), M.msgpack_restore(got))


def _copy(tree):
    """A copy of the dict/list skeleton (flax's in-place path edits it)."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree


@pytest.mark.parametrize("value", INT_EDGES + STR_EDGES + BIN_EDGES
                         + [True, False, None, 0.0, -1.5, 1e300])
def test_codec_every_size_class(value):
    tree = {"v": value, "l": [value] * 17, "m": {str(i): value
                                                  for i in range(17)}}
    want = flax_ser.msgpack_serialize(tree)
    assert M.msgpack_serialize(tree) == want
    assert_tree_equal(M.msgpack_restore(want), flax_ser.msgpack_restore(want))


@pytest.mark.parametrize("dtype,nbytes", [
    (d, n) for d, size in (("int8", 1), ("bool", 1), ("bfloat16", 2),
                           ("float32", 4))
    for n in (1, 2, 4, 8, 16) if n % size == 0])
def test_codec_array_payload_sizes(nbytes, dtype):
    """Arrays of exactly 1, 2, 4, 8 and 16 bytes of data, and the payload
    lengths that make msgpack pick fixext16 over ext8."""
    itemsize = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
    a = _array(dtype, (nbytes // itemsize,), nbytes)
    for tree in ({"a": a}, {"a": a.reshape(())} if a.size == 1 else {"a": a},
                 {"s": a.reshape(-1)[0]}):
        want = flax_ser.msgpack_serialize(tree)
        assert M.msgpack_serialize(tree) == want
        assert_tree_equal(M.msgpack_restore(want),
                          flax_ser.msgpack_restore(want))


def test_codec_fixext16_and_torch_leaves():
    """A (6,) int8 array's payload is exactly 16 bytes: fixext16 (0xd8).
    Torch tensors (bf16 among them) write the numpy arrays' bytes."""
    a = np.arange(6, dtype=np.int8)
    out = M.msgpack_serialize({"a": a})
    assert out[3] == 0xD8 and out == flax_ser.msgpack_serialize({"a": a})
    bits = np.random.default_rng(0).integers(0, 2 ** 16, (3, 5),
                                             dtype=np.uint16)
    numpy_tree = {"bf": bits.view(ml_dtypes.bfloat16),
                  "f": np.linspace(0, 1, 7, dtype=np.float32),
                  "i": np.arange(4, dtype=np.int64)}
    torch_tree = {"bf": torch.from_numpy(bits.astype(np.int32)).to(
                      torch.uint16).view(torch.bfloat16),
                  "f": torch.from_numpy(numpy_tree["f"]),
                  "i": torch.arange(4)}
    want = flax_ser.msgpack_serialize(numpy_tree)
    assert M.msgpack_serialize(torch_tree) == want
    back = M.msgpack_restore(want)
    assert back["bf"].dtype == torch.bfloat16
    assert torch.equal(back["bf"].view(torch.uint16), torch_tree["bf"].view(
        torch.uint16))


def test_codec_chunked_arrays(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE go out as flax's chunk dicts (patched
    down to 64 bytes on both sides) and come back whole."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(M, "MAX_CHUNK_SIZE", 64)
    tree = {"big": _array("float32", (7, 9), 1), "small": np.arange(3),
            "nested": {"big": _array("int8", (130,), 2)},
            "bf": _array("bfloat16", (50,), 3)}
    want = flax_ser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in want
    assert M.msgpack_serialize(tree) == want
    assert_tree_equal(M.msgpack_restore(want), flax_ser.msgpack_restore(want))
    top = _array("float32", (40,), 4)
    assert M.msgpack_serialize(top) == flax_ser.msgpack_serialize(top)
    assert_tree_equal(M.msgpack_restore(M.msgpack_serialize(top)), top)


def test_codec_refuses_what_it_does_not_read():
    with pytest.raises(ValueError, match="ext type 2"):
        M.msgpack_restore(flax_ser.msgpack_serialize({"c": 1 + 2j}))
    bad = M.packb((2,), strict=False)
    payload = M.packb([[2], "object", b"\0" * 16], strict=False)
    with pytest.raises(ValueError, match="dtype 'object'"):
        M.msgpack_restore(b"\x81\xa1a\xc7" + bytes([len(payload), 1])
                          + payload)
    with pytest.raises(TypeError):
        M.msgpack_serialize({"t": (1, 2)})   # flax refuses tuples too
    with pytest.raises(ValueError, match="extra data"):
        M.unpackb(bad + b"\x00")


# -- parameters and models ---------------------------------------------------

def _jax_models():
    lm = dict(vocab_size=64, num_layers=2, d_model=16, num_heads=2, d_ff=32,
              max_seq_len=16, seq_len=8)
    lstm = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)
    return {
        "lstm_xla": (lambda: jax_imdb_lstm(**lstm, seed=3),
                     lambda r: r.integers(0, 50, (3, 6)).astype(np.int32)),
        "lstm_pallas": (lambda: jax_imdb_lstm(**lstm, cell_impl="pallas",
                                              seed=4),
                        lambda r: r.integers(0, 50, (3, 6)).astype(np.int32)),
        "mlp": (lambda: jax_mnist_mlp(hidden=(16, 12), seed=5),
                lambda r: r.normal(size=(3, 784)).astype(np.float32)),
        "cnn": (lambda: JaxModel.build(
                    JaxSimpleCNN(conv_features=(4, 8), dense=(16,),
                                 num_outputs=10),
                    jnp.zeros((1, 28, 28, 1), jnp.float32), seed=6),
                lambda r: r.normal(size=(3, 28, 28, 1)).astype(np.float32)),
        # odd, oblong images: the spec records no H and W, so the port's
        # module is sized from the tree's flattened width alone
        "cnn_oblong": (lambda: JaxModel.build(
                           JaxSimpleCNN(conv_features=(4, 8), dense=(16,),
                                        num_outputs=10),
                           jnp.zeros((1, 30, 19, 3), jnp.float32), seed=9),
                       lambda r: r.normal(size=(3, 30, 19, 3)).astype(
                           np.float32)),
        "resnet": (lambda: jax_tiny_resnet(seed=7),
                   lambda r: r.normal(size=(2, 32, 32, 3)).astype(
                       np.float32)),
        "transformer": (lambda: jax_small_lm(**lm, seed=8),
                        lambda r: r.integers(0, 64, (2, 8)).astype(
                            np.int32)),
    }


def _port_of(jm) -> Model:
    spec = jm.spec()
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    module = MODEL_CLASSES[spec["class"]].from_config(spec["kwargs"],
                                                      params=tree)
    module.load_state_dict(params_from_jax(tree, module))
    return Model(module=module.eval(), device=torch.device("cpu"),
                 sample_spec=None)


@pytest.mark.parametrize("family", list(_jax_models()))
def test_model_blob_is_byte_equal_and_loads_across(family):
    build, inputs = _jax_models()[family]
    jm = build()
    pm = _port_of(jm)
    blob = serialize_model(pm)
    jblob = dk.serialize_model(jm)
    assert blob == jblob
    assert pm.serialize() == blob
    x = inputs(np.random.default_rng(0))
    want = np.asarray(jm.predict(jnp.asarray(x)))
    port_loaded = deserialize_model(jblob, device="cpu")
    assert json.dumps(port_loaded.spec()) == json.dumps(jm.spec())
    np.testing.assert_allclose(port_loaded.predict(x).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    jax_loaded = dk.deserialize_model(blob)
    np.testing.assert_allclose(np.asarray(jax_loaded.predict(jnp.asarray(x))),
                               pm.predict(x).numpy(), rtol=1e-5, atol=1e-5)
    # the round trip through the JAX layout is exact
    for k, v in pm.params.items():
        assert torch.equal(port_loaded.params[k], v), k
    assert serialize_model(port_loaded) == blob


def test_spec_matches_the_jax_modules():
    for build, _ in _jax_models().values():
        jm = build()
        spec = _port_of(jm).spec()
        assert json.dumps(spec) == json.dumps(jm.spec())


def test_version_1_blob_loads():
    jm = jax_mnist_mlp(hidden=(8,), seed=1)
    spec = json.dumps(jm.spec()).encode()
    v1 = (b"DKTPU1" + struct.pack("<I", len(spec)) + spec
          + flax_ser.to_bytes(jm.params))
    pm = deserialize_model(v1, device="cpu")
    x = np.random.default_rng(1).normal(size=(2, 784)).astype(np.float32)
    np.testing.assert_allclose(pm.predict(x).numpy(),
                               np.asarray(jm.predict(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def test_deserialize_refuses_bad_blobs():
    with pytest.raises(ValueError, match="bad magic"):
        deserialize_model(b"NOPE" + b"\0" * 16, device="cpu")
    spec = json.dumps({"class": "Nope", "kwargs": {}}).encode()
    with pytest.raises(KeyError, match="unknown model class"):
        deserialize_model(b"DKTPU1" + struct.pack("<I", len(spec)) + spec
                          + M.msgpack_serialize({"params": {}, "state": {}}),
                          device="cpu")


def test_params_bytes_match_flax_to_bytes():
    jm = jax_imdb_lstm(vocab_size=20, embed_dim=4, hidden_size=4, seq_len=3,
                       cell_impl="pallas", seed=2)
    pm = _port_of(jm)
    tree = params_to_jax(pm.params, pm.module)
    assert serialize_params(tree) == flax_ser.to_bytes(jm.params)
    back = deserialize_params(pm.params, serialize_params(pm.params))
    assert list(back) == list(pm.params)
    for k, v in pm.params.items():
        assert torch.equal(back[k], v)
    with pytest.raises(ValueError, match="do not match"):
        deserialize_params({"nope": torch.zeros(1)},
                           serialize_params(pm.params))
