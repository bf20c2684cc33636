"""The port's native data-plane loops (``distkeras_tpu_torch/data/
native_loader.py`` over ``distkeras_tpu_torch/native/loader.cc``) against
numpy and the JAX package's own binding of the same source.

Tolerances: ``gather_rows`` bit-identical to numpy's fancy indexing;
``scale_f32`` bit-equal to the JAX package's ``scale_f32`` (the same source,
flags and compiler on this machine), within one float32 ulp of the numpy
formula, and exact at the low end of a min-max range.
"""

import re

import numpy as np
import pytest

from distkeras_tpu.data import native_loader as jax_native
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.data import native_loader as N
from distkeras_tpu_torch.data.native_loader import gather_rows, scale_f32


def _counters() -> dict:
    c = telemetry.get().snapshot()["counters"]
    return {k: c.get(f"native.{k}", 0.0) for k in (
        "gather_calls", "gather_bytes", "gather_fallback_calls",
        "scale_calls", "scale_fallback_calls")}


@pytest.fixture(autouse=True)
def _fresh_telemetry(monkeypatch):
    monkeypatch.delenv("DKTPU_NO_NATIVE", raising=False)
    telemetry.reset()


@pytest.mark.parametrize("shape,dtype,idx_shape", [
    ((1000, 17), np.float32, (4, 3, 5)),
    ((50, 4, 4), np.int32, (7,)),
    ((64,), np.int64, (2, 8)),
    ((33, 5), np.int8, (3, 11)),
    ((40, 2, 3, 2), np.uint8, (1, 2, 20)),
    ((30, 6), np.float64, (0,)),
])
def test_gather_rows_is_numpy_indexing(shape, dtype, idx_shape):
    rng = np.random.default_rng(sum(shape))
    src = (rng.normal(size=shape) * 50).astype(dtype)
    idx = rng.integers(0, shape[0], size=idx_shape)
    got = gather_rows(src, idx)
    want = src[idx]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    c = _counters()
    assert c["gather_calls"] == 1 and c["gather_fallback_calls"] == 0
    assert c["gather_bytes"] == want.nbytes


def test_gather_rows_from_a_memmap(tmp_path):
    rng = np.random.default_rng(5)
    np.save(tmp_path / "col.npy", rng.normal(size=(300, 3, 7)).astype(
        np.float32))
    src = np.load(tmp_path / "col.npy", mmap_mode="r")
    idx = rng.integers(0, 300, size=(2, 3, 16))
    np.testing.assert_array_equal(gather_rows(src, idx), np.asarray(src)[idx])
    assert _counters()["gather_fallback_calls"] == 0


@pytest.mark.parametrize("bad", [[0, 10], [-1], [3, 2**40]])
def test_gather_rows_out_of_range_raises(bad):
    src = np.zeros((10, 3), np.float32)
    with pytest.raises(IndexError, match="out of range"):
        gather_rows(src, np.array(bad))


@pytest.mark.parametrize("case", ["strided", "object", "zero_byte_rows"])
def test_layout_fallbacks_are_numpy_and_counted(case):
    """The layouts the C loop does not take go through numpy, as in the JAX
    package, and each is counted as a fallback."""
    rng = np.random.default_rng(6)
    src = {"strided": rng.normal(size=(20, 8)).astype(np.float32)[:, ::2],
           "object": np.array([[1, "a"], [2, "b"], [3, "c"]], dtype=object),
           "zero_byte_rows": np.zeros((5, 0), np.float32)}[case]
    idx = np.array([[2, 0], [1, 1]])
    got = gather_rows(src, idx)
    np.testing.assert_array_equal(got, src[idx])
    c = _counters()
    assert c["gather_fallback_calls"] == 1 and c["gather_calls"] == 0


def test_no_native_selects_numpy_and_counts_it(monkeypatch):
    monkeypatch.setenv("DKTPU_NO_NATIVE", "1")
    assert N.get_lib() is None
    rng = np.random.default_rng(7)
    src = rng.normal(size=(40, 3)).astype(np.float32)
    idx = rng.integers(0, 40, size=(2, 9))
    np.testing.assert_array_equal(gather_rows(src, idx), src[idx])
    x = rng.normal(size=(100,)).astype(np.float32)
    np.testing.assert_array_equal(
        scale_f32(x, 0.5, 2.0, 1.0),
        ((x - np.float32(0.5)) * np.float32(2.0)) + np.float32(1.0))
    c = _counters()
    assert (c["gather_fallback_calls"], c["gather_calls"]) == (1, 0)
    assert (c["scale_fallback_calls"], c["scale_calls"]) == (1, 0)
    monkeypatch.setenv("DKTPU_NO_NATIVE", "0")
    assert N.get_lib() is not None


@pytest.mark.parametrize("n,offset,scale,bias", [
    ((333, 7), 0.5, 2.0, 0.0),
    ((257, 3), 0.25, 3.0, -1.5),
    ((300, 256), -3.0, 1.0 / 255.0, 0.1),  # past 2^16: the threaded loop
    ((2,), 2.0, 1.0 / 9.5367431640625e-07, 5.0),  # a degenerate range
])
def test_scale_f32_is_the_jax_packages_bits(n, offset, scale, bias):
    rng = np.random.default_rng(sum(n))
    x = (rng.normal(size=n) * 40).astype(np.float32)
    got = scale_f32(x, offset, scale, bias)
    assert got.dtype == np.float32 and got.shape == x.shape
    assert jax_native.get_lib() is not None  # the reference's loop, too
    assert got.tobytes() == jax_native.scale_f32(x, offset, scale,
                                                 bias).tobytes()
    ref = (((x - np.float32(offset)) * np.float32(scale))
           + np.float32(bias)).astype(np.float32)
    ulp = np.spacing(np.abs(ref))
    assert np.all(np.abs(got - ref) <= ulp)
    assert _counters()["scale_calls"] == 1


def test_scale_f32_exact_at_the_low_endpoint():
    """``(i_min - i_min) * scale + o_min`` is ``o_min`` whatever the scale:
    the case the separate bias exists for; and a [0, 255] -> [-1, 1]
    rescale hits both ends exactly through MinMaxTransformer."""
    from distkeras_tpu_torch.data import DataFrame, MinMaxTransformer

    x = np.array([2.0, 2.0 + 1e-6], np.float32)
    out = scale_f32(x, float(x[0]), 1.0 / float(x[1] - x[0]), bias=5.0)
    assert out[0] == np.float32(5.0)
    df = DataFrame({"features": np.array([[0.0], [255.0], [51.0]],
                                         np.float32)})
    got = MinMaxTransformer(o_min=-1.0, o_max=1.0).transform(df)[
        "features_normalized"]
    assert got[0, 0] == np.float32(-1.0) and got[1, 0] == np.float32(1.0)
    assert _counters()["scale_calls"] == 2


def test_abi_version_matches_the_source():
    src = N.SRC.read_text()
    m = re.search(r"int\s+dk_abi_version\(\)\s*\{\s*return\s+(\d+)\s*;", src)
    assert m and int(m.group(1)) == N._ABI_VERSION
    assert N.get_lib().dk_abi_version() == N._ABI_VERSION


def test_the_library_is_the_ports_own_build():
    """Built from the port's copy of the source into ``build/native/``
    under a digest of the source and flags: never the JAX package's
    ``_loader.so``."""
    lib = N.get_lib()
    path = N.library_path()
    assert path.exists() and path.parent == N.BUILD_DIR
    assert N.SRC.parent.parent.name == "distkeras_tpu_torch"
    assert lib._name == str(path)
    assert "distkeras_tpu/native" not in lib._name


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                         monkeypatch):
    """No quiet fallback: a source that does not compile raises, naming the
    compiler's complaint, and no path takes numpy in its place."""
    bad = tmp_path / "loader.cc"
    bad.write_text('extern "C" int dk_abi_version() { return 2 }\n')
    monkeypatch.setattr(N, "SRC", bad)
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(N, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ exited") as e:
        N.get_lib()
    assert "error" in str(e.value)
    with pytest.raises(RuntimeError, match="build failed"):
        gather_rows(np.zeros((4, 2), np.float32), np.array([1]))
    assert not list((tmp_path / "native").glob("*.so"))
    assert _counters()["gather_fallback_calls"] == 0


def test_a_library_of_another_abi_is_refused(tmp_path, monkeypatch):
    stale = tmp_path / "loader.cc"
    stale.write_text(N.SRC.read_text().replace(
        "int dk_abi_version() { return 2; }",
        "int dk_abi_version() { return 1; }"))
    monkeypatch.setattr(N, "SRC", stale)
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(N, "_lib", None)
    with pytest.raises(RuntimeError, match="ABI version 1"):
        N.get_lib()


def test_batch_plan_rounds_gather_natively():
    from distkeras_tpu_torch.data import DataFrame, make_batches

    rng = np.random.default_rng(3)
    df = DataFrame({"features": rng.normal(size=(96, 5)).astype(np.float32),
                    "label": rng.integers(0, 3, size=96).astype(np.int32)})
    plan = make_batches(df, "features", "label", batch_size=4, num_workers=2,
                        window=3, shuffle=True, seed=7)
    for r in range(plan.num_rounds):
        fx, fy = plan.round(r)
        idx = plan.index[r]
        assert fx.tobytes() == df["features"][idx].tobytes()
        assert fy.tobytes() == df["label"][idx].tobytes()
    c = _counters()
    assert c["gather_calls"] == 2 * plan.num_rounds
    assert c["gather_fallback_calls"] == 0
