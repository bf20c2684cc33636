"""Kernel #8, the dequant-fused fold: the port's plain twin
(``distkeras_tpu_torch/ops/kernels/fold.py``, what a CPU center folds
through) against the JAX package's numpy oracle
(``netps/fold.fold_compressed_numpy``), bit for bit, and against the Pallas
kernel (``ops/pallas/fold.fold_compressed``) in interpret mode at rtol 1e-6
/ atol 1e-7 — every case of ``tests/test_pallas_fold.py``. The CUDA kernel
is held to the same twin on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from distkeras_tpu.netps import fold as jfold
from distkeras_tpu.netps import wire as jwire
from distkeras_tpu.ops.pallas import fold as pfold
from distkeras_tpu_torch.netps import fold as tfold
from distkeras_tpu_torch.netps import wire as twire
from distkeras_tpu_torch.ops.kernels import fold as K

SHAPES = [(7,), (128,), (33, 5), (257, 129), (2, 3, 64), (70_001,)]


def _port_fold(center: np.ndarray, enc: np.ndarray, spec: dict,
               scale: float) -> np.ndarray:
    c = torch.from_numpy(center.copy())
    K.fold_compressed_(c, tfold.wire_tensor(enc), spec, scale)
    return c.numpy()


@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scale", [1.0, 0.5, 1.0 / 3.0])
def test_twin_matches_numpy_oracle_and_pallas(codec, shape, scale):
    rng = np.random.default_rng(
        [codec == "int8", int(np.prod(shape)), len(shape), int(scale * 99)])
    d = (rng.normal(size=shape) * 0.01).astype(np.float32)
    center = rng.normal(size=shape).astype(np.float32)
    enc, spec = twire.codec_encode(d, codec)
    jenc, jspec = jwire.codec_encode(d, codec)
    np.testing.assert_array_equal(enc, jenc)  # one wire, both packages
    assert spec == jspec and spec.get("codec") == codec
    ref = center.copy()
    jfold.fold_compressed_numpy(ref, enc, spec, scale)
    before = K.launch_counts()
    out = _port_fold(center, enc, spec, scale)
    assert K.launch_counts() == before  # CPU: the plain twin
    assert out.shape == center.shape and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    pallas = pfold.fold_compressed(center, enc, spec, scale, interpret=True)
    np.testing.assert_allclose(out, pallas, rtol=1e-6, atol=1e-7)


def test_twin_within_one_int8_step_of_decode_then_fold():
    rng = np.random.default_rng(0)
    d = (rng.normal(size=(513,)) * 0.02).astype(np.float32)
    center = rng.normal(size=(513,)).astype(np.float32)
    enc, spec = twire.codec_encode(d, "int8")
    decode_then_fold = center + 1.0 * twire.codec_decode(enc, spec)
    fused = _port_fold(center, enc, spec, 1.0)
    assert np.abs(fused - decode_then_fold).max() <= float(spec["scale"])


def test_zero_scale_and_empty_edges():
    enc, spec = twire.codec_encode(np.zeros((4,), np.float32), "int8")
    assert spec["scale"] == 0.0
    c = np.ones(4, np.float32)
    np.testing.assert_array_equal(_port_fold(c, enc, spec, 1.0), c)
    q = tfold.wire_tensor(np.ones(4, np.int8))
    t = torch.ones(4)
    K.fold_compressed_(t, q, {"codec": "int8", "scale": 0.5}, 0.0)
    assert torch.equal(t, torch.ones(4))  # commit scale 0: untouched
    out_e = _port_fold(np.zeros((0,), np.float32), np.zeros((0,), np.uint16),
                       {"codec": "bf16"}, 1.0)
    assert out_e.size == 0


def test_unknown_codec_is_typed():
    with pytest.raises(ValueError, match="codec"):
        K.fold_compressed_(torch.ones(4), torch.ones(4, dtype=torch.int8),
                           {"codec": "zstd"}, 1.0)


def test_missing_int8_scale_raises_like_the_oracle():
    c = np.ones(4, np.float32)
    q = np.ones(4, np.int8)
    with pytest.raises(KeyError):
        K.fold_compressed_(torch.from_numpy(c.copy()), torch.from_numpy(q),
                           {"codec": "int8"}, 1.0)
    with pytest.raises(KeyError):
        jfold.fold_compressed_numpy(c.copy(), q, {"codec": "int8"}, 1.0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q8 = torch.ones(4, dtype=torch.int8)
    spec = {"codec": "int8", "scale": 1.0}
    with pytest.raises(TypeError, match="float32"):
        K.fold_compressed_(torch.ones(4, dtype=torch.float64), q8, spec, 1.0)
    with pytest.raises(TypeError, match="int8"):
        K.fold_compressed_(torch.ones(4), q8.to(torch.int16), spec, 1.0)
    with pytest.raises(ValueError, match="elements"):
        K.fold_compressed_(torch.ones(5), q8, spec, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        K.fold_compressed_(torch.ones(4, 2).t(), torch.ones(
            2, 4, dtype=torch.int8), spec, 1.0)
    assert K.launch_counts() == {"fold_int8": 0, "fold_bf16": 0}


@pytest.mark.parametrize("discipline,staleness",
                         [("adag", 0), ("dynsgd", 2), ("downpour", 5)])
def test_fold_delta_matches_the_jax_fold_bit_for_bit(discipline, staleness):
    """The server-side fold over a mixed commit (plain f32, int8, bf16
    entries) against the JAX package's ``fold_delta`` on numpy."""
    rng = np.random.default_rng(staleness)
    shapes = [(33, 5), (70,), (4, 4)]
    center = [rng.normal(size=s).astype(np.float32) for s in shapes]
    deltas = [(rng.normal(size=s) * 0.01).astype(np.float32)
              for s in shapes]
    entries = [deltas[0],
               twire.codec_encode(deltas[1], "int8"),
               twire.codec_encode(deltas[2], "bf16")]
    ref = [c.copy() for c in center]
    jfold.fold_delta(ref, entries, discipline, staleness)
    got = [torch.from_numpy(c.copy()) for c in center]
    tfold.fold_delta(got, entries, discipline, staleness)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    assert tfold.backend_name(got) == "torch-cpu"
    assert tfold.commit_scale(discipline, staleness) == jfold.commit_scale(
        discipline, staleness)
