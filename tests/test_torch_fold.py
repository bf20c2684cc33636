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
    assert K.launch_counts() == {"fold_commit": 0, "fold_int8": 0,
                                 "fold_bf16": 0}


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


# -- the commit fold: one staged buffer, one fold a commit ------------------

def _mixed_commit(rng):
    """A mixed commit as the wire carries it, with its f32 centers: an
    int8 tensor, an int8 tensor whose delta is all zero (spec scale 0; its
    center holds a -0.0, which folding 0 would turn into +0.0), bf16
    tensors, a plain-f32 entry carrying inf and -inf (the wire sends
    non-finite tensors uncompressed), an empty one, and ragged sizes."""
    shapes = [(33, 5), (7,), (70_001,), (1,), (3, 3), (0,), (4097,)]
    center = [rng.normal(size=s).astype(np.float32) for s in shapes]
    center[1][2] = -0.0
    d = [(rng.normal(size=s) * 0.01).astype(np.float32) for s in shapes]
    d[1][:] = 0.0
    d[4][1, 2], d[4][0, 0] = np.inf, -np.inf
    entries = [twire.codec_encode(d[0], "int8"),
               twire.codec_encode(d[1], "int8"),
               twire.codec_encode(d[2], "bf16"),
               twire.codec_encode(d[3], "bf16"),
               twire.codec_encode(d[4], "int8"),   # non-finite: plain f32
               twire.codec_encode(d[5], "int8"),   # empty: plain f32
               d[6]]                               # a plain array
    assert entries[1][1] == {"codec": "int8", "scale": 0.0}
    assert entries[4][1] == {} and entries[4][0].dtype == np.float32
    return center, entries


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """The JAX ``fold_delta``'s accelerator backend forced to the Pallas
    fold in interpret mode (the CPU's stand-in for the TPU kernel)."""
    import functools
    import types

    shim = types.SimpleNamespace(fold_compressed=functools.partial(
        pfold.fold_compressed, interpret=True))
    monkeypatch.setattr(jfold, "_ACCEL", shim)
    monkeypatch.setattr(jfold, "_ACCEL_RESOLVED", True)


@pytest.mark.parametrize("discipline,staleness",
                         [("dynsgd", 0), ("dynsgd", 2), ("adag", 0)])
def test_commit_fold_matches_the_jax_numpy_fold_bit_for_bit(discipline,
                                                            staleness):
    """A mixed commit through ``fold_delta`` (staged into one packed buffer,
    folded by ``fold_commit_plain_`` reading that buffer) against the JAX
    package's ``fold_delta`` on its numpy backend: the same bits, inf and
    -0.0 included; nothing launched."""
    center, entries = _mixed_commit(np.random.default_rng(staleness + 7))
    ref = [c.copy() for c in center]
    jfold.fold_delta(ref, entries, discipline, staleness)
    got = [torch.from_numpy(c.copy()) for c in center]
    before = K.launch_counts()
    tfold.fold_delta(got, entries, discipline, staleness)
    assert K.launch_counts() == before
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(r))
    assert np.isinf(got[4].numpy()).sum() == 2


@pytest.mark.parametrize("staleness", [0, 2])
def test_commit_fold_matches_the_jax_pallas_fold(jax_pallas_interpret,
                                                 staleness):
    """The same commit against the JAX ``fold_delta`` with the Pallas fold
    in interpret mode behind it. Its plain entries fold by numpy there, so
    they match bit for bit; its compressed ones at the JAX package's own
    kernel-vs-oracle limit (rtol 1e-6, atol 1e-7,
    ``tests/test_pallas_fold.py``): XLA on the CPU contracts the kernel's
    ``c + s * d`` into one rounding where numpy and the port round the
    product and the sum apart, so up to one f32 step apart."""
    center, entries = _mixed_commit(np.random.default_rng(staleness + 11))
    ref = [c.copy() for c in center]
    jfold.fold_delta(ref, entries, "dynsgd", staleness)
    got = [torch.from_numpy(c.copy()) for c in center]
    tfold.fold_delta(got, entries, "dynsgd", staleness)
    for i, (g, r) in enumerate(zip(got, ref)):
        if tfold.split_entry(entries[i])[1]:
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(r))


def test_commit_twin_is_the_per_tensor_twin():
    """``fold_commit_plain_`` on a staged commit gives the bits of the
    per-tensor path the server took before (``fold_compressed_`` on each
    compressed tensor, ``c.add_(a * f32(scale))`` on each plain one), and
    ``fold_delta`` takes a staged commit as it takes its entries."""
    rng = np.random.default_rng(5)
    center, entries = _mixed_commit(rng)
    scale = 1.0 / 3.0
    per_tensor = [torch.from_numpy(c.copy()) for c in center]
    for c, e in zip(per_tensor, entries):
        a, spec = tfold.split_entry(e)
        if spec:
            K.fold_compressed_(c, tfold.wire_tensor(a), spec, scale)
        else:
            c.add_(torch.from_numpy(np.asarray(a, np.float32)).reshape(
                c.shape) * float(np.float32(scale)))
    staged = tfold.stage_commit(entries, "cpu")
    commit = [torch.from_numpy(c.copy()) for c in center]
    K.fold_commit_plain_(commit, staged, scale)
    again = [torch.from_numpy(c.copy()) for c in center]
    tfold.fold_delta(again, staged, "dynsgd", 2)
    for p, c, a in zip(per_tensor, commit, again):
        np.testing.assert_array_equal(_bits(c.numpy()), _bits(p.numpy()))
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(p.numpy()))


def test_packer_lays_out_every_kind():
    """``plan_commit``/``pack_commit`` (what ``stage_commit`` writes): the
    table at the head (one row per entry, then the tile prefix), every
    payload at a 16-byte offset past it, in its wire dtype and bytes, no
    two overlapping; the centers at ``center_layout``'s 64-byte offsets
    unless told otherwise; and ``stage_commit`` on the CPU returns the
    packed buffer with its table as host rows over the buffer's own bytes,
    which the twin reads."""
    rng = np.random.default_rng(3)
    _center, entries = _mixed_commit(rng)
    staged = tfold.stage_commit(entries, "cpu")
    assert isinstance(staged, K.StagedCommit)
    assert tfold.stage_commit(staged, "cpu") is staged
    E = len(entries)
    buf = staged.buf.numpy()
    rows, first = K.read_table(buf, E)
    assert rows.dtype == K.ROW and K.ROW.itemsize == 40
    assert np.shares_memory(staged.rows, buf)
    kinds = [K.KIND_INT8, K.KIND_INT8, K.KIND_BF16, K.KIND_BF16, K.KIND_F32,
             K.KIND_F32, K.KIND_F32]
    assert rows["kind"].tolist() == kinds
    sizes = [np.size(tfold.split_entry(e)[0]) for e in entries]
    assert rows["n"].tolist() == sizes
    factors = [float(tfold.split_entry(e)[1]["scale"]) if k == K.KIND_INT8
               else 1.0 for e, k in zip(entries, kinds)]
    assert rows["factor"].tolist() == factors
    offsets, total = K.center_layout(sizes)
    assert rows["center"].tolist() == offsets
    assert all(o % K.CENTER_ALIGN == 0 for o in offsets)
    assert total == offsets[-1] + sizes[-1]
    tiles = [-(-n // K.TILE) for n in sizes]
    assert first.tolist() == [0, *np.cumsum(tiles).tolist()]
    assert staged.tiles == sum(tiles) == first[-1]
    head = E * K.ROW.itemsize + 8 * (E + 1)
    end = head
    for row, e in zip(rows, entries):
        a, _spec = tfold.split_entry(e)
        want = np.ascontiguousarray(a, np.float32 if row["kind"] ==
                                    K.KIND_F32 else a.dtype).reshape(-1)
        start = int(row["wire"])
        assert start % K.ALIGN == 0 and start >= end
        got = buf[start:start + want.nbytes]
        np.testing.assert_array_equal(got, want.view(np.uint8))
        end = start + want.nbytes
    assert staged.buf.numel() >= end
    moved = K.plan_commit([tfold.split_entry(e) for e in entries],
                          offsets=[1 + 7 * i for i in range(E)])
    assert moved.rows["center"].tolist() == [1 + 7 * i for i in range(E)]
    np.testing.assert_array_equal(moved.rows["wire"], rows["wire"])


def test_packer_refuses_bad_specs_like_the_fold():
    """What the per-tensor fold refuses, the packer refuses before any
    fold: an unknown codec, an int8 spec without a scale, and a compressed
    tensor that is not in its codec's wire dtype (never cast)."""
    q = np.ones(4, np.int8)
    with pytest.raises(ValueError, match="codec"):
        K.plan_commit([(q, {"codec": "zstd"})])
    with pytest.raises(KeyError):
        K.plan_commit([(q, {"codec": "int8"})])
    with pytest.raises(TypeError, match="int8"):
        K.plan_commit([(np.ones(4, np.float32), {"codec": "int8",
                                                  "scale": 1.0})])
    with pytest.raises(TypeError, match="bf16"):
        K.plan_commit([(q, {"codec": "bf16"})])


def test_fold_commit_refuses_a_center_it_does_not_fit():
    staged = tfold.stage_commit([np.ones(4, np.float32)], "cpu")
    with pytest.raises(ValueError, match="elements"):
        K.fold_commit_([torch.ones(5)], staged, 1.0)
    with pytest.raises(ValueError, match="tensors"):
        K.fold_commit_([torch.ones(4), torch.ones(4)], staged, 1.0)
    with pytest.raises(TypeError, match="float32"):
        K.fold_commit_([torch.ones(4, dtype=torch.float64)], staged, 1.0)
    assert K.launch_counts() == {"fold_commit": 0, "fold_int8": 0,
                                 "fold_bf16": 0}


def test_server_seats_its_center_at_the_kernels_offsets():
    """A CPU ``PSServer`` seats its flat center by ``center_layout`` (every
    tensor 64 bytes apart at least), its mirror reads each tensor back
    from its own offset, and a mixed commit folds to the JAX fold's bits."""
    from distkeras_tpu_torch.netps import PSClient, PSServer

    rng = np.random.default_rng(9)
    init = [rng.normal(size=s).astype(np.float32)
            for s in [(3,), (17, 2), (1,), (5, 5)]]
    srv = PSServer(discipline="dynsgd", device="cpu").start()
    try:
        with PSClient(srv.endpoint, worker_id=0, timeout=2.0) as c:
            center, upd = c.join(init=init)
            for a, b in zip(center, init):
                np.testing.assert_array_equal(a, b)
            offsets, total = K.center_layout([a.size for a in init])
            assert srv._offsets == offsets and srv._flat.numel() == total
            for view, off in zip(srv._center, offsets):
                assert view.data_ptr() == srv._flat.data_ptr() + 4 * off
            d = [(rng.normal(size=a.shape) * 0.01).astype(np.float32)
                 for a in init]
            entries = [twire.codec_encode(d[0], "int8"),
                       twire.codec_encode(d[1], "bf16"), d[2],
                       twire.codec_encode(d[3], "int8")]
            c._rpc("commit", {"seq": 0, "pulled": upd}, entries)
        ref = [a.copy() for a in init]
        jfold.fold_delta(ref, entries, "dynsgd", 0)
        for g, r in zip(srv.center(), ref):
            np.testing.assert_array_equal(_bits(g), _bits(r))
    finally:
        srv.close()
