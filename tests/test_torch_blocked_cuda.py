"""Multi-round programs on the card: each blocked run (one captured CUDA
graph a block, ``parallel/program.py``) against the per-round run of the
same trainer from the same weights, at small widths. Every test is marked
``cuda`` and skips without a card; the file imports neither JAX nor the
JAX package::

    python -m pytest --noconftest tests/test_torch_blocked_cuda.py -q
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import ADAG, DynSGD, SingleTrainer, telemetry
from distkeras_tpu_torch import resilience
from distkeras_tpu_torch.data import DataFrame
from distkeras_tpu_torch.models import MLP, Model, imdb_lstm
from distkeras_tpu_torch.ops import schedules as S
from distkeras_tpu_torch.ops.kernels import lstm as K

pytestmark = pytest.mark.cuda
LOSS = "sparse_categorical_crossentropy"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _blobs(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, 8)) * 2
    y = rng.integers(0, 3, n).astype(np.int32)
    x = (centers[y] + rng.normal(size=(n, 8))).astype(np.float32)
    return DataFrame({"features": x, "label": y})


def _mlp():
    return Model.build(MLP(hidden=(32,), num_outputs=3, in_features=8),
                       np.zeros((1, 8), np.float32), device="cuda")


def _run(make, df):
    telemetry.reset()
    K.reset_launches()
    t = make()
    out = t.train(df)
    torch.cuda.synchronize()
    snap = telemetry.get().snapshot()
    return (np.asarray(t.get_history()),
            {k: v.detach().cpu() for k, v in out.params.items()},
            K.launch_counts(), snap["counters"].get("program.blocks.graph", 0),
            K.warmup_counts(),
            sum(v["count"] for k, v in snap["spans"].items()
                if k.endswith("program.capture")))


def _same(a, b, rounds=None):
    """``b`` (blocked) equals ``a`` (per round) bit for bit and launched
    its kernels as often, plus one warm-up round a capture."""
    np.testing.assert_array_equal(a[0], b[0])
    for k, v in a[1].items():
        assert torch.equal(v, b[1][k]), k
    assert not any(a[4].values())
    assert {k: v - b[4][k] for k, v in b[2].items()} == a[2]
    rounds = len(a[0]) if rounds is None else rounds
    assert b[4] == {k: v // rounds * b[5] for k, v in a[2].items()}


def test_lstm_dynsgd_graph_is_the_per_round_run(card):
    """Kernels #1 (stash) and #2 inside the graph, DynSGD's rotating
    scales from their table, dropout drawn from the graph's generators;
    R=2 over 5 rounds (a 1-round tail graph)."""
    model = imdb_lstm(vocab_size=64, embed_dim=32, hidden_size=32,
                      seq_len=16, dropout_rate=0.3, device="cuda")
    rng = np.random.default_rng(0)
    n = 5 * 4 * 2 * 16
    df = DataFrame({"features": rng.integers(0, 64, (n, 16)).astype(
        np.int32), "label": rng.integers(0, 2, n).astype(np.int32)})

    def make(rpp):
        return lambda: DynSGD(model, worker_optimizer="sgd", loss=LOSS,
                              num_workers=4, batch_size=16,
                              communication_window=2, learning_rate=0.05,
                              rounds_per_program=rpp)

    per, blocked = _run(make(1), df), _run(make(2), df)
    _same(per, blocked)
    assert blocked[3] == 3 and per[3] == 0 and blocked[5] == 2
    assert per[2]["lstm_fwd_stash"] == 5 * 4 * 2
    assert blocked[4]["lstm_fwd_stash"] == 2 * 4 * 2


def test_adam_schedule_graph_is_the_per_round_run(card):
    """adam's bias corrections and a schedule's step read from their
    tables: a captured division is a multiplication by the reciprocal,
    as PyTorch divides a CUDA tensor by a host float."""
    df = _blobs(7 * 2 * 32)

    def make(rpp):
        return lambda: SingleTrainer(
            _mlp(), "adam", LOSS, batch_size=32, steps_per_program=2,
            learning_rate=S.linear_schedule(0.05, 0.005, 10),
            rounds_per_program=rpp)

    per, blocked = _run(make(1), df), _run(make(3), df)
    _same(per, blocked)
    assert blocked[3] == 3


def test_nan_round_inside_a_graph_is_skipped(card):
    df = _blobs(8 * 2 * 2 * 16)

    def make(rpp):
        return lambda: ADAG(_mlp(), "adam", LOSS, num_workers=2,
                            batch_size=16, communication_window=2,
                            learning_rate=0.05, rounds_per_program=rpp)

    runs = []
    for rpp in (1, 4):
        resilience.reset()
        resilience.set_plan(resilience.FaultPlan.parse("nan@2"))
        try:
            runs.append(_run(make(rpp), df))
        finally:
            resilience.reset()
    _same(runs[0], runs[1])
    h = runs[1][0]
    assert not np.isfinite(h[2]) and np.isfinite(h[3:]).all()


def test_device_transform_draws_are_staged_into_the_graph(card):
    """A ``flip_crop_transform`` inside a captured round: its draws staged
    with the block from the host's chain of seeds, the crop and flip on
    the card; the run is the per-round run's."""
    from distkeras_tpu_torch.models import SimpleCNN
    from distkeras_tpu_torch.ops.augment import flip_crop_transform

    rng = np.random.default_rng(1)
    n = 6 * 2 * 2 * 8
    df = DataFrame({"features": rng.integers(0, 255, (n, 12, 12, 3)).astype(
        np.uint8), "label": rng.integers(0, 3, n).astype(np.int32)})

    def make(rpp):
        def build():
            module = SimpleCNN(conv_features=(8,), dense=(16,),
                               num_outputs=3, input_shape=(12, 12, 3))
            model = Model.build(module, np.zeros((1, 12, 12, 3), np.float32),
                                device="cuda")
            return ADAG(model, "sgd", LOSS, num_workers=2, batch_size=8,
                        communication_window=2, learning_rate=0.05,
                        device_transform=flip_crop_transform(pad=2),
                        rounds_per_program=rpp)
        return build

    per, blocked = _run(make(1), df), _run(make(3), df)
    _same(per, blocked)
    assert blocked[3] == 2
