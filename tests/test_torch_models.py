"""The port's IMDB LSTM classifier (``distkeras_tpu_torch/models/``) against
the JAX package's, on parameters carried across by
``distkeras_tpu_torch.convert.params_from_jax``: both JAX layouts (packed
``cell_impl="pallas"`` and per-gate ``cell_impl="xla"``) serve through
the same port module. f32 logits within 1e-5."""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models.base import normalize_features as jax_normalize
from distkeras_tpu.models.lstm import imdb_lstm as jax_imdb_lstm
from distkeras_tpu_torch.convert import params_from_jax
from distkeras_tpu_torch.models import imdb_lstm, normalize_features
from distkeras_tpu_torch.models.base import Model

SMALL = dict(vocab_size=50, embed_dim=8, hidden_size=8, seq_len=6)


def port_from_jax(jm):
    pm = imdb_lstm(**SMALL, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    pm.module.load_state_dict(params_from_jax(tree, pm.module))
    return pm


@pytest.mark.parametrize("cell_impl", ["pallas", "xla"])
def test_logits_match_jax_predict(cell_impl):
    jm = jax_imdb_lstm(**SMALL, cell_impl=cell_impl)
    pm = port_from_jax(jm)
    tokens = np.random.default_rng(0).integers(0, 50, (5, 6)).astype(
        np.int32)
    got = pm.predict(tokens).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.predict(tokens)),
                               rtol=1e-5, atol=1e-5)
    assert got.shape == (5, 2)


def test_convert_rejects_mismatched_widths():
    jm = jax_imdb_lstm(**SMALL, cell_impl="pallas")
    pm = imdb_lstm(vocab_size=50, embed_dim=8, hidden_size=4, seq_len=6,
                   device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                        pm.module)


def test_seeded_init_is_deterministic():
    a = imdb_lstm(**SMALL, seed=3, device="cpu").module.state_dict()
    b = imdb_lstm(**SMALL, seed=3, device="cpu").module.state_dict()
    c = imdb_lstm(**SMALL, seed=4, device="cpu").module.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["lstm_wh"], c["lstm_wh"])


def test_uint8_normalization_matches_jax(monkeypatch):
    from distkeras_tpu_torch.models import base

    monkeypatch.setattr(base, "_uint8_warned", [False])  # one-time notice
    x = np.random.default_rng(1).integers(0, 256, (3, 4)).astype(np.uint8)
    with pytest.warns(UserWarning, match="uint8"):
        ours = normalize_features(torch.from_numpy(x))
    theirs = np.asarray(jax_normalize(x))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-7)
    # opted out, and integer tokens: untouched
    assert normalize_features(torch.from_numpy(x), False).dtype == torch.uint8
    toks = torch.arange(6, dtype=torch.int32)
    assert normalize_features(toks) is toks


def test_model_apply_normalizes_uint8_inputs():
    lin = torch.nn.Linear(4, 2)
    m = Model.build(lin, np.zeros((1, 4), np.uint8), device="cpu")
    x = np.full((2, 4), 255, np.uint8)
    with torch.no_grad():
        want = lin(torch.ones(2, 4))
    torch.testing.assert_close(m.predict(x), want)
