"""distkeras_tpu_torch: the PyTorch/CUDA port of distkeras_tpu for NVIDIA
Hopper (H100).

The JAX package ``distkeras_tpu`` is the reference; this package keeps its
module paths and names, imports nothing of it (nor JAX), and replaces each
of its Pallas TPU kernels on the ported path with a kernel written by hand
in CUDA C++ (``csrc/``), built with ``nvcc`` at first use. Entry points run
on the first CUDA device unless the caller passes ``device="cpu"``, and
raise where there is no card.

Ported so far: serving the IMDB LSTM classifier —
``imdb_lstm(device="cuda")`` -> ``serving.ModelRegistry`` ->
``serving.ServingFrontend`` -> ``serving.ServeClient.infer``.
"""

from distkeras_tpu_torch.models import LSTMClassifier, Model, imdb_lstm

__all__ = ["LSTMClassifier", "Model", "imdb_lstm"]
