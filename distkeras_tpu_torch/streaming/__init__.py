"""Streaming plane of the port (counterpart of the JAX package's
``distkeras_tpu/streaming/``).

For now it holds the claim queue alone: :class:`~distkeras_tpu_torch.
streaming.items.WorkQueue`, bounded (``total=``, what the fleet's
:class:`~distkeras_tpu_torch.fleet.run.ElasticTraining` claims its
``(round, slice)`` items from) and open-ended (``put``/``close_intake``).
The rest of the streaming runtime — the sources, the stream trainer and
its online evaluation — is a later slice.
"""

from distkeras_tpu_torch.streaming.items import WorkQueue

__all__ = ["WorkQueue"]
