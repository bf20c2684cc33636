"""Streaming continual training: the online-learning loop, closed (the
port's counterpart of the JAX package's ``distkeras_tpu/streaming/``).

The connective tissue between the pieces the port already has — the netps
parameter server, the elastic claim queue, checkpoint/restore, the serving
``ModelRegistry``'s hot swap, and the health plane's alert manager —
turned into one loop::

    source -> RoundFeeder staging -> claim queue -> train -> commit(PS)
       ^                                              |
       |            OffsetJournal (durable)  <--------+
       |                                              v
    resume at last committed offset     checkpoint -> hot-swap -> serve

* :mod:`~distkeras_tpu_torch.streaming.source` — the stream source
  contract (file tail + socket feed, the JAX package's wire) with fault
  injection (``feed_gap@R:S``, ``drift@R``) and a record codec.
* :mod:`~distkeras_tpu_torch.streaming.journal` — the durable
  :class:`OffsetJournal`: the exactly-once ingest argument lives there.
* :mod:`~distkeras_tpu_torch.streaming.items` — :class:`WorkQueue`, the
  claim queue, bounded (ElasticTraining's ``rounds x W`` schedule) and
  open-ended.
* :mod:`~distkeras_tpu_torch.streaming.evaluate` — windowed online eval +
  :class:`DriftWatch` (loss-divergence pages via ``AlertManager``,
  checkpoint-on-drift, recovery timing, the registry's regression gate).
* :mod:`~distkeras_tpu_torch.streaming.runtime` —
  :class:`StreamingTraining`, the fleet-schedulable runtime tying it
  together (its windows and its parameter server on the card), and
  :class:`StreamingSession`, the Supervisor-compatible wrapper.
"""

from distkeras_tpu_torch.streaming.evaluate import DriftWatch, WindowedEval
from distkeras_tpu_torch.streaming.items import WorkQueue
from distkeras_tpu_torch.streaming.journal import (
    OffsetJournal,
    replayed_offsets,
)
from distkeras_tpu_torch.streaming.runtime import (
    StreamingSession,
    StreamingTraining,
)
from distkeras_tpu_torch.streaming.source import (
    FileTailSource,
    SocketSource,
    StreamFileWriter,
    StreamProducer,
    StreamRecord,
    decode_record,
    encode_record,
)

__all__ = [
    "DriftWatch",
    "FileTailSource",
    "OffsetJournal",
    "SocketSource",
    "StreamFileWriter",
    "StreamProducer",
    "StreamRecord",
    "StreamingSession",
    "StreamingTraining",
    "WindowedEval",
    "WorkQueue",
    "decode_record",
    "encode_record",
    "replayed_offsets",
]
