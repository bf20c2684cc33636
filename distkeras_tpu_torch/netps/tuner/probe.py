"""Join-time micro A/B probes: timed probe ops per candidate codec (the
port's copy of the JAX package's ``netps/tuner/probe.py``).

A probe is one round trip of the *actual* commit payload (the joined
center's tensor shapes) encoded under a candidate codec, answered by the
server's ``probe`` op — which decodes it as a commit is decoded (so a
quantized candidate pays the real dequantize cost; on the card, one
``fold_commit`` launch into a scratch window) but never touches the
center, the journal or the dedup table. The score is **logical f32 bytes
per second of round trip**: a codec that shrinks the wire 4x wins on a
slow link even after paying its quantize passes, and loses on the shm
ring where payload copies run at memcpy speed.

Old peers are unaffected by construction: the client only probes a peer
whose join reply carried the ``tuner`` caps bit; anything else returns
an empty result list and the static knobs stand.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.netps.errors import NetPSError
from distkeras_tpu_torch.runtime import config


class ProbeResult(NamedTuple):
    """One candidate's timed micro A/B outcome. ``score`` is logical f32
    payload bytes moved per second of round-trip wall time — directly
    comparable across codecs because every candidate carries the SAME
    logical payload."""

    codec: str
    probes: int
    seconds: float
    payload_bytes: int
    score: float


def probe_codecs(client, template: Sequence[np.ndarray],
                 candidates: Optional[Sequence[str]] = None,
                 probes: Optional[int] = None) -> list:
    """Run the join-time micro A/B against ``client``'s joined peer.

    Returns one :class:`ProbeResult` per candidate codec, or ``[]`` when
    the peer does not advertise the ``tuner`` caps bit (old peer — left
    alone) or a probe fails mid-sweep (partial evidence is worse than
    none; the static knobs stand)."""
    caps = client.peer_caps or {}
    if not caps.get("tuner"):
        return []
    if probes is None:
        probes = config.env_int("DKTPU_TUNE_PROBES")
    probes = max(1, int(probes))
    if candidates is None:
        advertised = caps.get("codecs", ())
        candidates = [c for c in wire.CODECS
                      if c == wire.CODEC_NONE or c in advertised]
    payload = [np.ascontiguousarray(a, np.float32) for a in template]
    payload_bytes = sum(a.nbytes for a in payload)
    results: list = []
    for codec in candidates:
        t0 = time.monotonic()
        try:
            for _ in range(probes):
                hdr = client.probe(payload, codec=codec)
                if hdr is None:
                    return results
        except (NetPSError, OSError):
            # A probe is an optimisation, never a liability: a fault
            # mid-sweep (chaos, flaky link) abandons the sweep and the
            # static knobs stand — it must not kill the training run.
            return results
        dt = max(time.monotonic() - t0, 1e-9)
        res = ProbeResult(
            codec=codec, probes=probes, seconds=round(dt, 6),
            payload_bytes=payload_bytes * probes,
            score=round(payload_bytes * probes / dt, 1))
        results.append(res)
        telemetry.counter("tuner.probes").add(probes)
        telemetry.event("tuner_probe", {
            "codec": codec, "probes": probes, "seconds": res.seconds,
            "score": res.score})
    return results


def best_codec(results: Sequence[ProbeResult]) -> Optional[str]:
    """The winning candidate, or None with no evidence (empty sweep)."""
    if not results:
        return None
    return max(results, key=lambda r: r.score).codec
