"""CLI: run a standalone parameter server of the port, its center on the
card unless ``--device cpu``::

    python -m distkeras_tpu_torch.netps --host 0.0.0.0 --port 7077 \
        --discipline dynsgd --lease 10 --device cuda

The server starts uninitialized — the first worker's ``join`` seeds the
center with its model parameters, so this process needs no model. It prints
``NETPS_READY <host:port>`` once listening and runs until SIGTERM/SIGINT,
then drains gracefully (late clients get a typed ``ServerDrainingError``).
The FIRST signal prints ``NETPS_DRAINING`` at signal time; a SECOND signal
during the drain force-exits with status 70.

The JAX server's flags for durable state, warm standbys, shards and
aggregation-tree nodes are accepted and refused: those features come with
later slices of the port.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from distkeras_tpu_torch.netps.fold import SUPPORTED_DISCIPLINES
from distkeras_tpu_torch.netps.server import PSServer

#: exit status of a second-signal forced abort.
ABORT_STATUS = 70

#: the JAX CLI's flags whose features are not ported yet.
_NOT_PORTED = ("state_dir", "snapshot_every", "standby", "promote_after",
               "shard", "upstream", "tree_level", "tree_group", "tree_spec",
               "tree_buffer", "fan_in", "flush_interval")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distkeras_tpu_torch.netps",
        description="Standalone networked parameter server (PyTorch port).")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7077)
    ap.add_argument("--discipline", default="adag",
                    choices=sorted(SUPPORTED_DISCIPLINES))
    ap.add_argument("--lease", type=float, default=None,
                    help="membership lease seconds (default DKTPU_PS_LEASE)")
    ap.add_argument("--device", default=None,
                    help="where the center lives: cuda (the default; "
                         "raises without a card) or cpu")
    for name in _NOT_PORTED:
        ap.add_argument("--" + name.replace("_", "-"), default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [n for n in _NOT_PORTED if getattr(args, n) is not None]
    if given:
        ap.error(f"--{given[0].replace('_', '-')} is not ported to "
                 f"distkeras_tpu_torch yet (durable state, standbys, shards "
                 f"and tree nodes come with later slices)")
    server = PSServer(discipline=args.discipline, host=args.host,
                      port=args.port, lease_s=args.lease,
                      device=args.device).start()
    stop = threading.Event()
    signals_seen = [0]

    def _stop(signum, frame):
        signals_seen[0] += 1
        if signals_seen[0] == 1:
            os.write(1, b"NETPS_DRAINING\n")
            stop.set()
        else:
            os.write(1, b"NETPS_ABORTED\n")
            os._exit(ABORT_STATUS)

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    print(f"NETPS_READY {server.endpoint}", flush=True)
    while not stop.wait(0.2):
        pass
    server.close()
    print(f"NETPS_DRAINED commits={server.commits_total} "
          f"evictions={server.evictions} rejoins={server.rejoins}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
