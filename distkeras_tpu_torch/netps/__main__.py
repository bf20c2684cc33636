"""CLI: run a standalone parameter server of the port, its center on the
card unless ``--device cpu``::

    python -m distkeras_tpu_torch.netps --host 0.0.0.0 --port 7077 \
        --discipline dynsgd --lease 10 --device cuda

The server starts uninitialized — the first worker's ``join`` seeds the
center with its model parameters, so this process needs no model. With
``--state-dir`` (``DKTPU_PS_STATE_DIR``) every folded commit is journaled
and the center snapshotted (``--snapshot-every`` /
``DKTPU_PS_SNAPSHOT_EVERY``), so a SIGKILLed server relaunched on the same
directory resumes its center (replayed on the card), counter and dedup
state. With ``--standby host:port`` (``DKTPU_PS_STANDBY``) the process
runs as a warm standby of that primary: it tails the journal stream,
serves nothing until the primary has been silent for ``--promote-after``
seconds (default: the lease), then promotes (printing ``NETPS_PROMOTED
epoch=N``) and fences the old lineage.

With ``DKTPU_NET_TRANSPORT=shm`` the server also serves the same-host
shared-memory ring (colocated workers asking for ``shm`` upgrade to it);
``mesh`` needs the workers in this process, so a standalone server serves
it to nobody and only the ring and TCP are used.

It prints ``NETPS_READY <host:port>`` once listening and runs until
SIGTERM/SIGINT, then drains gracefully (late clients get a typed
``ServerDrainingError``). The FIRST signal prints ``NETPS_DRAINING`` at
signal time; a SECOND signal during the drain force-exits with status 70.

With ``--shard K/N`` the process serves shard K (0-based) of an N-shard
center: it adopts the partition plan from the first sharded client's join
and persists it as ``plan.json`` under ``--state-dir``, where a restart
finds it and refuses a drifted plan. Workers dial the gang as one ``;``
endpoint matrix (``host:p0;host:p1``, each shard's standbys after a
``,``).

``DKTPU_NET_FAULTS`` in the server's environment schedules its own chaos
(``ps_hang@R:S``, ``ps_crash@R``, ``shard_crash@K:R``); with
``DKTPU_FAULTS_STATE`` the fired faults are journaled, so a restarted life
does not crash again.

The JAX server's flags for aggregation-tree nodes (``--upstream``,
``--tree-*``, ``--fan-in``, ``--flush-interval``) are accepted and
refused: those features come with a later slice of the port.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from distkeras_tpu_torch.netps.fold import SUPPORTED_DISCIPLINES
from distkeras_tpu_torch.netps.server import PSServer
from distkeras_tpu_torch.netps.standby import StandbyServer
from distkeras_tpu_torch.runtime import config

#: exit status of a second-signal forced abort.
ABORT_STATUS = 70

#: the JAX CLI's flags whose features are not ported yet.
_NOT_PORTED = ("upstream", "tree_level", "tree_group", "tree_spec",
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
    ap.add_argument("--state-dir", default=None,
                    help="durable journal+snapshot directory (default "
                         "DKTPU_PS_STATE_DIR; empty = in-memory only)")
    ap.add_argument("--snapshot-every", type=int, default=None,
                    help="folds between center snapshots (default "
                         "DKTPU_PS_SNAPSHOT_EVERY)")
    ap.add_argument("--standby", metavar="HOST:PORT", default=None,
                    help="run as a warm standby of this primary (default "
                         "DKTPU_PS_STANDBY; empty = run as a primary)")
    ap.add_argument("--promote-after", type=float, default=None,
                    help="seconds of primary silence before a standby "
                         "promotes itself (default: the lease)")
    ap.add_argument("--shard", metavar="K/N", default=None,
                    help="serve shard K of an N-shard center (0-based); "
                         "the partition plan is adopted from the first "
                         "join (and persisted under --state-dir). Applies "
                         "to primaries and standbys alike.")
    for name in _NOT_PORTED:
        ap.add_argument("--" + name.replace("_", "-"), default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [n for n in _NOT_PORTED if getattr(args, n) is not None]
    if given:
        ap.error(f"--{given[0].replace('_', '-')} is not ported to "
                 f"distkeras_tpu_torch yet (aggregation-tree nodes come "
                 f"with a later slice)")
    shard_index = shard_count = None
    if args.shard:
        try:
            k, n = args.shard.split("/", 1)
            shard_index, shard_count = int(k), int(n)
        except ValueError:
            ap.error(f"--shard must be K/N (got {args.shard!r})")
        if not 0 <= shard_index < shard_count:
            ap.error(f"--shard {args.shard}: K must be in 0..N-1")
    state_dir = (args.state_dir if args.state_dir is not None
                 else config.env_str("DKTPU_PS_STATE_DIR") or None)
    standby_of = (args.standby if args.standby is not None
                  else config.env_str("DKTPU_PS_STANDBY") or None)
    kw = dict(discipline=args.discipline, host=args.host, port=args.port,
              lease_s=args.lease, device=args.device, state_dir=state_dir,
              snapshot_every=args.snapshot_every, shard_index=shard_index,
              shard_count=shard_count)
    if standby_of:
        server = StandbyServer(standby_of, promote_after=args.promote_after,
                               **kw).start()
    else:
        server = PSServer(**kw).start()
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
    announced = False
    while not stop.wait(0.2):
        if not announced and getattr(server, "promoted", False):
            announced = True
            print(f"NETPS_PROMOTED epoch={server.epoch}", flush=True)
    server.close()
    print(f"NETPS_DRAINED commits={server.commits_total} "
          f"epoch={server.epoch} snapshots={server.snapshots_written} "
          f"evictions={server.evictions} rejoins={server.rejoins}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
