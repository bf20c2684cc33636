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

With ``--upstream host:port`` the process runs as an interior
aggregation-tree node (``TreeNode``) instead: it absorbs its children's
commits into a window on its device (one fold-kernel launch a commit),
journals them in absorb order under ``--state-dir``, and flushes combined
windows into the upstream — ``--tree-level``/``--tree-group`` locate it in
the ``--tree-spec`` (``DKTPU_TREE_SPEC``) shape and key its uplink for
``link_down``/``link_flap`` chaos, ``--tree-buffer`` bounds partition
ride-through, ``--fan-in`` and ``--flush-interval`` set when a window
leaves. ``--upstream`` plus ``--standby`` runs the node's warm
``TreeStandby``, which on promotion fences the dead node AND joins the
upstream itself. ``--shard`` and ``--upstream`` are exclusive: shard the
root and point ``--upstream`` at its ``;`` matrix.

The process labels its trace and flight streams with its role (``ps``,
``standby``, ``shard<K>``, ``tree<L>g<G>``, ``tree<L>g<G>-standby``; an
explicit ``DKTPU_TRACE_ROLE`` wins), flight-dumps on an unhandled crash
and on the first SIGTERM (``DKTPU_TRACE=1``), samples vitals every
``DKTPU_VITALS_S`` seconds, and at exit writes its telemetry beside its
trace stream as ``telemetry-<role>-<pid>.jsonl`` in ``DKTPU_TRACE_DIR``
(falling back to the state dir), which ``python -m
distkeras_tpu_torch.telemetry report --trace <dir>`` merges.
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
from distkeras_tpu_torch.telemetry import tracing

#: exit status of a second-signal forced abort.
ABORT_STATUS = 70


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
    ap.add_argument("--upstream", metavar="HOST:PORT[,...]", default=None,
                    help="run as an interior aggregation-tree node that "
                         "absorbs its children's commits and flushes "
                         "combined windows into this upstream (comma list "
                         "= failover walk). With --standby, run as that "
                         "tree node's warm TreeStandby instead.")
    ap.add_argument("--tree-level", type=int, default=0,
                    help="this node's level in DKTPU_TREE_SPEC / "
                         "--tree-spec (0 = leaf-most interior level)")
    ap.add_argument("--tree-group", type=int, default=0,
                    help="this node's group index within its level")
    ap.add_argument("--tree-spec", default=None,
                    help="bottom-up tree grammar name:fanout[:codec],... "
                         "(default DKTPU_TREE_SPEC)")
    ap.add_argument("--tree-buffer", type=int, default=None,
                    help="partition ride-through bound in combined "
                         "windows (default DKTPU_TREE_BUFFER)")
    ap.add_argument("--fan-in", type=int, default=None,
                    help="tree node flush fan-in (default: full local "
                         "membership)")
    ap.add_argument("--flush-interval", type=float, default=None,
                    help="tree node max window age (seconds) before an "
                         "undersized window flushes anyway")
    args = ap.parse_args(argv)
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
    tree_spec = (args.tree_spec if args.tree_spec is not None
                 else config.env_str("DKTPU_TREE_SPEC") or None)
    if args.upstream and shard_index is not None:
        ap.error("--shard and --upstream are mutually exclusive: an "
                 "interior tree node is never itself a shard (shard the "
                 "ROOT and point --upstream at the `;` matrix instead)")
    kw = dict(discipline=args.discipline, host=args.host, port=args.port,
              lease_s=args.lease, device=args.device, state_dir=state_dir,
              snapshot_every=args.snapshot_every)
    if not args.upstream:
        kw.update(shard_index=shard_index, shard_count=shard_count)
    # Label this process for the trace and flight streams (an explicit
    # DKTPU_TRACE_ROLE wins) and arm the crash-path flight-recorder dump
    # before anything can fail.
    if args.upstream and standby_of:
        tracing.set_role(f"tree{args.tree_level}g{args.tree_group}-standby")
    elif args.upstream:
        tracing.set_role(f"tree{args.tree_level}g{args.tree_group}")
    elif standby_of:
        tracing.set_role("standby")
    elif shard_index is not None:
        tracing.set_role(f"shard{shard_index}")
    else:
        tracing.set_role("ps")
    tracing.install_crash_hooks()
    from distkeras_tpu_torch.telemetry.vitals import start_vitals

    start_vitals()  # no-op unless DKTPU_VITALS_S is set
    tree_kw = dict(level=args.tree_level, group=args.tree_group,
                   spec=tree_spec, buffer_windows=args.tree_buffer,
                   fan_in=args.fan_in)
    if args.flush_interval is not None:
        tree_kw["flush_interval"] = args.flush_interval
    if args.upstream and standby_of:
        from distkeras_tpu_torch.netps.tree import TreeStandby

        server = TreeStandby(standby_of, upstream=args.upstream,
                             promote_after=args.promote_after,
                             **tree_kw, **kw).start()
    elif args.upstream:
        from distkeras_tpu_torch.netps.tree import TreeNode

        server = TreeNode(args.upstream, **tree_kw, **kw).start()
    elif standby_of:
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
            # Dump the flight ring while the process is still healthy: the
            # drain may take seconds and a second signal force-exits. A
            # no-op with tracing off; once per reason.
            tracing.flight_dump("sigterm")
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
    trace_d = tracing.trace_dir()
    if trace_d:
        # Final telemetry dump beside the trace stream: the collector
        # merges this process's counters and events into the timeline.
        from distkeras_tpu_torch import telemetry

        try:
            os.makedirs(trace_d, exist_ok=True)
            telemetry.write_jsonl(
                telemetry.get(),
                os.path.join(trace_d,
                             f"telemetry-{tracing.role()}-{os.getpid()}"
                             ".jsonl"))
        except OSError:
            pass
    print(f"NETPS_DRAINED commits={server.commits_total} "
          f"epoch={server.epoch} snapshots={server.snapshots_written} "
          f"evictions={server.evictions} rejoins={server.rejoins}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
