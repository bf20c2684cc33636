"""Per-host port pool: bind-probed allocation (the port's copy of the JAX
package's ``fleet/ports.py``).

Ports handed out are

* **probe-verified** — a candidate is bound (``SO_REUSEADDR`` off, so a
  TIME_WAIT socket still rejects it) and released before being returned;
* **process-unique** — reserved ports are remembered, so two servers set
  up in the same process can never collide even before either binds;
* **deterministically walked** — candidates rotate through a fixed range,
  so retries make progress instead of re-probing the same busy port.

Cross-process races (another process grabbing the port between probe and
use) remain possible as with any probe-then-bind scheme.
"""

from __future__ import annotations

import socket
import threading

#: default allocation range: above the registered-port churn, below the
#: common ephemeral range (32768+).
PORT_LO = 20000
PORT_HI = 32000


class PortPool:
    """One host's allocator. ``reserve()`` returns a probe-verified port
    and remembers it; ``release()`` returns it to the pool."""

    def __init__(self, lo: int = PORT_LO, hi: int = PORT_HI):
        if not 0 < lo < hi <= 65536:
            raise ValueError(f"bad port range [{lo}, {hi})")
        self._lo, self._hi = int(lo), int(hi)
        self._next = int(lo)
        self._reserved: set = set()
        self._lock = threading.Lock()

    def reserve(self, host: str = "127.0.0.1", tries: int = 256,
                probe: bool = True) -> int:
        """One free port: walk candidates, skip same-process reservations,
        bind-probe the rest (``probe=False`` skips the probe for remote
        hosts), retry up to ``tries`` before raising ``OSError``."""
        for _ in range(int(tries)):
            with self._lock:
                port = self._next
                self._next = port + 1 if port + 1 < self._hi else self._lo
                if port in self._reserved:
                    continue
            if probe and not _probe(host, port):
                continue
            with self._lock:
                if port in self._reserved:  # lost a race to another thread
                    continue
                self._reserved.add(port)
            return port
        raise OSError(
            f"no free port on {host} in [{self._lo}, {self._hi}) "
            f"after {tries} probes")

    def release(self, port: int) -> None:
        with self._lock:
            self._reserved.discard(int(port))

    def reserved(self) -> set:
        with self._lock:
            return set(self._reserved)


def _probe(host: str, port: int) -> bool:
    """Can we bind ``host:port`` right now? The socket is closed again —
    the caller's server performs the real bind."""
    probe_host = "" if host in ("0.0.0.0", "") else host
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.bind((probe_host, port))
        finally:
            s.close()
    except OSError:
        return False
    return True


#: the process-ambient pool (ports are a host resource; one pool per
#: process keeps same-process servers disjoint by construction).
_POOL = PortPool()


def reserve_port(host: str = "127.0.0.1") -> int:
    """Reserve one port from the ambient pool. Local hosts are
    bind-probed; a remote ``host`` gets a process-unique (unprobed)
    reservation."""
    local = host in ("127.0.0.1", "localhost", "0.0.0.0", "")
    return _POOL.reserve("127.0.0.1" if local else host, probe=local)


def release_port(port: int) -> None:
    _POOL.release(port)
