"""Runtime lock-order witness: the dynamic complement of DK201 (the JAX
package's ``analysis/witness.py``, over the port's locks).

The static lock graph (``rules_concurrency.build_lock_graph``) cannot see
cross-module acquisition chains (it resolves calls one level deep, same
module only). This witness closes that gap at test time: enable it around a
threaded scenario and every ``threading.Lock``/``RLock`` **created while it
is active** is wrapped so that each successful acquisition records
"acquired B while holding A" edges into one shared order graph. Tests then
assert the observed order is consistent (acyclic) and contained in the
statically derived graph:

    with witness() as w:
        run_raced(...)                      # or any threaded scenario
    w.assert_no_inversions()
    assert w.edges() <= static_edges        # static graph is sound

Locks created *before* the context manager are untouched (torch internals,
module-global locks imported earlier), so the witness only pays its ~µs
bookkeeping on the code under test. A lock's label is its creation site,
``modbase.Class.attr`` / ``modbase.NAME``: the ids the port's
``rules_concurrency.build_lock_graph`` gives the same locks, so witnessed
edges compare directly with the static graph. The wrapper is duck-compatible with
``threading.Condition``'s non-RLock fallback (it deliberately does NOT
expose ``_is_owned``/``_release_save``), so ``queue.Queue`` built during
the window keeps working.
"""

from __future__ import annotations

import contextlib
import linecache
import re
import sys
import threading
import _thread

_SELF_ATTR_RE = re.compile(r"self\.(\w+)\s*=")
_NAME_RE = re.compile(r"^\s*(\w+)\s*=")


def _creation_label() -> str:
    """Label the lock by its creation site, matching the static graph's ids
    (``modbase.Class.attr`` / ``modbase.NAME``) when the site is a simple
    ``self.X = Lock()`` / ``X = Lock()`` assignment."""
    frame = sys._getframe(2)
    while frame is not None:
        fn = frame.f_code.co_filename
        if "analysis/witness" not in fn.replace("\\", "/") and \
                "threading" not in fn and "queue" not in fn:
            break
        frame = frame.f_back
    if frame is None:
        return "<unknown>"
    modbase = frame.f_code.co_filename.rsplit("/", 1)[-1].removesuffix(".py")
    line = linecache.getline(frame.f_code.co_filename, frame.f_lineno)
    m = _SELF_ATTR_RE.search(line)
    if m is not None and "self" in frame.f_locals:
        cls = type(frame.f_locals["self"]).__name__
        return f"{modbase}.{cls}.{m.group(1)}"
    m = _NAME_RE.match(line)
    if m is not None:
        return f"{modbase}.{m.group(1)}"
    return f"{modbase}:{frame.f_lineno}"


class LockOrderWitness:
    """The shared order graph; one instance per :func:`witness` window."""

    def __init__(self):
        self._edges: dict = {}   # (a, b) -> first-seen (thread name, b site)
        self._meta_lock = _thread.allocate_lock()  # real lock: no recursion
        self._held = threading.local()

    # -- bookkeeping called by _WitnessLock --------------------------------
    def _stack(self) -> list:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def _acquired(self, label: str) -> None:
        st = self._stack()
        with self._meta_lock:
            for held in st:
                if held != label:
                    self._edges.setdefault(
                        (held, label), threading.current_thread().name)
        st.append(label)

    def _released(self, label: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == label:
                del st[i]
                return

    # -- assertions --------------------------------------------------------
    def edges(self) -> set:
        with self._meta_lock:
            return set(self._edges)

    def cycles(self) -> list:
        graph: dict = {}
        for a, b in self.edges():
            graph.setdefault(a, set()).add(b)
        cycles, state = [], {}

        def dfs(n, stack):
            state[n] = 1
            for m in graph.get(n, ()):
                if state.get(m, 0) == 1:
                    cycles.append(stack[stack.index(m):] + [m])
                elif state.get(m, 0) == 0:
                    dfs(m, stack + [m])
            state[n] = 2

        for n in sorted(graph):
            if state.get(n, 0) == 0:
                dfs(n, [n])
        return cycles

    def assert_no_inversions(self) -> None:
        cycles = self.cycles()
        if cycles:
            rendered = "; ".join(" -> ".join(c) for c in cycles)
            raise AssertionError(
                f"lock-order inversion observed at runtime: {rendered}")


class _WitnessLock:
    """Wrapper over a real Lock/RLock that reports to the witness."""

    def __init__(self, inner, witness: LockOrderWitness, label: str):
        self._inner = inner
        self._witness = witness
        self._label = label

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness._acquired(self._label)
        return got

    def release(self) -> None:
        self._inner.release()
        self._witness._released(self._label)

    def locked(self) -> bool:
        inner = getattr(self._inner, "locked", None)  # RLock lacks it on 3.10
        return bool(inner()) if inner is not None else False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<witnessed {self._label} {self._inner!r}>"


@contextlib.contextmanager
def witness():
    """Patch ``threading.Lock``/``RLock`` so locks created in this window
    report acquisition order; yields the :class:`LockOrderWitness`."""
    w = LockOrderWitness()
    orig_lock, orig_rlock = threading.Lock, threading.RLock

    def make(ctor):
        def factory():
            return _WitnessLock(ctor(), w, _creation_label())
        return factory

    threading.Lock = make(orig_lock)
    threading.RLock = make(orig_rlock)
    try:
        yield w
    finally:
        threading.Lock = orig_lock
        threading.RLock = orig_rlock
