"""DK5xx — durability and ordering discipline for the distributed planes
(the JAX package's ``analysis/rules_durability.py``, on the port).

Two bug classes that each cost a human review pass to catch get rules:

* **DK501** — a blocking call while holding a *durable-state* lock: a
  first-touch backend resolution (seconds of compile) run under the PS
  center lock stalls every worker. The rule extends the DK202
  guarded-attr model with a blocking-call taxonomy (socket/file I/O,
  ``time.sleep``, backend first-touch) and fires when such a call sits
  *lexically* inside ``with <lock>:`` for a lock whose guarded attributes
  include the center / journal / commit state. Lexical on purpose: the
  journal's ``fsync`` lives in a helper *called* under its lock — that is
  the deliberate durability write, not a hazard; the rule flags the
  direct form that stalls the plane.
* **DK502** — ACK/reply emission reachable before the corresponding
  journal append in the same handler. The OffsetJournal discipline is
  intent-before-RPC: a commit RPC (or reply/ACK write) that precedes the
  ``journal.intent()`` / ``fsync`` / ``write_epoch`` in its function
  reopens the crash window the journal exists to close (a fence that is
  acknowledged before it is durable). Checked as an intra-function
  ordering graph: first emission site vs first durable site.
"""

from __future__ import annotations

import ast

from distkeras_tpu_torch.analysis.core import (
    Finding, Module, RuleInfo, call_name, module_rule, walk)
from distkeras_tpu_torch.analysis.rules_concurrency import (
    _attr_writes_shallow, _ModuleLocks)

#: attr-name substrings marking a lock as guarding durable plane state.
_DURABLE_STATE = ("center", "journal", "store", "frontier", "intent",
                  "commit", "last_seq", "epoch", "ahead")

#: call names (dotted, or bare) that block: file/socket I/O, sleeps, and
#: backend first-touch (compile / backend resolution; the ``jax.`` names
#: are kept so the rule reads the same on either package's code).
_BLOCKING_EXACT = frozenset({
    "open", "os.fsync", "os.replace", "os.rename", "time.sleep",
    "socket.create_connection", "socket.create_server",
    "resolve_backend",
})
_BLOCKING_ATTRS = frozenset({
    # any receiver: socket/file verbs + first-touch entry points
    "sleep", "connect", "accept", "recv", "recv_into", "sendall",
    "makefile", "fsync", "resolve_backend", "block_until_ready",
    "device_put", "jit", "compile",
})

#: DK502 call taxonomies. Durable = the journal/epoch write that must
#: come first; emit = the RPC/ACK that makes the result visible.
_DURABLE_CALL_ATTRS = frozenset({
    "intent", "fsync", "write_epoch", "_persist_locked",
})
_EMIT_ATTRS = frozenset({"commit", "sendall", "send_frame", "request"})
_EMIT_RECEIVER_HINTS = ("client", "conn", "sock", "peer", "sub", "ps")


def _guarded_durable_locks(mod: Module, info: _ModuleLocks,
                           cls_node: ast.ClassDef) -> set:
    """Lock attr names of ``cls_node`` whose guarded writes touch durable
    plane state (the DK202 locked-writes map, filtered)."""
    lock_attrs = info.class_locks.get(cls_node.name, set())
    if not lock_attrs:
        return set()
    durable: set = set()

    def scan(node, held: set) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in node.items:
                expr = item.context_expr
                if (isinstance(expr, ast.Attribute)
                        and isinstance(expr.value, ast.Name)
                        and expr.value.id == "self"
                        and info.resolve(expr, cls_node.name)):
                    inner.add(expr.attr)
            for child in node.body:
                scan(child, inner)
            return
        for attr, _site in _attr_writes_shallow(node):
            if attr in lock_attrs:
                continue
            if held and any(s in attr.lower() for s in _DURABLE_STATE):
                durable.update(held)
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                scan(child, held)

    for meth in cls_node.body:
        if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for child in meth.body:
                scan(child, set())
    return durable & lock_attrs


def _is_blocking(node: ast.Call) -> str:
    name = call_name(node.func)
    if name in _BLOCKING_EXACT:
        return name
    last = name.rsplit(".", 1)[-1]
    if last in _BLOCKING_ATTRS and "." in name:
        return name
    # jax.* first-touch anywhere under the lock is a compile hazard
    if name.startswith("jax."):
        return name
    return ""


@module_rule(
    RuleInfo("DK501", "blocking call while holding a durable-state lock"),
)
def check_blocking_under_lock(mod: Module) -> list:
    out: list = []
    info = _ModuleLocks(mod)
    for cls_node in [n for n in walk(mod.tree)
                     if isinstance(n, ast.ClassDef)]:
        durable_locks = _guarded_durable_locks(mod, info, cls_node)
        if not durable_locks:
            continue

        def scan(node, held: bool) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = held
                for item in node.items:
                    expr = item.context_expr
                    if (isinstance(expr, ast.Attribute)
                            and isinstance(expr.value, ast.Name)
                            and expr.value.id == "self"
                            and expr.attr in durable_locks):
                        inner = True
                for child in node.body:
                    scan(child, inner)
                return
            if held and isinstance(node, ast.Call):
                what = _is_blocking(node)
                if what:
                    out.append(Finding(
                        mod.path, node.lineno, node.col_offset, "DK501",
                        f"`{what}()` while holding a lock guarding "
                        "center/journal state: blocking here stalls every "
                        "worker on the plane (a first-touch resolve under "
                        "the center lock) — move the call before the lock"))
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Lambda)):
                    scan(child, held)

        for meth in cls_node.body:
            if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for child in meth.body:
                    scan(child, False)
    return out


def _durable_call(node: ast.Call) -> bool:
    name = call_name(node.func)
    last = name.rsplit(".", 1)[-1]
    if name == "os.fsync":
        return True
    if last not in _DURABLE_CALL_ATTRS:
        return False
    if last in ("write_epoch", "_persist_locked", "fsync"):
        return True
    # `.intent(...)`: require a journal-ish receiver so unrelated APIs
    # named `intent` stay out of the model.
    recv = name.rsplit(".", 2)
    return any("journal" in p.lower() or "store" in p.lower()
               for p in recv[:-1])


def _emit_call(node: ast.Call) -> bool:
    name = call_name(node.func)
    last = name.rsplit(".", 1)[-1]
    if last not in _EMIT_ATTRS or "." not in name:
        return False
    recv = name[: -(len(last) + 1)]
    return any(h in recv.lower() for h in _EMIT_RECEIVER_HINTS)


@module_rule(
    RuleInfo("DK502", "reply/ACK emitted before the journal append"),
)
def check_ack_before_journal(mod: Module) -> list:
    out: list = []
    for fn in [n for n in walk(mod.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        durable_lines: list = []
        emits: list = []
        for node in walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if _durable_call(node):
                durable_lines.append(node.lineno)
            elif _emit_call(node):
                emits.append(node)
        if not durable_lines or not emits:
            continue
        first_durable = min(durable_lines)
        for node in emits:
            if node.lineno < first_durable:
                out.append(Finding(
                    mod.path, node.lineno, node.col_offset, "DK502",
                    f"`{call_name(node.func)}()` emits before the journal "
                    f"append at line {first_durable}: intent-before-RPC — "
                    "a crash between them replays or loses the record "
                    "(the OffsetJournal discipline)"))
    return out
