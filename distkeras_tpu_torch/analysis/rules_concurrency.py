"""DK2xx — host-thread concurrency lints (the JAX package's
``analysis/rules_concurrency.py``, unchanged in substance).

The port's threaded surface (telemetry registry, RoundFeeder, native
loader, the netps server and its tree, racelab, fault plans) shares
mutable state under plain ``threading.Lock``s. These rules build a static model of that
surface:

* **DK201** — a lock-acquisition-order graph: every ``with lock_b:`` nested
  (syntactically, or one call level deep within the same module) inside
  ``with lock_a:`` adds the edge ``a -> b``; a cycle in the global graph is
  a potential deadlock. The graph is intentionally conservative —
  cross-module call edges are not resolved statically; the runtime witness
  (``distkeras_tpu_torch.analysis.witness``) covers real interleavings.
* **DK202** — an attribute that is written under a class lock somewhere but
  also written (or mutated via ``.append``/``.update``/...) outside any
  lock in another method: the unlocked write races the locked readers.
  ``__init__`` is exempt (no concurrent access before construction ends).
* **DK203** — ``threading.Thread`` created neither ``daemon=True`` nor
  joined anywhere in the module: a silent leak that blocks interpreter
  shutdown.
* **DK204** — a bare ``except:`` / ``except BaseException:`` handler that
  neither re-raises nor uses the caught exception object: it swallows
  ``KeyboardInterrupt``/``SystemExit``, turning Ctrl-C into an infinite
  worker loop.
"""

from __future__ import annotations

import ast
import os

from distkeras_tpu_torch.analysis.core import (
    Finding, Module, RuleInfo, call_name, module_rule, project_rule, walk,
    walk_scope)

_LOCK_CTORS = frozenset({"Lock", "RLock"})
_MUTATORS = frozenset({
    "append", "extend", "insert", "update", "add", "pop", "clear", "remove",
    "setdefault", "popitem", "discard",
})


def _modbase(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _is_lock_ctor(node) -> bool:
    return (isinstance(node, ast.Call)
            and call_name(node.func).rsplit(".", 1)[-1] in _LOCK_CTORS)


class _ModuleLocks:
    """Lock declarations + per-function acquisition structure of one file."""

    def __init__(self, mod: Module):
        self.mod = mod
        base = _modbase(mod.path)
        #: lock id -> declaration line
        self.locks: dict = {}
        #: class name -> set of lock attr names
        self.class_locks: dict = {}
        self.module_locks: set = set()
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.module_locks.add(t.id)
                        self.locks[f"{base}.{t.id}"] = node.lineno
        for node in walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            attrs = set()
            for sub in walk(node):
                if isinstance(sub, ast.Assign) and _is_lock_ctor(sub.value):
                    for t in sub.targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            attrs.add(t.attr)
                            self.locks[f"{base}.{node.name}.{t.attr}"] = \
                                sub.lineno
            if attrs:
                self.class_locks[node.name] = attrs
        self.base = base

    def resolve(self, expr, cls: str) -> str:
        """Lock id for a ``with`` item expression, '' if not a known lock."""
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return f"{self.base}.{expr.id}"
        if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and cls
                and expr.attr in self.class_locks.get(cls, ())):
            return f"{self.base}.{cls}.{expr.attr}"
        return ""


def _functions(mod: Module):
    """Yield (qualname, class name or '', FunctionDef) for every def."""
    def visit(body, cls, prefix):
        for node in body:
            if isinstance(node, ast.ClassDef):
                yield from visit(node.body, node.name, f"{prefix}{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield f"{prefix}{node.name}", cls, node
                yield from visit(node.body, cls, f"{prefix}{node.name}.")
    yield from visit(mod.tree.body, "", "")


def build_lock_graph(modules) -> tuple:
    """(edges, sites, acquires) over all modules.

    ``edges``: set of (lock_a, lock_b) — b acquired while a held.
    ``sites``: edge -> (path, line) of the inner acquisition.
    ``acquires``: function qualname (module-prefixed) -> set of lock ids the
    function may acquire, transitively through same-module calls.
    """
    infos = [(_ModuleLocks(m), m) for m in modules]
    # Pass 1: direct acquisitions + same-module call lists per function.
    direct: dict = {}
    calls: dict = {}
    fn_meta: dict = {}
    for info, mod in infos:
        names = {q.rsplit(".", 1)[-1]: f"{info.base}:{q}"
                 for q, _c, _n in _functions(mod)}
        for qual, cls, fn in _functions(mod):
            key = f"{info.base}:{qual}"
            fn_meta[key] = (info, mod, cls, fn)
            acq, callees = set(), set()
            for node in walk_scope(fn):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        lock = info.resolve(item.context_expr, cls)
                        if lock:
                            acq.add(lock)
                elif isinstance(node, ast.Call):
                    name = call_name(node.func)
                    if name.startswith("self.") and name.count(".") == 1 and cls:
                        callees.add(f"{info.base}:{cls}.{name[5:]}")
                    elif name and "." not in name and name in names:
                        callees.add(names[name])
            direct[key] = acq
            calls[key] = callees
    # Fixpoint: transitive acquire sets through same-module calls.
    acquires = {k: set(v) for k, v in direct.items()}
    changed = True
    while changed:
        changed = False
        for k, callees in calls.items():
            for c in callees:
                extra = acquires.get(c, set()) - acquires[k]
                if extra:
                    acquires[k] |= extra
                    changed = True
    # Pass 2: edges from syntactic nesting + calls made while holding.
    edges: set = set()
    sites: dict = {}

    def scan(node, held, info, mod, cls, key):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = list(held)
            for item in node.items:
                lock = info.resolve(item.context_expr, cls)
                if lock:
                    for h in held:
                        if h != lock:
                            edges.add((h, lock))
                            sites.setdefault((h, lock),
                                             (mod.path, node.lineno))
                    inner.append(lock)
            for child in node.body:
                scan(child, inner, info, mod, cls, key)
            return
        if isinstance(node, ast.Call) and held:
            for callee in _resolve_call(node, info, cls, key):
                for lock in acquires.get(callee, ()):
                    for h in held:
                        if h != lock:
                            edges.add((h, lock))
                            sites.setdefault(
                                (h, lock), (mod.path, node.lineno))
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            for child in ast.iter_child_nodes(node):
                scan(child, held, info, mod, cls, key)

    def _resolve_call(node, info, cls, key):
        name = call_name(node.func)
        if name.startswith("self.") and name.count(".") == 1 and cls:
            return [f"{info.base}:{cls}.{name[5:]}"]
        if name and "." not in name:
            cand = f"{info.base}:{name}"
            if cand in acquires:
                return [cand]
        return []

    for key, (info, mod, cls, fn) in fn_meta.items():
        for child in fn.body:
            scan(child, [], info, mod, cls, key)
    return edges, sites, acquires


def _find_cycles(edges) -> list:
    graph: dict = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles, seen_sets = [], []
    state: dict = {}

    def dfs(n, stack):
        state[n] = 1
        for m in graph.get(n, ()):
            if state.get(m, 0) == 1:
                cyc = stack[stack.index(m):] + [m]
                nodes = frozenset(cyc)
                if nodes not in seen_sets:
                    seen_sets.append(nodes)
                    cycles.append(cyc)
            elif state.get(m, 0) == 0:
                dfs(m, stack + [m])
        state[n] = 2

    for n in sorted(graph):
        if state.get(n, 0) == 0:
            dfs(n, [n])
    return cycles


@project_rule(
    RuleInfo("DK201", "lock-acquisition-order cycle (potential deadlock)"),
)
def check_lock_order(modules) -> list:
    edges, sites, _ = build_lock_graph(modules)
    out = []
    for cyc in _find_cycles(edges):
        path, line = sites.get((cyc[0], cyc[1]), (modules[0].path, 1))
        out.append(Finding(
            path, line, 0, "DK201",
            "lock-order cycle " + " -> ".join(cyc) + ": two threads taking "
            "these locks in opposite orders deadlock; pick one global order"))
    return out


@module_rule(
    RuleInfo("DK202", "write to a lock-guarded attribute outside the lock"),
    RuleInfo("DK203", "thread is neither daemon nor ever joined"),
    RuleInfo("DK204", "bare except swallows KeyboardInterrupt"),
)
def check_threading(mod: Module) -> list:
    out: list = []
    info = _ModuleLocks(mod)
    out.extend(_check_shared_writes(mod, info))
    out.extend(_check_threads(mod))
    out.extend(_check_bare_except(mod))
    return out


def _attr_writes(fn):
    """(attr, node, mutating) for self.X writes / self.X.mutator() calls."""
    for node in walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    yield t.attr, node
        elif isinstance(node, ast.Call):
            name = call_name(node.func)
            if (name.startswith("self.") and name.count(".") == 2
                    and name.rsplit(".", 1)[-1] in _MUTATORS):
                yield name.split(".")[1], node


def _check_shared_writes(mod: Module, info: _ModuleLocks) -> list:
    out = []
    for cls_node in [n for n in walk(mod.tree)
                     if isinstance(n, ast.ClassDef)]:
        lock_attrs = info.class_locks.get(cls_node.name)
        if not lock_attrs:
            continue
        locked_writes: dict = {}
        unlocked_writes: dict = {}
        for meth in cls_node.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue

            def scan(node, held: bool) -> None:
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    inner = held or any(
                        info.resolve(i.context_expr, cls_node.name)
                        for i in node.items)
                    for child in node.body:
                        scan(child, inner)
                    return
                for attr, site in _attr_writes_shallow(node):
                    if attr in lock_attrs:
                        continue
                    (locked_writes if held else unlocked_writes).setdefault(
                        attr, []).append((meth.name, site))
                for child in ast.iter_child_nodes(node):
                    if not isinstance(child, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)):
                        scan(child, held)

            for child in meth.body:
                scan(child, False)
        for attr, sites in unlocked_writes.items():
            if attr not in locked_writes:
                continue
            guardian = locked_writes[attr][0][0]
            for meth_name, site in sites:
                if meth_name == "__init__":
                    continue
                out.append(Finding(
                    mod.path, site.lineno, site.col_offset, "DK202",
                    f"`self.{attr}` is written under a lock in "
                    f"`{cls_node.name}.{guardian}` but without one here "
                    f"(`{meth_name}`): unlocked write races locked readers"))
    return out


def _attr_writes_shallow(node):
    """Like _attr_writes but for ONE node (no recursion — scan() recurses)."""
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                yield t.attr, node
    elif isinstance(node, ast.Call):
        name = call_name(node.func)
        if (name.startswith("self.") and name.count(".") == 2
                and name.rsplit(".", 1)[-1] in _MUTATORS):
            yield name.split(".")[1], node


def _check_threads(mod: Module) -> list:
    out = []
    # Names/attrs a created thread flows into, incl. list-comprehension
    # collections; a `.join()` on any of them (or on the loop var of a `for`
    # over them) counts as join discipline.
    joined: set = set()
    daemon_set: set = set()
    for node in walk(mod.tree):
        if isinstance(node, ast.Call):
            name = call_name(node.func)
            if name.endswith(".join") or name == "join":
                joined.add(name.rsplit(".join", 1)[0].split(".")[-1]
                           if "." in name else name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Attribute) and t.attr == "daemon"):
                    if isinstance(t.value, ast.Name):
                        daemon_set.add(t.value.id)
    # loop vars: `for t in threads: t.join()` -> joining `t` covers `threads`
    loop_map: dict = {}
    for node in walk(mod.tree):
        if (isinstance(node, (ast.For, ast.AsyncFor))
                and isinstance(node.target, ast.Name)
                and isinstance(node.iter, ast.Name)):
            loop_map.setdefault(node.target.id, set()).add(node.iter.id)
    covered = set(joined)
    for var in joined:
        covered |= loop_map.get(var, set())

    class _Finder(ast.NodeVisitor):
        def __init__(self):
            self.parents: list = []

        def generic_visit(self, node):
            self.parents.append(node)
            super().generic_visit(node)
            self.parents.pop()

        def visit_Call(self, node):
            name = call_name(node.func)
            if name.rsplit(".", 1)[-1] == "Thread" and (
                    name in ("Thread", "threading.Thread")
                    or name.endswith(".Thread")):
                for kw in node.keywords:
                    if kw.arg == "daemon" and isinstance(
                            kw.value, ast.Constant) and kw.value.value:
                        break
                else:
                    target = self._binding(node)
                    if target not in covered and target not in daemon_set:
                        out.append(Finding(
                            mod.path, node.lineno, node.col_offset, "DK203",
                            "threading.Thread created without daemon=True "
                            "and never joined in this module: a leaked "
                            "non-daemon thread blocks interpreter shutdown"))
            self.generic_visit(node)

        def _binding(self, call) -> str:
            for p in reversed(self.parents):
                if isinstance(p, ast.Assign):
                    t = p.targets[0]
                    if isinstance(t, ast.Name):
                        return t.id
                    if isinstance(t, ast.Attribute):
                        return t.attr
                if isinstance(p, (ast.ListComp, ast.GeneratorExp)):
                    continue
            return ""

    _Finder().visit(mod.tree)
    return out


def _check_bare_except(mod: Module) -> list:
    out = []
    for node in walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        is_bare = node.type is None
        catches_base = (isinstance(node.type, (ast.Name, ast.Attribute))
                        and call_name(node.type).rsplit(".", 1)[-1]
                        == "BaseException")
        if not (is_bare or catches_base):
            continue
        reraises = any(isinstance(n, ast.Raise) and n.exc is None
                       for n in walk(node))
        uses_bound = node.name is not None and any(
            isinstance(n, ast.Name) and n.id == node.name
            and isinstance(n.ctx, ast.Load) for n in walk(node))
        if reraises or uses_bound:
            continue  # propagates/records the exception: not swallowing
        what = "bare `except:`" if is_bare else "`except BaseException:`"
        out.append(Finding(
            mod.path, node.lineno, node.col_offset, "DK204",
            f"{what} swallows KeyboardInterrupt/SystemExit: catch "
            "`Exception`, or re-raise / surface the caught object"))
    return out
