"""DK1xx — captured-code lints (the twin of the JAX package's
``analysis/rules_jax.py``).

The port's counterpart of traced code is **captured** code: the work a
``torch.cuda.CUDAGraph`` records once and replays. Its Python side
effects happen once at capture (never at a replay), its host reads are
baked into the graph as constants, and a device-to-host read or a
synchronize raises inside a capture on the card while it passes silently
in the CPU host loop that stands in for the graph. These rules mark code
captured when it is

* the body of a ``with torch.cuda.graph(...)`` block (the context
  expression itself runs before the capture begins and is not checked),
* a local ``def``/``lambda`` passed to ``torch.cuda.make_graphed_callables``
  (alone, or in its tuple of callables), or
* a function decorated with ``captured`` (``parallel/program.py``), the
  mark every function that a multi-round program captures as a round
  carries: each engine's ``_round_fn`` (the counterpart of the JAX
  engine's ``jax.jit(round_fn)``). A decorator is read from the AST
  alone, so the mark sits on the definition, where a reader sees it;
  ``captured(fn)`` called on a local ``def`` marks it too.

Known limit (as in the reference): being captured does not propagate
through ordinary calls — a helper called *from* a captured body is only
checked if it is itself marked. The engines' own bit-for-bit tests
(per-round against blocked runs, on the card too) cover the dynamic side.

DK104 keeps the JAX meaning — a non-hashable static argument on a
``jit``-wrapped function — so code that never calls ``jit`` (the port)
cannot trigger it.
"""

from __future__ import annotations

import ast

from distkeras_tpu_torch.analysis.core import (
    Finding, Module, RuleInfo, call_name, module_rule, walk)

#: decorator / call names that mark a function captured.
_CAPTURE_MARKS = frozenset({"captured"})
_GRAPHED = "make_graphed_callables"
#: DK104 only: the JAX wrappers whose ``static_argnums`` must be hashable.
_JAX_WRAPPERS = frozenset({
    "jit", "pjit", "pmap", "vmap", "grad", "value_and_grad", "shard_map",
    "pallas_call",
})
#: DK101 — host reads whose value is frozen at capture.
_IMPURE_READS = frozenset({
    "os.environ.get", "os.getenv", "time.time", "time.time_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.monotonic",
    "time.monotonic_ns", "datetime.now", "datetime.utcnow", "uuid.uuid4",
})
_CONFIG_ACCESSORS = frozenset({
    "env_bool", "env_int", "env_float", "env_str", "env_is_set"})
#: DK102 — host I/O / side effects that silently run only at capture.
_IO_CALLS = frozenset({"open", "print", "input"})
_IO_PREFIXES = ("subprocess.", "shutil.", "logging.")
_IO_OS_CALLS = frozenset({
    "os.remove", "os.unlink", "os.makedirs", "os.mkdir", "os.listdir",
    "os.rename", "os.stat", "os.kill", "os.system",
})
#: DK102 — device-to-host reads and synchronizes (method names, any
#: receiver): illegal inside a capture on the card.
_DEVICE_READS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
# Names that read as container mutation. `update`/`pop`/`setdefault` are
# deliberately absent: an optimizer's pure `tx.update(...)` and state-dict
# `.pop` idioms collide with the dict methods and would drown DK105 in
# false positives.
_MUTATORS = frozenset({
    "append", "extend", "insert", "add", "clear", "remove", "discard",
    "appendleft",
})
_TELE_METHODS = frozenset({"counter", "gauge", "histogram", "span", "event"})


def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _is_mark(node: ast.AST) -> bool:
    """``captured`` / ``program.captured`` reference?"""
    name = call_name(node)
    return bool(name) and _last(name) in _CAPTURE_MARKS


def _is_graph_ctx(node: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` (or ``cuda.graph(...)``) call?"""
    if not isinstance(node, ast.Call):
        return False
    parts = call_name(node.func).split(".")
    return len(parts) >= 2 and parts[-2:] == ["cuda", "graph"]


class _Region:
    """One captured region: a function, or a ``with`` block's body."""

    def __init__(self, node: ast.AST, name: str, reason: str, line: int):
        self.node = node        # walked for findings and locals
        self.name = name
        self.reason = reason
        self.line = line


def _collect_captured(mod: Module) -> list:
    defs: dict = {}
    for node in walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
    regions: dict = {}

    def mark(fn_node, reason: str) -> None:
        regions.setdefault(id(fn_node), _Region(
            fn_node, getattr(fn_node, "name", "<lambda>"), reason,
            fn_node.lineno))

    def mark_callable(arg, wrapper: str) -> None:
        if isinstance(arg, ast.Lambda):
            mark(arg, f"passed to {wrapper}")
        elif isinstance(arg, ast.Name) and arg.id in defs:
            mark(defs[arg.id], f"passed to {wrapper}")
        elif isinstance(arg, (ast.Tuple, ast.List)):
            for el in arg.elts:
                mark_callable(el, wrapper)

    def enclosing_names(tree) -> dict:
        out: dict = {}

        def visit(node, owner: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    visit(child, child.name)
                else:
                    if isinstance(child, ast.With):
                        out[id(child)] = owner
                    visit(child, owner)
        visit(tree, "<module>")
        return out

    owners = enclosing_names(mod.tree)
    for node in walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _is_mark(dec):
                    mark(node, f"decorated with {ast.unparse(dec)}")
        elif isinstance(node, ast.With):
            for item in node.items:
                if _is_graph_ctx(item.context_expr):
                    body = ast.Module(body=node.body, type_ignores=[])
                    regions.setdefault(id(node), _Region(
                        body, owners.get(id(node), "<module>"),
                        f"inside `with {call_name(item.context_expr.func)}"
                        f"(...)` at line {node.lineno}", node.lineno))
        elif isinstance(node, ast.Call):
            name = call_name(node.func)
            if _last(name) == _GRAPHED and node.args:
                mark_callable(node.args[0], name)
            elif _is_mark(node.func) and node.args:
                mark_callable(node.args[0], name)
    return list(regions.values())


def _locals_of(fn) -> set:
    """Every name bound anywhere inside ``fn`` (params, assignments, loop
    targets, nested defs) — mutation of these is internal to the capture."""
    names: set = set()

    def add_target(t) -> None:
        for n in walk(t):
            if isinstance(n, ast.Name):
                names.add(n.id)

    for node in walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            a = node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs
                        + ([a.vararg] if a.vararg else [])
                        + ([a.kwarg] if a.kwarg else [])):
                names.add(arg.arg)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                add_target(t)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
            add_target(node.target)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            add_target(node.target)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    add_target(item.optional_vars)
        elif isinstance(node, ast.comprehension):
            add_target(node.target)
    return names


def _tele_handles(mod: Module) -> set:
    """Names bound from ``telemetry.get()`` anywhere in the module."""
    handles = set()
    for node in walk(mod.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = call_name(node.value.func)
            if _last(name) == "get" and "telemetry" in name.split("."):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        handles.add(t.id)
    return handles


@module_rule(
    RuleInfo("DK101", "impure host read (env/time/random) inside captured "
                      "code"),
    RuleInfo("DK102", "host I/O, side effect or device-to-host read inside "
                      "captured code"),
    RuleInfo("DK103", "telemetry call inside captured code"),
    RuleInfo("DK104", "non-hashable static argument on a jitted function "
                      "(jit only: code that never calls jit cannot "
                      "trigger it)"),
    RuleInfo("DK105", "captured code mutates enclosing/global state"),
)
def check_captured(mod: Module) -> list:
    out: list = []
    handles = _tele_handles(mod)

    for region in _collect_captured(mod):
        fn, reason, fname = region.node, region.reason, region.name
        local_names = _locals_of(fn)
        for node in walk(fn):
            line, col = getattr(node, "lineno", region.line), getattr(
                node, "col_offset", 0)
            if isinstance(node, ast.Call):
                name = call_name(node.func)
                last = _last(name)
                root = name.split(".")[0]
                attr = (node.func.attr if isinstance(node.func, ast.Attribute)
                        else "")
                if (name in _IMPURE_READS or last in _CONFIG_ACCESSORS
                        or (root in ("random", "np", "numpy")
                            and "random" in name.split(".")[:-1])
                        or (root == "random" and "." in name)):
                    out.append(Finding(
                        mod.path, line, col, "DK101",
                        f"`{name}()` inside captured `{fname}` ({reason}): "
                        "the value is frozen at capture — pass it in as a "
                        "tensor or read it before capturing"))
                elif (name in _IO_CALLS or name in _IO_OS_CALLS
                      or name == "time.sleep"
                      or name.startswith(_IO_PREFIXES)
                      or (root == "warnings" and last == "warn")):
                    out.append(Finding(
                        mod.path, line, col, "DK102",
                        f"host I/O `{name}()` inside captured `{fname}` "
                        f"({reason}): runs once at capture, never at a "
                        "replay — hoist it to the host loop"))
                elif attr in _DEVICE_READS:
                    shown = name or f"<expr>.{attr}"
                    out.append(Finding(
                        mod.path, line, col, "DK102",
                        f"device-to-host read `{shown}()` inside captured "
                        f"`{fname}` ({reason}): raises inside a capture on "
                        "the card and passes silently in the CPU host loop "
                        "— keep the value on the device"))
                elif (root == "telemetry" and "." in name) or (
                        root in handles and last in _TELE_METHODS):
                    out.append(Finding(
                        mod.path, line, col, "DK103",
                        f"telemetry call `{name}()` inside captured "
                        f"`{fname}` ({reason}): records at capture, not at "
                        "a replay — instrument the host loop instead"))
                elif last in _MUTATORS:
                    recv = call_name(node.func)
                    recv_root = recv.split(".")[0]
                    if (recv_root and recv_root not in local_names
                            and recv_root != "self"
                            and recv.count(".") == 1):
                        out.append(Finding(
                            mod.path, line, col, "DK105",
                            f"`{recv}()` inside captured `{fname}` mutates "
                            f"closed-over `{recv_root}`: happens at capture "
                            "only — return the value instead"))
            elif isinstance(node, ast.Subscript):
                if call_name(node.value) == "os.environ":
                    out.append(Finding(
                        mod.path, line, col, "DK101",
                        f"`os.environ[...]` inside captured `{fname}` "
                        f"({reason}): frozen at capture"))
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                out.append(Finding(
                    mod.path, line, col, "DK105",
                    f"`{'global' if isinstance(node, ast.Global) else 'nonlocal'}"
                    f" {', '.join(node.names)}` inside captured `{fname}` "
                    f"({reason}): rebinding happens at capture only"))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        out.append(Finding(
                            mod.path, line, col, "DK105",
                            f"write to `self.{t.attr}` inside captured "
                            f"`{fname}` ({reason}): object state mutates "
                            "at capture only — return it with the state "
                            "instead"))
    out.extend(_check_static_args(mod))
    return out


def _is_jax_wrapper_ref(node: ast.AST) -> bool:
    """``jit`` / ``jax.jit`` / ``partial(jax.jit, ...)`` reference?"""
    if isinstance(node, ast.Call) and _last(call_name(node.func)) == "partial":
        return bool(node.args) and _is_jax_wrapper_ref(node.args[0])
    name = call_name(node)
    return bool(name) and _last(name) in _JAX_WRAPPERS


def _mutable_default(node) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call)
            and call_name(node.func) in ("list", "dict", "set", "bytearray"))


def _check_static_args(mod: Module) -> list:
    """DK104: ``static_argnums``/``static_argnames`` naming a parameter whose
    default is a mutable (unhashable) literal — every call retraces (or
    raises) instead of hitting the jit cache. The reference's rule as it
    stands: it reads ``jit`` calls and decorators only."""
    out: list = []
    defs: dict = {}
    for node in walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node

    def static_kw(call: ast.Call):
        for kw in call.keywords:
            if kw.arg in ("static_argnums", "static_argnames"):
                yield kw

    def check_pair(fn_def, kw, site) -> None:
        params = fn_def.args.args
        defaults = fn_def.args.defaults
        off = len(params) - len(defaults)
        by_index = {off + i: d for i, d in enumerate(defaults)}
        by_name = {params[off + i].arg: d for i, d in enumerate(defaults)}
        vals = (kw.value.elts if isinstance(kw.value, (ast.Tuple, ast.List))
                else [kw.value])
        for v in vals:
            if not isinstance(v, ast.Constant):
                continue
            default = (by_index.get(v.value) if isinstance(v.value, int)
                       else by_name.get(v.value))
            if default is not None and _mutable_default(default):
                out.append(Finding(
                    mod.path, site.lineno, site.col_offset, "DK104",
                    f"static arg {v.value!r} of `{fn_def.name}` defaults to "
                    "a mutable (unhashable) value: jit static args must be "
                    "hashable or every call retraces"))

    for node in walk(mod.tree):
        if isinstance(node, ast.Call) and _last(
                call_name(node.func)) in ("jit", "pjit"):
            for kw in static_kw(node):
                if node.args and isinstance(node.args[0], ast.Name) \
                        and node.args[0].id in defs:
                    check_pair(defs[node.args[0].id], kw, node)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and _is_jax_wrapper_ref(dec):
                    for kw in static_kw(dec):
                        check_pair(node, kw, dec)
    return out
