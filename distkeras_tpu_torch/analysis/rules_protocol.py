"""DK4xx — wire-protocol registry discipline (the JAX package's
``analysis/rules_protocol.py``, against the port's ``netps/wire.py``).

The netps frame protocol (``netps/wire.py``) is a hand-rolled contract:
op kinds, frame header keys, error kinds, and the byte-level struct
layouts. Call sites grow faster than the contract — these rules pin every
protocol token to the declared registries so drift is a finding, not a
code-review catch:

* **DK401** — op-kind discipline. In the module that defines
  ``OP_REGISTRY`` (wire.py), every ``OP_*`` constant must be a registry
  key and every key must be a declared constant (with a cap gate that
  exists in ``CAPS``). Everywhere else, op kinds are ``wire.OP_*``
  references: a raw op string in a dispatch comparison, an ``_rpc(...)``
  first argument, an ``{"op": ...}`` frame literal, or a stray ``OP_*``
  assignment is drift waiting to happen.
* **DK402** — header/error literals must come from the declared
  registries: a ``header.get("k")`` / ``h["k"]`` key absent from
  ``wire.HEADER_KEYS``, or an error kind (``_err("...")`` / an
  ``.get("error")`` comparison) absent from ``wire.ERROR_KINDS``.
* **DK403** — raw ``struct.pack/unpack`` outside wire.py: byte layouts
  live in one file (``wire._PREFIX``, ``wire.U32``, ...); a private
  struct call elsewhere in the netps plane is an undeclared wire format.

DK402/DK403 scope: modules under ``netps/`` or importing
``distkeras_tpu_torch.netps`` (or the JAX package's ``distkeras_tpu.netps``:
the two packages speak one wire, frame for frame) — the
serialization/datasets struct users are not on the wire and stay exempt.
The names are matched as text; nothing is imported.
"""

from __future__ import annotations

import ast
import os
import re

from distkeras_tpu_torch.analysis.core import (
    Finding, Module, RuleInfo, call_name, module_rule, walk)

_OP_CONST_RE = re.compile(r"^OP_[A-Z0-9_]+$")
_HEADER_RECEIVERS = frozenset({"hdr", "rhdr", "header", "reply"})
_STRUCT_CALLS = frozenset({
    "pack", "unpack", "pack_into", "unpack_from", "iter_unpack",
    "calcsize", "Struct",
})


#: the packages whose ``netps`` speaks this wire.
_WIRE_PACKAGES = ("distkeras_tpu_torch", "distkeras_tpu")


def _wire():
    from distkeras_tpu_torch.netps import wire

    return wire


def _is_netps(module: str) -> bool:
    return any(module == f"{pkg}.netps" or module.startswith(f"{pkg}.netps.")
               for pkg in _WIRE_PACKAGES)


def _netps_scoped(mod: Module) -> bool:
    """Under netps/ or importing it — the modules that speak the wire."""
    if (os.sep + "netps" + os.sep) in os.path.normpath(mod.path):
        return True
    for node in walk(mod.tree):
        if isinstance(node, ast.Import):
            if any(_is_netps(a.name) for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            m = node.module or ""
            if _is_netps(m):
                return True
            if m in _WIRE_PACKAGES and any(a.name == "netps"
                                           for a in node.names):
                return True
    return False


def _defines_registry(mod: Module) -> bool:
    return any(isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "OP_REGISTRY"
                       for t in n.targets)
               for n in mod.tree.body)


def _str_const(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


def _op_expr(node) -> bool:
    """Does this expression read the op kind? (``op``, ``x.op``,
    ``h.get("op")``, ``h["op"]``)"""
    if isinstance(node, ast.Name) and node.id == "op":
        return True
    if isinstance(node, ast.Attribute) and node.attr == "op":
        return True
    if (isinstance(node, ast.Call)
            and call_name(node.func).rsplit(".", 1)[-1] == "get"
            and node.args and _str_const(node.args[0])
            and node.args[0].value == "op"):
        return True
    if (isinstance(node, ast.Subscript) and _str_const(node.slice)
            and node.slice.value == "op"):
        return True
    return False


def _check_registry_module(mod: Module) -> list:
    """The wire.py half of DK401: OP_* constants <-> OP_REGISTRY keys."""
    out: list = []
    consts: dict = {}       # OP_NAME -> (value, line)
    caps_keys: set = set()
    reg_node = None
    for node in mod.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if not isinstance(t, ast.Name):
                continue
            if _OP_CONST_RE.match(t.id) and _str_const(node.value):
                consts[t.id] = (node.value.value, node.lineno)
            elif t.id == "OP_REGISTRY":
                reg_node = node
            elif t.id == "CAPS" and isinstance(node.value, ast.Dict):
                caps_keys = {k.value for k in node.value.keys
                             if _str_const(k)}
    if reg_node is None or not isinstance(reg_node.value, ast.Dict):
        return out
    key_names: set = set()   # OP_* constants referenced as keys
    key_values: set = set()  # literal-string keys
    for key, val in zip(reg_node.value.keys, reg_node.value.values):
        if isinstance(key, ast.Name):
            key_names.add(key.id)
        elif _str_const(key):
            key_values.add(key.value)
        # cap gate: OpSpec's first argument must be a declared capability
        if (isinstance(val, ast.Call)
                and call_name(val.func).rsplit(".", 1)[-1] == "OpSpec"
                and val.args and _str_const(val.args[0]) and caps_keys
                and val.args[0].value not in caps_keys):
            out.append(Finding(
                mod.path, val.lineno, val.col_offset, "DK401",
                f"OP_REGISTRY cap gate `{val.args[0].value!r}` is not a "
                "declared CAPS capability"))
    for name, (value, line) in sorted(consts.items()):
        if name not in key_names and value not in key_values:
            out.append(Finding(
                mod.path, line, 0, "DK401",
                f"`{name}` is not declared in OP_REGISTRY: every op kind "
                "carries its cap gate and reply keys there"))
    for value in sorted(key_values):
        if value not in {v for v, _ in consts.values()}:
            out.append(Finding(
                mod.path, reg_node.lineno, 0, "DK401",
                f"OP_REGISTRY key `{value!r}` has no OP_* constant: "
                "declare the constant and key the registry by it"))
    return out


def _op_literal_findings(mod: Module, ops: frozenset) -> list:
    """The everywhere-else half of DK401: raw op strings in op contexts."""
    out: list = []

    def flag(node, value: str) -> None:
        if value in ops:
            hint = (f"use wire.OP_{value.upper()}" if value.isidentifier()
                    else "use the wire.OP_* constant")
            msg = f"raw op string `{value!r}`: {hint}"
        else:
            msg = (f"op `{value!r}` is not declared in wire.OP_REGISTRY: "
                   "undeclared ops bypass the cap-gate/reply contract")
        out.append(Finding(mod.path, node.lineno, node.col_offset,
                           "DK401", msg))

    for node in walk(mod.tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Name) and _OP_CONST_RE.match(t.id)
                        and _str_const(node.value)):
                    out.append(Finding(
                        mod.path, node.lineno, node.col_offset, "DK401",
                        f"`{t.id}` declared outside wire.py: op constants "
                        "live in wire.OP_REGISTRY, import them from there"))
        elif isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            if not any(_op_expr(s) for s in sides):
                continue
            for s in sides:
                if _str_const(s):
                    flag(s, s.value)
                elif isinstance(s, (ast.Tuple, ast.List, ast.Set)):
                    for el in s.elts:
                        if _str_const(el):
                            flag(el, el.value)
        elif isinstance(node, ast.Call):
            name = call_name(node.func).rsplit(".", 1)[-1]
            if (name in ("_rpc", "_rpc_traced") and node.args
                    and _str_const(node.args[0])):
                flag(node.args[0], node.args[0].value)
        elif isinstance(node, ast.Dict):
            for key, val in zip(node.keys, node.values):
                if (_str_const(key) and key.value == "op"
                        and _str_const(val)):
                    flag(val, val.value)
    return out


@module_rule(
    RuleInfo("DK401", "op kind drifts from wire.OP_REGISTRY"),
)
def check_op_registry(mod: Module) -> list:
    if _defines_registry(mod):
        return _check_registry_module(mod)
    if not _netps_scoped(mod):
        return []
    return _op_literal_findings(mod, frozenset(_wire().OP_REGISTRY))


@module_rule(
    RuleInfo("DK402", "undeclared frame header key / error kind literal"),
)
def check_header_literals(mod: Module) -> list:
    if _defines_registry(mod) or not _netps_scoped(mod):
        return []
    wire = _wire()
    out: list = []

    def header_key(node) -> None:
        # .get("k") / ["k"] on a header-named receiver
        key = None
        if isinstance(node, ast.Call):
            name = call_name(node.func)
            if (name.rsplit(".", 1)[-1] == "get"
                    and name.split(".")[0] in _HEADER_RECEIVERS
                    and name.count(".") == 1
                    and node.args and _str_const(node.args[0])):
                key = node.args[0]
        elif isinstance(node, ast.Subscript):
            recv = node.value
            if (isinstance(recv, ast.Name)
                    and recv.id in _HEADER_RECEIVERS
                    and _str_const(node.slice)):
                key = node.slice
        if key is not None and key.value not in wire.HEADER_KEYS:
            out.append(Finding(
                mod.path, key.lineno, key.col_offset, "DK402",
                f"frame header key `{key.value!r}` is not declared in "
                "wire.HEADER_KEYS: undeclared keys are invisible to the "
                "protocol contract"))

    def error_kind(node) -> None:
        if isinstance(node, ast.Call):
            name = call_name(node.func).rsplit(".", 1)[-1]
            if (name in ("_err", "err") and node.args
                    and _str_const(node.args[0])
                    and node.args[0].value not in wire.ERROR_KINDS):
                bad = node.args[0]
                out.append(Finding(
                    mod.path, bad.lineno, bad.col_offset, "DK402",
                    f"error kind `{bad.value!r}` is not declared in "
                    "wire.ERROR_KINDS: clients dispatch on these strings"))
        elif isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            reads_err = any(
                isinstance(s, ast.Call)
                and call_name(s.func).rsplit(".", 1)[-1] == "get"
                and s.args and _str_const(s.args[0])
                and s.args[0].value == "error" for s in sides) or any(
                isinstance(s, ast.Name) and s.id == "error_kind"
                for s in sides)
            if not reads_err:
                return
            for s in sides:
                consts = ([s] if _str_const(s) else
                          [el for el in getattr(s, "elts", ())
                           if _str_const(el)])
                for c in consts:
                    if c.value not in wire.ERROR_KINDS:
                        out.append(Finding(
                            mod.path, c.lineno, c.col_offset, "DK402",
                            f"error kind `{c.value!r}` is not declared "
                            "in wire.ERROR_KINDS: clients dispatch on "
                            "these strings"))

    for node in walk(mod.tree):
        header_key(node)
        error_kind(node)
    return out


@module_rule(
    RuleInfo("DK403", "raw struct.pack/unpack outside wire.py"),
)
def check_raw_struct(mod: Module) -> list:
    if _defines_registry(mod) or not _netps_scoped(mod):
        return []
    out: list = []
    for node in walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node.func)
        parts = name.split(".")
        if (len(parts) == 2 and parts[0] == "struct"
                and parts[1] in _STRUCT_CALLS):
            out.append(Finding(
                mod.path, node.lineno, node.col_offset, "DK403",
                f"raw `{name}()` on the wire plane: byte layouts are "
                "declared once in wire.py (wire._PREFIX, wire.U32, ...) — "
                "an ad-hoc struct call here is an undeclared frame format"))
    return out
