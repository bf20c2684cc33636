"""DK3xx — environment/config discipline lints (the JAX package's
``analysis/rules_config.py``, reading the port's registry and tables).

The ``DKTPU_*`` surface is the framework's operational API; these rules
pin it to one home, the port's ``runtime/config.py``:

* **DK301** — any ``os.environ`` / ``os.getenv`` use outside
  ``runtime/config.py``: read through the typed registry accessors
  (``env_bool``/``env_int``/``env_float``/``env_str``) instead.
* **DK302** — a ``DKTPU_*`` name (in any string literal, docstrings
  included) that is not declared in the port's ``ENV_REGISTRY``:
  undeclared knobs are invisible to docs and to ``env_*`` type checking.
* **DK303** — registry/docs drift: a registered variable absent from the
  port's ``distkeras_tpu_torch/docs/`` tables, or a
  ``<!-- dk-env:begin -->`` table block whose content no longer matches
  the registry rendering (fix with
  ``python -m distkeras_tpu_torch.analysis --write-env-docs``).
"""

from __future__ import annotations

import ast
import glob
import os
import re

from distkeras_tpu_torch.analysis.core import (
    Finding, Module, RuleInfo, call_name, module_rule, project_rule, walk)

_CONFIG_SUFFIX = os.path.join("runtime", "config.py")
_DKTPU_RE = re.compile(r"\bDKTPU_[A-Z][A-Z0-9_]*\b")


def _config():
    from distkeras_tpu_torch.runtime import config

    return config


def _registry_names() -> frozenset:
    return frozenset(_config().ENV_REGISTRY)


def _is_config_module(path: str) -> bool:
    return os.path.normpath(path).endswith(_CONFIG_SUFFIX)


@module_rule(
    RuleInfo("DK301", "os.environ read outside runtime/config.py"),
    RuleInfo("DK302", "undeclared DKTPU_* environment variable"),
)
def check_env_discipline(mod: Module) -> list:
    out: list = []
    if not _is_config_module(mod.path):
        seen_lines: set = set()
        for node in walk(mod.tree):
            hit = None
            if isinstance(node, (ast.Attribute, ast.Name)):
                name = call_name(node)
                if name == "os.environ":
                    hit = "`os.environ`"
            if isinstance(node, ast.Call):
                name = call_name(node.func)
                if name in ("os.getenv", "os.putenv", "os.unsetenv"):
                    hit = f"`{name}()`"
            if hit and node.lineno not in seen_lines:
                seen_lines.add(node.lineno)
                out.append(Finding(
                    mod.path, node.lineno, node.col_offset, "DK301",
                    f"{hit} outside runtime/config.py: declare the variable "
                    "in ENV_REGISTRY and read it through "
                    "config.env_bool/env_int/env_float/env_str"))
        registered = _registry_names()

        def flag(node, name: str) -> None:
            if name not in registered:
                out.append(Finding(
                    mod.path, node.lineno, node.col_offset, "DK302",
                    f"`{name}` is not declared in "
                    "runtime.config.ENV_REGISTRY: undeclared env "
                    "vars bypass typing and the docs tables"))

        fstring_parts: set = set()
        for node in walk(mod.tree):
            if isinstance(node, ast.JoinedStr):
                # constant parts of an f-string never reach ast.Constant
                # below (3.12+ folds them into the JoinedStr) — check the
                # resolvable text and remember the parts we covered.
                for i, part in enumerate(node.values):
                    if (isinstance(part, ast.Constant)
                            and isinstance(part.value, str)):
                        fstring_parts.add(id(part))
                        for name in _DKTPU_RE.findall(part.value):
                            flag(part, name)
                        # f"DKTPU_{name}": a bare prefix flowing into a
                        # formatted value builds the name at runtime.
                        if (re.search(r"DKTPU_[A-Z0-9_]*$", part.value)
                                and i + 1 < len(node.values)
                                and isinstance(node.values[i + 1],
                                               ast.FormattedValue)):
                            out.append(Finding(
                                mod.path, part.lineno, part.col_offset,
                                "DK302",
                                "f-string builds a DKTPU_* env var name "
                                "at runtime: no registry entry can ever "
                                "match it — construct the full literal "
                                "and declare it"))
            elif (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Add)):
                # `"DKTPU_" + name` concatenation: when both sides are
                # constants the full name is checkable; a dynamic tail
                # means the variable can never be matched to the registry
                # at all — flag the construction itself.
                left, right = node.left, node.right
                if (isinstance(left, ast.Constant)
                        and isinstance(left.value, str)
                        and re.fullmatch(r"DKTPU_[A-Z0-9_]*",
                                         left.value)):
                    if (isinstance(right, ast.Constant)
                            and isinstance(right.value, str)):
                        for name in _DKTPU_RE.findall(
                                left.value + right.value):
                            flag(node, name)
                    else:
                        out.append(Finding(
                            mod.path, node.lineno, node.col_offset,
                            "DK302",
                            f"`{left.value}` + <dynamic> builds an env "
                            "var name at runtime: no registry entry can "
                            "ever match it — construct the full DKTPU_* "
                            "literal and declare it"))
        for node in walk(mod.tree):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and id(node) not in fstring_parts):
                for name in _DKTPU_RE.findall(node.value):
                    flag(node, name)
    return out


@project_rule(
    RuleInfo("DK303", "env-var docs table out of sync with the registry"),
)
def check_env_docs(modules) -> list:
    """Only fires when the scan includes the real registry module (so the
    fixture corpus, which has no docs tree, is naturally exempt). The
    tables are the package's own ``docs/`` (``distkeras_tpu_torch/docs``),
    beside ``runtime/``."""
    config_mod = next((m for m in modules if _is_config_module(m.path)), None)
    if config_mod is None:
        return []
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        config_mod.path)))
    docs_dir = os.path.join(pkg_root, "docs")
    if not os.path.isdir(docs_dir):
        return []
    config = _config()

    docs: dict = {}
    for path in sorted(glob.glob(os.path.join(docs_dir, "*.md"))):
        with open(path, encoding="utf-8") as f:
            docs[path] = f.read()
    out: list = []

    def decl_line(name: str) -> int:
        for i, line in enumerate(config_mod.source.splitlines(), 1):
            if f'"{name}"' in line:
                return i
        return 1

    blob = "\n".join(docs.values())
    for var in config.ENV_REGISTRY.values():
        if f"`{var.name}`" not in blob and var.name not in blob:
            out.append(Finding(
                config_mod.path, decl_line(var.name), 0, "DK303",
                f"`{var.name}` is registered but appears in no docs/*.md "
                "table: run `python -m distkeras_tpu_torch.analysis "
                "--write-env-docs`"))
    for path, text in docs.items():
        try:
            fresh = config.splice_env_docs(text)
        except ValueError:
            continue
        if fresh != text:
            out.append(Finding(
                config_mod.path, 1, 0, "DK303",
                f"{os.path.relpath(path, os.path.dirname(pkg_root))} env "
                "table is stale vs ENV_REGISTRY: run `python -m "
                "distkeras_tpu_torch.analysis --write-env-docs`"))
    return out
