"""dk-check core for the port: findings, suppressions, the rule registry,
the runner (the JAX package's ``analysis/core.py``, re-pointed at the
port's rule modules).

The analyzer is a plain-AST pass (no imports of the analyzed code, so a
broken module still gets checked) with six repo-specific rule families:

* ``DK1xx`` — captured-code hazards (``rules_torch``: host reads, host
  I/O, telemetry and state mutation inside a captured CUDA graph)
* ``DK2xx`` — host-thread concurrency hazards (``rules_concurrency``)
* ``DK3xx`` — environment/config discipline (``rules_config``)
* ``DK4xx`` — wire-protocol registry discipline (``rules_protocol``)
* ``DK5xx`` — durability/ordering discipline (``rules_durability``)
* ``DK6xx`` — contract-registry cross-checks (``rules_contracts``)

plus **DK001**, the meta-rule: a ``# dk: disable=RULE`` suppression whose
rule can no longer fire on that line is itself a finding — suppressions
are part of the code under review and must not outlive their reason.

Two rule shapes exist: **module rules** see one parsed file at a time;
**project rules** see the whole file set (the lock-order graph and the
registry/docs cross-checks need global state).

Suppression: a ``# dk: disable=DK101`` (or ``# dk: disable=DK101,DK204``,
or blanket ``# dk: disable``) comment suppresses findings attributed to
that physical line; ``# dk: disable-file=DK301`` anywhere suppresses the
rule for the whole file. Suppressions are part of the code under review —
each one should carry a justification in the surrounding comment.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Iterable, Optional

_SUPPRESS_RE = re.compile(
    r"#\s*dk:\s*(?P<kind>disable(?:-file)?)\s*(?:=\s*(?P<rules>[\w,\s]+))?")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str      # as given to the runner (relative when inputs were)
    line: int
    col: int
    rule: str      # stable ID, e.g. "DK101"
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Module:
    """One parsed source file handed to the rules."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        #: line -> set of suppressed rule IDs (empty set = all rules)
        self.suppressions: dict = {}
        #: rules suppressed for the whole file
        self.file_suppressions: set = set()
        #: file-suppressed rule -> line of its disable-file comment (DK001)
        self.file_suppression_lines: dict = {}
        self._parse_suppressions()

    def _parse_suppressions(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            comments = [(t.start[0], t.string) for t in tokens
                        if t.type == tokenize.COMMENT]
        except tokenize.TokenError:
            comments = [(i + 1, line[line.index("#"):])
                        for i, line in enumerate(self.source.splitlines())
                        if "#" in line]
        for line, text in comments:
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {r.strip().upper() for r in (m.group("rules") or "").split(",")
                     if r.strip()}
            if m.group("kind") == "disable-file":
                self.file_suppressions |= rules or {"*"}
                for r in rules:
                    self.file_suppression_lines.setdefault(r, line)
            else:
                self.suppressions.setdefault(line, set()).update(rules or {"*"})

    def suppressed(self, rule: str, line: int) -> bool:
        if self.file_suppressions & {rule, "*"}:
            return True
        rules = self.suppressions.get(line)
        return rules is not None and bool(rules & {rule, "*"})


@dataclasses.dataclass(frozen=True)
class RuleInfo:
    """Catalog entry: what ``--list-rules`` and the port's
    ``docs/ANALYSIS.md`` print."""

    rule: str
    summary: str


#: (checker, [RuleInfo]) pairs; module checkers take one Module, project
#: checkers take the full list.
_MODULE_CHECKERS: list = []
_PROJECT_CHECKERS: list = []
RULE_CATALOG: dict = {}

# The suppression meta-rule lives in the runner itself (it needs the raw,
# pre-suppression finding set), so it registers here, not via a decorator.
RULE_CATALOG["DK001"] = RuleInfo(
    "DK001", "stale suppression: the rule can no longer fire here")


def module_rule(*infos: RuleInfo):
    def deco(fn):
        _MODULE_CHECKERS.append(fn)
        for i in infos:
            RULE_CATALOG[i.rule] = i
        return fn
    return deco


def project_rule(*infos: RuleInfo):
    def deco(fn):
        _PROJECT_CHECKERS.append(fn)
        for i in infos:
            RULE_CATALOG[i.rule] = i
        return fn
    return deco


def _load_rules() -> None:
    # Import for registration side effects; idempotent.
    from distkeras_tpu_torch.analysis import (  # noqa: F401
        rules_concurrency, rules_config, rules_contracts, rules_durability,
        rules_protocol, rules_torch)


def iter_py_files(paths: Iterable[str]) -> list:
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
    return out


def parse_modules(paths: Iterable[str]) -> tuple:
    """(modules, findings) — a syntactically broken file becomes a DK000
    finding instead of crashing the run."""
    modules, findings = [], []
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            modules.append(Module(path, source))
        except SyntaxError as e:
            findings.append(Finding(path, e.lineno or 1, (e.offset or 1) - 1,
                                    "DK000", f"syntax error: {e.msg}"))
    return modules, findings


def _rule_selected(rule: str, select, ignore) -> bool:
    if select and not any(rule.startswith(s) for s in select):
        return False
    if ignore and any(rule.startswith(s) for s in ignore):
        return False
    return True


def run(paths: Iterable[str], select: Optional[Iterable[str]] = None,
        ignore: Optional[Iterable[str]] = None) -> list:
    """Run every registered rule over ``paths``; returns sorted, unsuppressed
    findings. ``select``/``ignore`` filter by rule-ID prefix (``DK2``,
    ``DK201``)."""
    _load_rules()
    _WALKS.clear()
    try:
        return _run(paths, select, ignore)
    finally:
        _WALKS.clear()


def _run(paths, select, ignore) -> list:
    select = [s.upper() for s in select] if select else None
    ignore = [s.upper() for s in ignore] if ignore else None
    modules, findings = parse_modules(paths)
    by_path = {m.path: m for m in modules}
    for checker in _MODULE_CHECKERS:
        for mod in modules:
            findings.extend(checker(mod))
    for checker in _PROJECT_CHECKERS:
        findings.extend(checker(modules))
    findings.extend(_stale_suppressions(modules, findings))
    kept = []
    for f in findings:
        if not _rule_selected(f.rule, select, ignore):
            continue
        mod = by_path.get(f.path)
        if mod is not None and mod.suppressed(f.rule, f.line):
            continue
        kept.append(f)
    return sorted(set(kept))


def _stale_suppressions(modules, findings) -> list:
    """DK001: a specific-rule suppression that matched no raw finding.

    Works on the *pre-suppression* finding set — a suppression is live
    iff the rule it names actually fires on its line (or anywhere in the
    file, for ``disable-file``). Blanket ``*`` suppressions are exempt:
    they state intent about the line, not about one rule's behavior.
    """
    out = []
    by_mod: dict = {}
    for f in findings:
        by_mod.setdefault(f.path, set()).add((f.line, f.rule))
    for mod in modules:
        hits = by_mod.get(mod.path, set())
        file_rules = {r for _ln, r in hits}
        for line, rules in sorted(mod.suppressions.items()):
            for rule in sorted(rules - {"*"}):
                if (line, rule) not in hits:
                    out.append(Finding(
                        mod.path, line, 0, "DK001",
                        f"stale suppression: {rule} can no longer fire on "
                        "this line — remove the `# dk: disable` comment "
                        "(or fix the rule ID)"))
        for rule in sorted(mod.file_suppressions - {"*"}):
            if rule not in file_rules:
                out.append(Finding(
                    mod.path, mod.file_suppression_lines.get(rule, 1), 0,
                    "DK001",
                    f"stale suppression: {rule} no longer fires anywhere "
                    "in this file — remove the `# dk: disable-file` "
                    "comment"))
    return out


def render(findings: list, fmt: str = "text") -> str:
    if fmt == "json":
        return json.dumps({"findings": [f.to_json() for f in findings],
                           "count": len(findings)}, indent=2)
    lines = [f.render() for f in findings]
    lines.append(f"dk-check: {len(findings)} finding(s)")
    return "\n".join(lines)


# -- shared AST helpers (used by the rule modules) --------------------------

#: id(node) -> (node, its walk): each subtree's walk listed once a run
_WALKS: dict = {}


def walk(node: ast.AST):
    """``ast.walk(node)``, listed on first use and replayed after: the rules
    walk the same modules, classes and functions many times over, and no
    rule mutates a tree. The entry holds the node, so its id stays its
    own while the entry lives; :func:`run` empties the table."""
    hit = _WALKS.get(id(node))
    if hit is None or hit[0] is not node:
        hit = _WALKS[id(node)] = (node, list(ast.walk(node)))
    return iter(hit[1])


def call_name(node: ast.AST) -> str:
    """Dotted name of a call target / attribute chain, '' when dynamic."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def walk_scope(fn: ast.AST):
    """Yield nodes of a function body without descending into nested defs
    (class bodies still descend — they execute inline)."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            todo.extend(ast.iter_child_nodes(node))
