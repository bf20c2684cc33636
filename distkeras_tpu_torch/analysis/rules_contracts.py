"""DK6xx — contract-registry cross-checks (telemetry names, fault kinds),
the JAX package's ``analysis/rules_contracts.py`` reading the port's
``telemetry/registry.py``, ``resilience/faults.py`` and
``distkeras_tpu_torch/docs/``.

The DK30x pattern (declare once, generate docs, lint the drift) applied
to the two other stringly-typed contract surfaces:

* **DK601** — a ``telemetry.counter/gauge/histogram/span`` name literal
  not declared in :mod:`distkeras_tpu_torch.telemetry.registry`:
  undeclared names are invisible to the port's metric tables and to
  dashboards keyed on the registry. F-strings check their constant lead
  against the registry's ``dynamic`` prefixes.
* **DK602** — metric registry/docs drift: a registered metric absent
  from the port's ``docs/`` tables, or a ``<!-- dk-metric:begin -->``
  block whose content no longer matches the registry rendering (fix with
  ``python -m distkeras_tpu_torch.analysis --write-metric-docs``).
* **DK603** — fault-kind drift between ``resilience/faults.py``
  (``_KINDS`` / ``_NET_KINDS``) and the port's RESILIENCE.md fault
  tables: an implemented kind with no documented row, or a documented
  entry no ``FaultPlan`` accepts. (``*_r@F`` documents every ``_r`` reply
  variant; ``seed`` is plan syntax, not a kind.)

DK602/DK603 only fire when the scan includes the real registry /
faults module, so the fixture corpus stays naturally exempt (the DK303
pattern).
"""

from __future__ import annotations

import ast
import glob
import os
import re

from distkeras_tpu_torch.analysis.core import (
    Finding, Module, RuleInfo, call_name, module_rule, project_rule, walk)

_METRIC_KINDS = frozenset({"counter", "gauge", "histogram", "span"})
_TELEMETRY_RECEIVERS = frozenset({"telemetry", "tele", "tel", "t", "_t"})
_REGISTRY_SUFFIX = os.path.join("telemetry", "registry.py")
_FAULTS_SUFFIX = os.path.join("resilience", "faults.py")

#: backtick token in RESILIENCE.md: the kind name before ``@``/``=``.
_FAULT_TOKEN_RE = re.compile(r"`(\*?[a-z][a-z0-9_]*|\*_r)(?:@[^`]*|=[^`]*)?`")


def _registry():
    from distkeras_tpu_torch.telemetry import registry

    return registry


def _metric_call(node: ast.Call):
    """(kind, name_node) when this is a telemetry name-taking call with a
    literal first argument; None otherwise."""
    name = call_name(node.func)
    if not name:
        return None
    parts = name.split(".")
    kind = parts[-1]
    if kind not in _METRIC_KINDS:
        return None
    if len(parts) > 1 and parts[-2] not in _TELEMETRY_RECEIVERS:
        return None
    if not node.args:
        return None
    arg = node.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return kind, arg
    if isinstance(arg, ast.JoinedStr):
        return kind, arg
    return None


def _joined_lead(node: ast.JoinedStr) -> str:
    lead = []
    for part in node.values:
        if isinstance(part, ast.Constant) and isinstance(part.value, str):
            lead.append(part.value)
        else:
            break
    return "".join(lead)


@module_rule(
    RuleInfo("DK601", "telemetry name not declared in telemetry/registry"),
)
def check_metric_names(mod: Module) -> list:
    if os.path.normpath(mod.path).endswith(_REGISTRY_SUFFIX):
        return []
    reg = _registry()
    out: list = []
    for node in walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        hit = _metric_call(node)
        if hit is None:
            continue
        kind, arg = hit
        if isinstance(arg, ast.Constant):
            if not reg.declared(kind, arg.value):
                out.append(Finding(
                    mod.path, arg.lineno, arg.col_offset, "DK601",
                    f"{kind} name `{arg.value!r}` is not declared in "
                    "telemetry/registry.py: undeclared metrics are "
                    "invisible to the metric tables"))
        else:
            lead = _joined_lead(arg)
            if not reg.declared_prefix(kind, lead):
                out.append(Finding(
                    mod.path, arg.lineno, arg.col_offset, "DK601",
                    f"dynamic {kind} name (constant lead `{lead!r}`) "
                    "matches no dynamic=True prefix in "
                    "telemetry/registry.py: declare the prefix"))
    return out


def _docs_dir_for(mod_path: str) -> str:
    """The package's own ``docs/`` (``distkeras_tpu_torch/docs``)."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(mod_path)))
    return os.path.join(pkg_root, "docs")


@project_rule(
    RuleInfo("DK602", "metric docs table out of sync with the registry"),
)
def check_metric_docs(modules) -> list:
    reg_mod = next((m for m in modules if os.path.normpath(m.path)
                    .endswith(_REGISTRY_SUFFIX)), None)
    if reg_mod is None:
        return []
    docs_dir = _docs_dir_for(reg_mod.path)
    if not os.path.isdir(docs_dir):
        return []
    reg = _registry()
    docs: dict = {}
    for path in sorted(glob.glob(os.path.join(docs_dir, "*.md"))):
        with open(path, encoding="utf-8") as f:
            docs[path] = f.read()
    out: list = []

    def decl_line(name: str) -> int:
        for i, line in enumerate(reg_mod.source.splitlines(), 1):
            if f'"{name}"' in line:
                return i
        return 1

    blob = "\n".join(docs.values())
    for m in reg.iter_metrics():
        if f"`{m.name}`" not in blob and f"`{m.name}*`" not in blob:
            out.append(Finding(
                reg_mod.path, decl_line(m.name), 0, "DK602",
                f"metric `{m.name}` is registered but appears in no "
                "docs/*.md table: run `python -m "
                "distkeras_tpu_torch.analysis --write-metric-docs`"))
    for path, text in docs.items():
        try:
            fresh = reg.splice_metric_docs(text)
        except ValueError:
            continue
        if fresh != text:
            out.append(Finding(
                reg_mod.path, 1, 0, "DK602",
                f"{os.path.basename(path)} metric table is stale vs the "
                "registry: run `python -m distkeras_tpu_torch.analysis "
                "--write-metric-docs`"))
    return out


def _parse_kind_sets(mod: Module) -> dict:
    """{set_name: (kinds, line)} for _KINDS / _NET_KINDS frozensets."""
    out: dict = {}
    for node in mod.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not any(n in ("_KINDS", "_NET_KINDS") for n in names):
            continue
        val = node.value
        elts = []
        if (isinstance(val, ast.Call) and val.args
                and call_name(val.func) in ("frozenset", "set")):
            val = val.args[0]
        if isinstance(val, (ast.Set, ast.Tuple, ast.List)):
            elts = [e.value for e in val.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)]
        out[names[0]] = (frozenset(elts), node.lineno)
    return out


@project_rule(
    RuleInfo("DK603", "fault kinds drift from the RESILIENCE.md tables"),
)
def check_fault_kinds(modules) -> list:
    faults_mod = next((m for m in modules if os.path.normpath(m.path)
                       .endswith(_FAULTS_SUFFIX)), None)
    if faults_mod is None:
        return []
    doc_path = os.path.join(_docs_dir_for(faults_mod.path),
                            "RESILIENCE.md")
    if not os.path.isfile(doc_path):
        return []
    sets = _parse_kind_sets(faults_mod)
    code_kinds = frozenset().union(*(k for k, _ in sets.values())) \
        if sets else frozenset()
    if not code_kinds:
        return []
    with open(doc_path, encoding="utf-8") as f:
        doc = f.read()
    doc_kinds = set()
    table_kinds: dict = {}   # token -> first doc line (fault-table rows)
    for i, line in enumerate(doc.splitlines(), 1):
        tokens = _FAULT_TOKEN_RE.findall(line)
        doc_kinds.update(tokens)
        if line.lstrip().startswith("|"):
            first_cell = line.split("|")[1] if "|" in line else ""
            for tok in _FAULT_TOKEN_RE.findall(first_cell):
                # only @/= entry syntax marks a fault-plan row
                if re.search(rf"`{re.escape(tok)}[@=]", first_cell):
                    table_kinds.setdefault(tok, i)
    out: list = []
    for name, (kinds, line) in sorted(sets.items()):
        for kind in sorted(kinds):
            covered = (kind in doc_kinds
                       or (kind.endswith("_r") and "*_r" in doc_kinds
                           and kind[:-2] in doc_kinds))
            if not covered:
                out.append(Finding(
                    faults_mod.path, line, 0, "DK603",
                    f"fault kind `{kind}` ({name}) has no row in "
                    "docs/RESILIENCE.md: every injectable fault documents "
                    "its recovery path there"))
    for tok, line in sorted(table_kinds.items()):
        if tok in ("seed", "*_r") or tok in code_kinds:
            continue
        out.append(Finding(
            faults_mod.path, 1, 0, "DK603",
            f"docs/RESILIENCE.md line {line} documents fault `{tok}` "
            "but no FaultPlan accepts it: stale docs row"))
    return out
