"""The port's metric-name registry (``telemetry/registry.py``): every
``counter``/``gauge``/``histogram``/``span`` name literal the port emits,
and every f-string's constant lead, is declared there (the JAX package's
dk-check DK601 keys on its own registry, so the port's names are held
here); every row the two packages share has the JAX package's kind,
category and doc; and the observability env vars the plane reads are the
JAX package's rows."""

import ast
import os

import pytest

from distkeras_tpu.runtime import config as jax_config
from distkeras_tpu.telemetry import registry as jax_registry
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.telemetry import registry

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "distkeras_tpu_torch")
KINDS = frozenset({"counter", "gauge", "histogram", "span"})
#: the receivers dk-check's DK601 treats as the telemetry registry.
RECEIVERS = frozenset({"telemetry", "tele", "tel", "t", "_t"})
#: names only the port emits (no row in the JAX package's registry).
PORT_ONLY = {"checkpoint.save", "copy", "digest", "write", "load", "verify",
             "native.scale_calls", "native.scale_fallback_calls",
             "netps.remote.local_window", "serving.dispatch_errors",
             "dispatch[blocked]", "retire[blocked]", "retire[auto]",
             "program.capture", "program.blocks.graph",
             "program.blocks.eager", "program.rounds_per_program"}


def _call_name(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _emitted():
    """``(path, line, kind, name, is_lead)`` for every metric-name call in
    the port's source (DK601's rule: the last attribute names the kind,
    the one before it one of the registry receivers)."""
    out = []
    for root, _dirs, files in os.walk(PKG):
        for fn in sorted(files):
            path = os.path.join(root, fn)
            if not fn.endswith(".py") or path.endswith(
                    os.path.join("telemetry", "registry.py")):
                continue
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                name = _call_name(node.func)
                if not name:
                    continue
                parts = name.split(".")
                if parts[-1] not in KINDS or (len(parts) > 1 and
                                              parts[-2] not in RECEIVERS):
                    continue
                arg = node.args[0]
                rel = os.path.relpath(path, PKG)
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    out.append((rel, node.lineno, parts[-1], arg.value,
                                False))
                elif isinstance(arg, ast.JoinedStr):
                    lead = ""
                    for v in arg.values:
                        if not (isinstance(v, ast.Constant)
                                and isinstance(v.value, str)):
                            break
                        lead += v.value
                    out.append((rel, node.lineno, parts[-1], lead, True))
    return out


EMITTED = _emitted()


def test_the_walk_sees_the_port_s_instrumentation():
    names = {e[3] for e in EMITTED}
    assert len(EMITTED) > 100
    assert {"netps.commits", "serving.latency", "checkpoint.save",
            "netps.server."} <= names
    assert any(e[4] for e in EMITTED), "f-string leads are walked"


@pytest.mark.parametrize("rel", sorted({e[0] for e in EMITTED}))
def test_every_emitted_name_is_declared(rel):
    missing = []
    for path, line, kind, name, is_lead in EMITTED:
        if path != rel:
            continue
        ok = (registry.declared_prefix(kind, name) if is_lead
              else registry.declared(kind, name))
        if not ok:
            missing.append(f"{path}:{line} {kind} {name!r}")
    assert not missing, missing


def test_shared_rows_copy_the_reference():
    shared = set(registry.METRIC_REGISTRY) & set(jax_registry.METRIC_REGISTRY)
    assert len(shared) > 100
    for name in shared:
        port, ref = registry.METRIC_REGISTRY[name], \
            jax_registry.METRIC_REGISTRY[name]
        assert (port.kind, port.category, port.doc, port.dynamic) == (
            ref.kind, ref.category, ref.doc, ref.dynamic), name


def test_port_only_rows_are_the_port_s_own_names():
    own = set(registry.METRIC_REGISTRY) - set(jax_registry.METRIC_REGISTRY)
    assert own == PORT_ONLY
    emitted = {e[3] for e in EMITTED if not e[4]}
    assert PORT_ONLY <= emitted
    for name in PORT_ONLY:
        assert not jax_registry.declared(registry.METRIC_REGISTRY[name].kind,
                                         name), name
        assert registry.METRIC_REGISTRY[name].doc


def test_registry_queries_behave_as_the_reference():
    for kind, name in (("counter", "netps.shard.folds.3"),
                       ("span", "netps.server.commit.shm"),
                       ("gauge", "fleet.granted.a.b"),
                       ("counter", "no.such.metric"),
                       ("span", "netps.commits")):
        assert registry.declared(kind, name) == \
            jax_registry.declared(kind, name)
    for kind, lead in (("counter", "netps.shard."), ("span", "netps.rpc."),
                       ("gauge", "zzz.")):
        assert registry.declared_prefix(kind, lead) == \
            jax_registry.declared_prefix(kind, lead)


OBSERVABILITY = ("DKTPU_TELEMETRY", "DKTPU_TRACE", "DKTPU_TRACE_DIR",
                 "DKTPU_TRACE_RING", "DKTPU_TRACE_ROLE",
                 "DKTPU_TELEMETRY_ROTATE_MB", "DKTPU_HEALTH_TARGETS",
                 "DKTPU_HEALTH_INTERVAL", "DKTPU_HEALTH_RING",
                 "DKTPU_HEALTH_DOWN_AFTER", "DKTPU_HEALTH_SLO",
                 "DKTPU_VITALS_S")


@pytest.mark.parametrize("name", OBSERVABILITY)
def test_observability_env_vars_are_the_reference_rows(name):
    port, ref = config.ENV_REGISTRY[name], jax_config.ENV_REGISTRY[name]
    assert (port.kind, port.default, port.category) == (
        ref.kind, ref.default, ref.category)
    if name != "DKTPU_VITALS_S":  # the port's reads the card, not jax
        assert port.doc == ref.doc
