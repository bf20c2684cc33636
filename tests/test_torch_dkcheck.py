"""dk-check on the port: the JAX package's static analysis
(``distkeras_tpu.analysis``) over ``distkeras_tpu_torch/`` finds nothing.

The rules that read a registry (DK302 the environment variables, DK401
the wire ops, DK601 the metric names) import the JAX package's own
registries through one small seam each; the port keeps its own copies of
all three, so the seams are pointed at the port's for the run, with no
edit to the JAX package. DK602 holds ``docs/``, the JAX package's metric
tables, to a registry: it keeps reading the JAX package's there, as a
plain ``python -m distkeras_tpu.analysis`` run does.

The port's own dk-check (``distkeras_tpu_torch.analysis``) reads DK101–
DK105 over *captured* code, which the JAX analyzer's traced-code family
cannot see; the few ``# dk: disable=DK10x`` suppressions the port carries
for it are therefore stale to the JAX analyzer (DK001), and to it alone:
each one must be live under the port's analyzer."""

import pathlib
import types

import pytest

from distkeras_tpu.analysis import core, rules_config, rules_contracts
from distkeras_tpu.analysis import rules_protocol
from distkeras_tpu.telemetry import registry as jax_registry

from distkeras_tpu_torch.netps import wire
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.telemetry import registry

PKG = pathlib.Path(__file__).resolve().parents[1] / "distkeras_tpu_torch"


@pytest.fixture
def port_registries(monkeypatch):
    seam = types.SimpleNamespace(
        declared=registry.declared,
        declared_prefix=registry.declared_prefix,
        iter_metrics=jax_registry.iter_metrics,
        splice_metric_docs=jax_registry.splice_metric_docs)
    monkeypatch.setattr(rules_contracts, "_registry", lambda: seam)
    monkeypatch.setattr(rules_config, "_registry_names",
                        lambda: frozenset(config.ENV_REGISTRY))
    monkeypatch.setattr(rules_protocol, "_wire", lambda: wire)


def test_the_port_has_no_dkcheck_findings(port_registries):
    from distkeras_tpu_torch.analysis import core as port_core

    findings = core.run([str(PKG)])
    captured = [f for f in findings if f.rule == "DK001"
                and "stale suppression: DK10" in f.message]
    rest = [f for f in findings if f not in captured]
    assert rest == [], core.render(rest)
    # Every such DK001 sits on a suppression the port's analyzer needs:
    # its raw DK1xx finding (before suppressions) is on that very line.
    port_modules, _ = port_core.parse_modules(
        sorted({f.path for f in captured}))
    port_core._load_rules()
    raw = {(f.path, f.line, f.rule) for checker in port_core._MODULE_CHECKERS
           for mod in port_modules for f in checker(mod)}
    for f in captured:
        rule = f.message.split("stale suppression: ")[1].split()[0]
        assert (f.path, f.line, rule) in raw, f.render()


def test_the_seams_read_the_port_s_registries(port_registries, tmp_path):
    """A name the port declares and the JAX package does not is clean
    here, and an undeclared one is still caught: the run above is not
    clean for want of checking."""
    mod = tmp_path / "probe.py"
    mod.write_text(
        "from distkeras_tpu_torch import telemetry\n"
        "from distkeras_tpu_torch.runtime import config\n"
        "config.env_setdefault('KERAS_BACKEND', 'torch')\n"
        "config.env_int('WORLD_SIZE')\n"
        "telemetry.counter('no.such.metric').add(1)\n")
    found = core.run([str(mod)])
    assert [f.rule for f in found] == ["DK601"], core.render(found)
