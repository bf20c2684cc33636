"""dk-check on the port: the JAX package's static analysis
(``distkeras_tpu.analysis``) over ``distkeras_tpu_torch/`` finds nothing.

The rules that read a registry (DK302 the environment variables, DK401
the wire ops, DK601 the metric names) import the JAX package's own
registries through one small seam each; the port keeps its own copies of
all three, so the seams are pointed at the port's for the run, with no
edit to the JAX package. DK602 holds ``docs/``, the JAX package's metric
tables, to a registry: it keeps reading the JAX package's there, as a
plain ``python -m distkeras_tpu.analysis`` run does."""

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
    findings = core.run([str(PKG)])
    assert findings == [], core.render(findings)


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
