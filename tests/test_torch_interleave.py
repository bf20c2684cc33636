"""The port's interleaving checker (``distkeras_tpu_torch.analysis.
interleave``) on the port's own machines (``netps/server.py PSServer``,
``streaming/journal.py OffsetJournal``, ``netps/hier.py
AggregatorServer``), centers on the CPU: every scenario explores exactly
the JAX package's schedules, crash points and transitions over the JAX
package's machines, with no violation on either; the seeded dedup
mutation is caught; the explorer's exact counts and the CLI, as
``tests/test_analysis.py`` holds the reference's."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from distkeras_tpu.analysis import interleave as jax_interleave
from distkeras_tpu_torch.analysis import interleave

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "distkeras_tpu")


def _counts(results) -> dict:
    return {r.name: {"complete": r.complete, "crashed": r.crashed,
                     "transitions": r.transitions,
                     "violations": len(r.violations)} for r in results}


def test_the_port_s_suite_explores_the_reference_s_state_space():
    """The port's ``run_suite(device="cpu")``, run in a process where JAX
    and the JAX package cannot be imported, beside the reference's
    ``run_suite()``: equal counts, scenario by scenario, no violation."""
    code = ("import json, sys\n"
            f"for name in {BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            "from distkeras_tpu_torch.analysis import interleave\n"
            "res = interleave.run_suite(device='cpu')\n"
            "print(json.dumps({r.name: {'complete': r.complete, "
            "'crashed': r.crashed, 'transitions': r.transitions, "
            "'violations': len(r.violations)} for r in res}))\n")
    # The port's run in its own process while the reference's runs here.
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ref = _counts(jax_interleave.run_suite())
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    port = json.loads(stdout.splitlines()[-1])
    assert port == ref
    assert {k: (v["complete"], v["crashed"]) for k, v in port.items()} == {
        "dedup": (924, 0), "fence": (11550, 0), "journal": (924, 2506),
        "tree_flush": (630, 0)}
    assert all(v["violations"] == 0 for v in port.values()), port


def test_interleave_catches_seeded_dedup_mutation():
    res = interleave.explore(
        lambda: interleave.DedupScenario(interleave._NoDedupServer,
                                         device="cpu"),
        max_schedules=50)
    assert res.violations, "mutated server not caught"
    assert any("folded" in v.message or "duplicate fold" in v.message
               for v in res.violations)


def test_explorer_enumerates_exact_schedule_count():
    """2 threads x 2 steps = C(4,2) = 6 complete schedules; with crash
    points every proper non-empty prefix adds one crashed run."""
    class Tiny(interleave.Scenario):
        name = "tiny"

        def build(self, factory):
            self.log = []

            def script(tag):
                def gen():
                    self.log.append((tag, 0))
                    yield
                    self.log.append((tag, 1))
                return gen
            factory(target=script("a"), name="a")
            factory(target=script("b"), name="b")

    res = interleave.explore(Tiny)
    assert (res.complete, res.crashed) == (6, 0)
    res = interleave.explore(Tiny, crash_points=True)
    assert (res.complete, res.crashed) == (6, 12)
    assert res.violations == []


def test_interleave_cli(capsys, monkeypatch):
    assert interleave.main(["--scenario", "dedup", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "924 complete schedules" in out and "state space" in out
    assert interleave.main(["--scenario", "dedup", "--device", "cpu",
                            "--mutate"]) == 0
    assert "CAUGHT" in capsys.readouterr().out
    # No device named and no card: the servers' default is the card, and
    # the run raises rather than fall back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interleave.main(["--scenario", "dedup"])
