"""dk-check for the port (``distkeras_tpu_torch.analysis``) held to the JAX
package's (``distkeras_tpu.analysis``) on the CPU: the six non-JAX
fixtures fire on the reference's planted lines, the captured-code family
(DK1xx) fires on every form inside a capture and on none outside, the
suppression, selection, CLI, catalog and registry/docs cases of
``tests/test_analysis.py`` on the port's own registries and tables, the
port package clean with no seam patched, and the CLI run where neither
JAX nor the JAX package can be imported."""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from distkeras_tpu.analysis import run as jax_run
from distkeras_tpu.runtime import config as jax_config
from distkeras_tpu.telemetry import registry as jax_registry
from distkeras_tpu_torch.analysis import core, run
from distkeras_tpu_torch.analysis import rules_torch
from distkeras_tpu_torch.runtime import config
from distkeras_tpu_torch.telemetry import registry

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "distkeras_tpu_torch"
FIXTURES = ROOT / "tests" / "fixtures" / "analysis"
#: every fixture but the JAX family's (``jax_violations.py``: DK1xx over
#: traced code, which the port's DK1xx over captured code does not read)
PORT_FIXTURES = sorted(f for f in os.listdir(FIXTURES)
                       if f.endswith(".py") and f != "jax_violations.py")
_PLANT_RE = re.compile(r"#\s*PLANT:\s*([A-Z0-9 ]+)")
_PLANT_FILE_RE = re.compile(r"#\s*PLANT-FILE:\s*(DK\d+)=(\d+)")
_NAME_RE = re.compile(r"`'?([^`']+)'?`")
#: modules a process without JAX cannot import
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "distkeras_tpu")


def _expected(path):
    """(line-pinned {(line, rule)}, file-level {rule: count}) from markers."""
    pinned, counts = set(), {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            m = _PLANT_RE.search(line)
            if m:
                for rule in m.group(1).split():
                    pinned.add((lineno, rule))
            m = _PLANT_FILE_RE.search(line)
            if m:
                counts[m.group(1)] = int(m.group(2))
    return pinned, counts


def _declared_only_by_the_port(finding) -> bool:
    """A reference DK302/DK601 finding whose name the port's registry
    declares (and the JAX package's does not): the port's verdict on that
    line differs for that reason alone."""
    names = _NAME_RE.findall(finding.message)
    if not names:
        return False
    name, words = names[0], finding.message.split()
    if finding.rule == "DK302":
        return name in config.ENV_REGISTRY
    if finding.rule == "DK601" and words[0] == "dynamic":
        return registry.declared_prefix(words[1], name)
    if finding.rule == "DK601":
        return registry.declared(words[0], name)
    return False


@pytest.mark.parametrize("fixture", PORT_FIXTURES)
def test_fixture_rules_fire_on_the_reference_s_planted_lines(fixture):
    path = str(FIXTURES / fixture)
    pinned, counts = _expected(path)
    assert pinned or counts, f"{fixture} has no PLANT markers"
    ref = jax_run([path])
    port = run([path])
    # Lines where the port's registry declares a name the JAX one lacks
    # (none in the fixtures today): the port is held to the reference's
    # verdict minus exactly those findings.
    port_only = {(f.line, f.rule) for f in ref
                 if _declared_only_by_the_port(f)}
    assert port_only == set(), port_only
    want = {(f.line, f.rule) for f in ref} - port_only
    got = {(f.line, f.rule) for f in port}
    assert got == want, (f"{fixture}: port vs reference\n"
                         f"  missing: {sorted(want - got)}\n"
                         f"  extra:   {sorted(got - want)}")
    got_pinned = {(f.line, f.rule) for f in port if f.rule not in counts}
    assert got_pinned == pinned, (f"{fixture}: planted vs fired\n"
                                  f"  missing: {sorted(pinned - got_pinned)}\n"
                                  f"  extra:   {sorted(got_pinned - pinned)}")
    for rule, n in counts.items():
        assert len([f for f in port if f.rule == rule]) == n, (fixture, rule)


# -- DK1xx over captured code -----------------------------------------------

def _forms():
    """(statement, rule) for every form DK101, DK102, DK103 and DK105 read.
    Each statement runs in a function of ``(self, x)`` nested in a scope
    that binds ``v``; ``acc`` is a module global, ``tele`` a telemetry
    handle."""
    forms = []
    args = {"os.environ.get": '"HOME"', "os.getenv": '"HOME"'}
    for name in sorted(rules_torch._IMPURE_READS):
        forms.append((f"y = {name}({args.get(name, '')})", "DK101"))
    for acc, var in (("env_bool", "DKTPU_TELEMETRY"),
                     ("env_int", "DKTPU_NET_RETRIES"),
                     ("env_float", "DKTPU_NET_TIMEOUT"),
                     ("env_str", "DKTPU_FAULTS"),
                     ("env_is_set", "DKTPU_FAULTS")):
        assert acc in rules_torch._CONFIG_ACCESSORS
        forms.append((f'y = config.{acc}("{var}")', "DK101"))
    forms += [("y = random.random()", "DK101"),
              ("y = np.random.rand(3)", "DK101"),
              ("y = numpy.random.seed(0)", "DK101"),
              ('y = os.environ["HOME"]', "DK101")]
    forms += [('open("f")', "DK102"), ("print(x)", "DK102"),
              ("input()", "DK102"), ('subprocess.run(["true"])', "DK102"),
              ('shutil.rmtree("d")', "DK102"), ('logging.info("x")', "DK102"),
              ("time.sleep(0)", "DK102"), ('warnings.warn("x")', "DK102")]
    for name in sorted(rules_torch._IO_OS_CALLS):
        forms.append((f'{name}("p")', "DK102"))
    for attr in sorted(rules_torch._DEVICE_READS - {"synchronize"}):
        forms.append((f"y = x.{attr}()", "DK102"))
        forms.append((f"y = (x + 1).{attr}()", "DK102"))
    forms += [("torch.cuda.synchronize()", "DK102"),
              ("torch.cuda.current_stream().synchronize()", "DK102")]
    forms += [('telemetry.counter("a").add(1)', "DK103"),
              ('telemetry.event("e", {})', "DK103"),
              ('tele.gauge("g").set(1)', "DK103"),
              ('tele.span("s")', "DK103")]
    for name in sorted(rules_torch._MUTATORS):
        forms.append((f"acc.{name}(1)", "DK105"))
    forms += [("global G", "DK105"), ("nonlocal v", "DK105"),
              ("self.n = 1", "DK105"), ("self.n += 1", "DK105")]
    return forms


#: the ways code is captured, one template each, holding ``{i}`` and
#: ``{stmt}`` (the statement, indented to its block)
_CAPTURES = (
    "@program.captured\ndef cap_{i}(self, x):\n{stmt}\n",
    "@captured\ndef cap_{i}(self, x):\n{stmt}\n",
    "def cap_{i}(self, x):\n{stmt}\n"
    "graphed_{i} = torch.cuda.make_graphed_callables(cap_{i}, (x0,))\n",
    "def cap_{i}(self, x):\n{stmt}\n"
    "graphed_{i} = torch.cuda.make_graphed_callables((cap_{i}, noop), "
    "((x0,), (x0,)))\n",
    "def cap_{i}(self, x):\n{stmt}\nmarked_{i} = program.captured(cap_{i})\n",
    "def cap_{i}(self, x):\n    with torch.cuda.graph(g, pool=time.time()):"
    "\n{stmt}\n",
)


def _corpus():
    """(source, {(line, rule)} the captures must fire): every form once
    inside a capture (the ways rotating) and once in a plain function."""
    head = ("import logging, os, random, shutil, subprocess, time, warnings\n"
            "import datetime, uuid\nimport numpy\nimport numpy as np\n"
            "import torch\nfrom distkeras_tpu_torch import telemetry\n"
            "from distkeras_tpu_torch.parallel import program\n"
            "from distkeras_tpu_torch.parallel.program import captured\n"
            "from distkeras_tpu_torch.runtime import config\n"
            "acc, G, g, x0 = [], 0, None, None\ntele = telemetry.get()\n\n\n"
            "def noop(x):\n    return x\n")
    lines = head.splitlines()
    want = set()
    for i, (stmt, rule) in enumerate(_forms()):
        for inside in (True, False):
            tmpl = (_CAPTURES[i % len(_CAPTURES)] if inside
                    else "def plain_{i}(self, x):\n{stmt}\n")
            body = tmpl.format(i=i, stmt="        " + stmt
                               if "with torch" in tmpl else "    " + stmt)
            block = ["", "", "def scope_%d():" % i, "    v = 0"]
            block += ["    " + ln for ln in body.splitlines()]
            block += ["    return v"]
            start = len(lines) + 1
            lines += block
            if inside:
                at = next(k for k, ln in enumerate(block)
                          if ln.strip() == stmt)
                want.add((start + at, rule))
    return "\n".join(lines) + "\n", want


def test_captured_code_fires_every_form_inside_and_none_outside(tmp_path):
    src, want = _corpus()
    path = tmp_path / "captured_corpus.py"
    path.write_text(src)
    compile(src, str(path), "exec")  # a valid module: nothing skipped
    found = run([str(path)], select=["DK1"])
    got = {(f.line, f.rule) for f in found}
    assert got == want, (f"missing: {sorted(want - got)[:8]}\n"
                         f"extra: {sorted(got - want)[:8]}")
    assert len(found) == len(want)  # one finding a form, none twice
    assert {r for _l, r in want} == {"DK101", "DK102", "DK103", "DK105"}


def test_dk104_keeps_its_jax_meaning(tmp_path):
    """DK104 reads jit's static args only, as in the reference: the JAX
    fixture's planted DK104 lines fire in the port's analyzer, and code
    that never calls jit cannot trigger it."""
    path = str(FIXTURES / "jax_violations.py")
    want = {f.line for f in jax_run([path]) if f.rule == "DK104"}
    assert want
    assert {f.line for f in run([path]) if f.rule == "DK104"} == want
    src = tmp_path / "no_jit.py"
    src.write_text("import torch\n\n\n@torch.no_grad()\n"
                   "def f(x, opts=[]):\n    return x\n")
    assert run([str(src)], select=["DK104"]) == []


# -- suppressions, selection, CLI ---------------------------------------------

def test_suppression_comment_silences_rule(tmp_path):
    src = (
        "def f(q):\n"
        "    try:\n"
        "        q.get()\n"
        "    except:  # dk: disable=DK204 - intentional\n"
        "        pass\n"
        "def g(q):\n"
        "    try:\n"
        "        q.get()\n"
        "    except:\n"
        "        pass\n")
    p = tmp_path / "supp.py"
    p.write_text(src)
    findings = run([str(p)])
    assert [f.line for f in findings if f.rule == "DK204"] == [9]
    p.write_text("# dk: disable-file=DK204\n" + src)
    assert run([str(p)]) == []


def test_stale_suppression_fires_and_live_one_does_not(tmp_path):
    p = tmp_path / "stale.py"
    p.write_text(
        "def f(q):\n"
        "    try:\n"
        "        q.get()\n"
        "    except:  # dk: disable=DK204\n"      # live: DK204 fires here
        "        pass\n"
        "x = 1  # dk: disable=DK204\n")           # stale: it cannot
    findings = run([str(p)])
    assert [(f.line, f.rule) for f in findings] == [(6, "DK001")]


def test_stale_file_suppression_points_at_its_comment(tmp_path):
    p = tmp_path / "stale_file.py"
    p.write_text("x = 1\n# dk: disable-file=DK301\ny = 2\n")
    findings = run([str(p)])
    assert [(f.line, f.rule) for f in findings] == [(2, "DK001")]


def test_blanket_suppression_is_exempt_from_dk001(tmp_path):
    p = tmp_path / "blanket.py"
    p.write_text("x = 1  # dk: disable\n")
    assert run([str(p)]) == []


def test_a_captured_suppression_is_live_and_goes_stale_outside(tmp_path):
    """A DK1xx suppression in captured code silences its finding; the same
    comment in a plain function is stale (DK001)."""
    p = tmp_path / "cap_supp.py"
    p.write_text(
        "from distkeras_tpu_torch.parallel import program\n\n\n"
        "@program.captured\n"
        "def f(x):\n"
        "    return x.item()  # dk: disable=DK102\n\n\n"
        "def g(x):\n"
        "    return x.item()  # dk: disable=DK102\n")
    assert [(f.line, f.rule) for f in run([str(p)])] == [(10, "DK001")]


def test_select_ignore_and_syntax_error(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    findings = run([str(p)])
    assert [f.rule for f in findings] == ["DK000"]
    fix = str(FIXTURES / "config_violations.py")
    only_302 = run([fix], select=["DK302"])
    assert only_302 and all(f.rule == "DK302" for f in only_302)
    no_3xx = run([fix], ignore=["DK3"])
    assert [f.rule for f in no_3xx] == ["DK001"]
    assert run([fix], ignore=["DK3", "DK0"]) == []


def test_cli_roundtrip(tmp_path, capsys):
    from distkeras_tpu_torch.analysis.__main__ import main

    fix = str(FIXTURES / "config_violations.py")
    assert main([fix, "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["count"] == len(payload["findings"]) > 0
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert main([str(clean)]) == 0
    assert main([str(tmp_path / "nope.py")]) == 2
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rule in ("DK101", "DK201", "DK301", "DK401", "DK501", "DK601"):
        assert rule in listed
    assert "captured code" in listed


def test_rule_catalog_documented():
    core._load_rules()
    text = (PKG / "docs" / "ANALYSIS.md").read_text()
    for rule in core.RULE_CATALOG:
        assert rule in text, f"{rule} missing from the port's ANALYSIS.md"
    assert set(core.RULE_CATALOG) >= {
        "DK001", "DK101", "DK102", "DK103", "DK104", "DK105", "DK201",
        "DK202", "DK203", "DK204", "DK301", "DK302", "DK303", "DK401",
        "DK402", "DK403", "DK501", "DK502", "DK601", "DK602", "DK603"}


# -- the port package, with no seam patched, and without JAX ------------------

@pytest.fixture(scope="module")
def cli_without_jax():
    """``python -m distkeras_tpu_torch.analysis --format json`` over the
    port, in a process where JAX and the JAX package cannot be imported."""
    code = ("import runpy, sys\n"
            f"for name in {BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['dk-check', '--format', 'json']\n"
            "try:\n"
            "    runpy.run_module('distkeras_tpu_torch.analysis',"
            " run_name='__main__', alter_sys=True)\n"
            "finally:\n"
            "    loaded = sorted(k for k in sys.modules if sys.modules[k] "
            "is not None and k.split('.')[0] in "
            f"{BLOCKED!r})\n"
            "    print('LOADED', loaded, file=sys.stderr)\n")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_the_port_package_is_clean(cli_without_jax):
    payload = json.loads(cli_without_jax.stdout)
    assert payload == {"findings": [], "count": 0}, payload["findings"][:5]


def test_the_cli_runs_where_jax_cannot_be_imported(cli_without_jax):
    assert cli_without_jax.returncode == 0, cli_without_jax.stderr[-2000:]
    assert "LOADED []" in cli_without_jax.stderr


# -- the port's registries and tables -----------------------------------------

def test_metric_registry_declares_and_renders():
    assert registry.declared("counter", "netps.commits")
    assert not registry.declared("gauge", "netps.commits")  # kind-checked
    assert not registry.declared("counter", "netps.nope")
    assert registry.declared("counter", "program.blocks.graph")
    assert registry.declared_prefix("span", "netps.rpc.")
    assert not registry.declared_prefix("counter", "made.up.")
    table = registry.render_metric_table("netps")
    assert "`netps.commits`" in table and "`netps.rpc.*`" in table
    doc = ("<!-- dk-metric:begin category=netps -->\nOUTDATED\n"
           "<!-- dk-metric:end -->")
    spliced = registry.splice_metric_docs(doc)
    assert "OUTDATED" not in spliced and "`netps.commits`" in spliced
    with pytest.raises(ValueError):
        registry.splice_metric_docs("no markers", path_hint="f.md")
    with pytest.raises(ValueError):
        list(registry.iter_metrics("no-such-category"))


def test_env_docs_render_and_splice():
    table = config.render_env_table("resilience")
    assert "`DKTPU_FAULTS`" in table and "DKTPU_TELEMETRY" not in table
    doc = ("x\n<!-- dk-env:begin category=resilience -->\nstale\n"
           "<!-- dk-env:end -->\ny")
    spliced = config.splice_env_docs(doc)
    assert "stale" not in spliced and "`DKTPU_NAN_GUARD`" in spliced
    with pytest.raises(ValueError):
        config.splice_env_docs("no markers here", path_hint="f.md")


def _rows(table: str) -> dict:
    return {row.split(" | ")[0][2:]: row for row in table.splitlines()[2:]}


def test_the_port_s_renderers_give_the_reference_s_rows():
    """Every metric both registries declare renders the same row in both
    packages. Every shared env variable renders the same name, type,
    default and category; its description is each package's own (the
    port rewords some for the card), so those cells are held to the
    reference's renderer fed the port's rows instead."""
    port, ref = (_rows(registry.render_metric_table()),
                 _rows(jax_registry.render_metric_table()))
    shared = set(port) & set(ref)
    assert len(shared) == len(jax_registry.METRIC_REGISTRY)
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    port, ref = (_rows(config.render_env_table()),
                 _rows(jax_config.render_env_table()))
    shared = set(port) & set(ref)
    assert len(shared) == len(jax_config.ENV_REGISTRY)
    for k in shared:
        assert port[k].split(" | ")[:4] == ref[k].split(" | ")[:4], k
    for category in sorted({v.category for v in config.ENV_REGISTRY.values()}):
        mine = config.render_env_table(category)
        rows = {n: v for n, v in config.ENV_REGISTRY.items()
                if v.category == category}
        saved = jax_config.ENV_REGISTRY
        try:
            jax_config.ENV_REGISTRY = rows
            assert jax_config.render_env_table(category) == mine, category
        finally:
            jax_config.ENV_REGISTRY = saved


def test_the_port_s_tables_match_its_registries():
    """The port's ``docs/`` is generated from its registries: DK303 and
    DK602 find nothing there, and every name only the port declares
    (``program.blocks.graph``, ``serving.dispatch_errors``, the rank
    variables) has its row."""
    from distkeras_tpu_torch.analysis import rules_config, rules_contracts

    modules, errs = core.parse_modules([
        str(PKG / "runtime" / "config.py"),
        str(PKG / "telemetry" / "registry.py"),
        str(PKG / "resilience" / "faults.py")])
    assert not errs
    assert rules_config.check_env_docs(modules) == []
    assert rules_contracts.check_metric_docs(modules) == []
    assert rules_contracts.check_fault_kinds(modules) == []
    blob = "\n".join(p.read_text() for p in (PKG / "docs").glob("*.md"))
    for name in ("program.blocks.graph", "serving.dispatch_errors",
                 "WORLD_SIZE", "LOCAL_RANK"):
        assert f"`{name}`" in blob, name


def test_env_docs_drift_is_a_finding(tmp_path):
    """DK303 on a scratch package tree: a stale table block and a
    registered variable in no table."""
    from distkeras_tpu_torch.analysis import rules_config

    (tmp_path / "pkg" / "runtime").mkdir(parents=True)
    cfg = tmp_path / "pkg" / "runtime" / "config.py"
    cfg.write_text((PKG / "runtime" / "config.py").read_text())
    docs = tmp_path / "pkg" / "docs"
    docs.mkdir()
    (docs / "ENV.md").write_text(
        "<!-- dk-env:begin category=ranks -->\nstale\n<!-- dk-env:end -->\n")
    modules, errs = core.parse_modules([str(cfg)])
    assert not errs
    findings = rules_config.check_env_docs(modules)
    assert any("stale vs ENV_REGISTRY" in f.message for f in findings)
    assert any("`DKTPU_FAULTS` is registered but appears in no" in f.message
               for f in findings)


def test_metric_docs_drift_is_a_finding(tmp_path, monkeypatch):
    from distkeras_tpu_torch.analysis import rules_contracts

    modules, errs = core.parse_modules(
        [str(PKG / "telemetry" / "registry.py")])
    assert not errs
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "OBS.md").write_text(
        "<!-- dk-metric:begin category=netps -->\nstale\n"
        "<!-- dk-metric:end -->\n")
    monkeypatch.setattr(rules_contracts, "_docs_dir_for",
                        lambda _p: str(docs))
    findings = rules_contracts.check_metric_docs(modules)
    assert any("stale vs the registry" in f.message for f in findings)
    assert any("registered but appears in no docs" in f.message
               for f in findings)


def test_fault_kind_drift_is_a_finding(tmp_path, monkeypatch):
    from distkeras_tpu_torch.analysis import rules_contracts

    modules, errs = core.parse_modules(
        [str(PKG / "resilience" / "faults.py")])
    assert not errs
    assert rules_contracts.check_fault_kinds(modules) == []  # real docs ok
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "RESILIENCE.md").write_text(
        "| `preempt@R` | x | y |\n| `ghost_fault@R` | x | y |\n")
    monkeypatch.setattr(rules_contracts, "_docs_dir_for",
                        lambda _p: str(docs))
    findings = rules_contracts.check_fault_kinds(modules)
    assert any("has no row" in f.message for f in findings)
    assert any("ghost_fault" in f.message and "stale docs row" in f.message
               for f in findings)


def test_the_wire_scope_reads_the_port_s_netps(tmp_path):
    """A module that imports the port's netps from outside ``netps/`` is on
    the wire plane (DK401-DK403 read it); a name match, not an import."""
    src = ("import struct\n"
           "from distkeras_tpu_torch.netps import wire\n\n\n"
           "def send(client, hdr):\n"
           '    client._rpc("join", hdr)\n'
           '    return struct.pack("<I", 1), hdr.get("branch_id")\n')
    p = tmp_path / "speaker.py"
    p.write_text(src)
    assert sorted((f.line, f.rule) for f in run([str(p)])) == [
        (6, "DK401"), (7, "DK402"), (7, "DK403")]
    p.write_text(src.replace("distkeras_tpu_torch.netps", "numpy"))
    assert run([str(p)]) == []
