"""dk-check CLI for the port: ``python -m distkeras_tpu_torch.analysis
[paths...]``.

Exit status 0 = clean, 1 = findings, 2 = usage error. See
``distkeras_tpu_torch/docs/ANALYSIS.md`` for the rule catalog and
suppression syntax.
"""

from __future__ import annotations

import argparse
import os
import sys

from distkeras_tpu_torch.analysis import core


def _write_docs(docs_dir: str, splice, what: str) -> int:
    """Rewrite every ``docs_dir/*.md`` table block that ``splice`` renders."""
    changed = 0
    for name in sorted(os.listdir(docs_dir)):
        if not name.endswith(".md"):
            continue
        path = os.path.join(docs_dir, name)
        with open(path, encoding="utf-8") as f:
            text = f.read()
        try:
            fresh = splice(text)
        except ValueError:
            continue
        if fresh != text:
            with open(path, "w", encoding="utf-8") as f:
                f.write(fresh)
            print(f"dk-check: rewrote {what} table(s) in {path}")
            changed += 1
    if not changed:
        print(f"dk-check: {what} docs already in sync")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distkeras_tpu_torch.analysis",
        description="dk-check for the port: repo-aware static analysis "
                    "(DK1xx captured code, DK2xx concurrency, DK3xx "
                    "config, DK4xx wire protocol, DK5xx durability, DK6xx "
                    "contract registries)")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/directories to check "
                             "(default: the distkeras_tpu_torch package)")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--select", action="append", default=None,
                        metavar="DKxxx", help="only rules with this ID prefix "
                        "(repeatable, e.g. --select DK2 --select DK301)")
    parser.add_argument("--ignore", action="append", default=None,
                        metavar="DKxxx", help="drop rules with this ID prefix")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--write-env-docs", action="store_true",
                        help="regenerate the env-var tables in the port's "
                             "docs/*.md from runtime.config.ENV_REGISTRY "
                             "and exit")
    parser.add_argument("--write-metric-docs", action="store_true",
                        help="regenerate the metric tables in the port's "
                             "docs/*.md from telemetry.registry and exit")
    args = parser.parse_args(argv)

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    docs_dir = os.path.join(pkg_dir, "docs")
    if args.write_env_docs:
        from distkeras_tpu_torch.runtime import config

        return _write_docs(docs_dir, config.splice_env_docs, "env")
    if args.write_metric_docs:
        from distkeras_tpu_torch.telemetry import registry

        return _write_docs(docs_dir, registry.splice_metric_docs, "metric")
    if args.list_rules:
        core._load_rules()
        for rule in sorted(core.RULE_CATALOG):
            print(f"{rule}  {core.RULE_CATALOG[rule].summary}")
        return 0

    paths = args.paths or [pkg_dir]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"dk-check: no such path: {', '.join(missing)}",
              file=sys.stderr)
        return 2
    findings = core.run(paths, select=args.select, ignore=args.ignore)
    print(core.render(findings, args.format))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
