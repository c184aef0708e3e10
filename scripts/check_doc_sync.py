#!/usr/bin/env python
"""Doc-sync checker: fail when docs/plugins/ drifts from the code.

Reference analog: the doc-coverage CI workflow
(.github/workflows/docs-check.yml) + doc-sync checker scripts — regenerate
the plugin doc pages for the default profile into a temp dir and diff them
against the committed pages. By default BOTH committed variants are
checked: human pages in docs/plugins/ and agent pages in
docs/plugins/agent/ (when that directory exists). Exit 0 when in sync, 1
with a per-file report otherwise (refresh with
`waveform-docs generate` / `waveform-docs --out-dir docs/plugins/agent
--variant agent generate`).
"""

from __future__ import annotations

import argparse
import difflib
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def check_dir(ctx: object, committed: Path, variant: str,
              show_diff: bool) -> int:
    from waveformanalysis_tpu.utils.plugin_doc_generator import (
        PluginDocGenerator,
    )

    if not committed.exists():
        print(f"error: {committed} does not exist; generate docs first",
              file=sys.stderr)
        return 1

    with tempfile.TemporaryDirectory() as tmp:
        fresh_dir = Path(tmp) / "docs"
        PluginDocGenerator(ctx).generate_all(fresh_dir, variant=variant)

        fresh = {p.name: p.read_text() for p in sorted(fresh_dir.glob("*.md"))}
        old = {p.name: p.read_text() for p in sorted(committed.glob("*.md"))}

        drifted = []
        for name, text in fresh.items():
            if name not in old:
                drifted.append((name, "missing from committed docs"))
            elif old[name] != text:
                drifted.append((name, "content drift"))
        for name in old:
            if name not in fresh:
                drifted.append((name, "stale page (plugin removed?)"))

        if not drifted:
            print(f"doc-sync OK [{variant}]: {len(fresh)} pages match "
                  f"{committed}")
            return 0
        print(f"doc-sync FAILED [{variant}] in {committed}: "
              f"{len(drifted)} page(s) out of date:")
        for name, why in drifted:
            print(f"  {name}: {why}")
            if show_diff and name in old and name in fresh:
                diff = difflib.unified_diff(
                    old[name].splitlines(), fresh[name].splitlines(),
                    fromfile=f"committed/{name}", tofile=f"generated/{name}",
                    lineterm="",
                )
                for line in list(diff)[:60]:
                    print(f"    {line}")
        print("\nrefresh with: python -m waveformanalysis_tpu.utils.cli_docs "
              f"--out-dir {committed} --variant {variant} generate")
        return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs-dir", default=None,
                    help="Check ONE directory instead of the default pair")
    ap.add_argument("--variant", default="human",
                    choices=["human", "agent"],
                    help="Variant for --docs-dir single-directory mode")
    ap.add_argument("--show-diff", action="store_true",
                    help="Print unified diffs for drifted pages")
    args = ap.parse_args(argv)

    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.plugins.plugin_sets import default_plugins

    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False})
        ctx.register(*default_plugins())

        if args.docs_dir is not None:
            return check_dir(ctx, Path(args.docs_dir), args.variant,
                             args.show_diff)

        rc = check_dir(ctx, Path("docs/plugins"), "human", args.show_diff)
        agent_dir = Path("docs/plugins/agent")
        if agent_dir.exists():
            rc = check_dir(ctx, agent_dir, "agent", args.show_diff) or rc
        return rc


if __name__ == "__main__":
    raise SystemExit(main())
