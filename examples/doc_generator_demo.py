#!/usr/bin/env python
"""PluginDocGenerator: render plugin reference docs from a live Context.

Generates one markdown page per registered plugin plus an index table —
the same generator `waveform-docs` drives from the CLI, and the one the
doc-coverage CI gate runs against. (reference analog:
examples/demo_doc_generator.py, whose DocGenerator emits api/config/plugin
references; our pages fold the option/config tables into each plugin page.)
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

from waveformanalysis_tpu.context.context import Context
from waveformanalysis_tpu.plugins.plugin_sets import default_plugins
from waveformanalysis_tpu.utils.plugin_doc_generator import (
    PluginDocGenerator,
    check_doc_coverage,
)


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=str(Path(tmp) / "store"),
                      config={"show_progress": False})
        ctx.register(*default_plugins())
        gen = PluginDocGenerator(ctx)

        # -- 1. one page, human variant ------------------------------------
        page = gen.render_plugin("hit")
        print(page.splitlines()[0])
        print(f"... ({len(page.splitlines())} lines)")

        # -- 2. the index table ----------------------------------------------
        index = gen.render_index()
        print("\nindex head:")
        print("\n".join(index.splitlines()[:6]))

        # -- 3. everything at once -------------------------------------------
        out_dir = Path(tmp) / "docs"
        written = gen.generate_all(out_dir)
        print(f"\nwrote {len(written)} files to {out_dir}")

        # -- 4. the coverage check CI runs -----------------------------------
        report = check_doc_coverage(ctx, out_dir)
        print("coverage report:", report)


if __name__ == "__main__":
    main()
