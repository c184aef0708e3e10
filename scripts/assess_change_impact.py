#!/usr/bin/env python
"""Change-impact assessor: which data names / caches a plugin change touches.

Behavioral analog of the reference's impact script (reference:
scripts/assess_change_impact.py): given one or more plugin data names (or
source files), report every downstream data name whose lineage — and
therefore cache key — changes, plus the cache entries currently on disk that
would be invalidated for a given run.

Usage:
    python scripts/assess_change_impact.py hit basic_features
    python scripts/assess_change_impact.py --file waveformanalysis_tpu/ops/peaks.py
    python scripts/assess_change_impact.py hit --storage-dir ./data --run-id run42
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def plugins_for_file(ctx, path: str) -> list:
    """Map a source file to the registered plugins it (or its kernels) backs."""
    import importlib
    import inspect

    target = Path(path).resolve()
    hits = []
    for name, plugin in ctx.plugins.items():
        try:
            src = Path(inspect.getfile(type(plugin))).resolve()
        except TypeError:
            continue
        if src == target:
            hits.append(name)
            continue
        # kernel modules referenced by the plugin's module
        mod = importlib.import_module(type(plugin).__module__)
        for dep in getattr(mod, "__dict__", {}).values():
            mod_name = getattr(dep, "__module__", None) or getattr(dep, "__name__", "")
            if not str(mod_name).startswith("waveformanalysis_tpu"):
                continue
            try:
                dep_mod = sys.modules.get(str(mod_name))
                if dep_mod and Path(dep_mod.__file__).resolve() == target:
                    hits.append(name)
                    break
            except (AttributeError, TypeError):
                continue
    return sorted(set(hits))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("plugins", nargs="*", help="changed plugin data names")
    ap.add_argument("--file", action="append", default=[],
                    help="changed source file (mapped to plugins)")
    ap.add_argument("--storage-dir", help="inspect on-disk caches here")
    ap.add_argument("--run-id", help="run to check cache entries for")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import tempfile

    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.context.resolution import collect_downstream
    from waveformanalysis_tpu.plugins.plugin_sets import get_profile

    ctx = Context(storage_dir=args.storage_dir or tempfile.mkdtemp(),
                  config={"show_progress": False})
    ctx.register(*get_profile("default"))

    changed = list(args.plugins)
    for f in args.file:
        mapped = plugins_for_file(ctx, f)
        if not mapped:
            print(f"warning: {f} maps to no registered plugin", file=sys.stderr)
        changed.extend(mapped)
    changed = sorted(set(changed))
    unknown = [c for c in changed if c not in ctx.plugins]
    if unknown:
        print(f"error: unknown plugin(s): {unknown}", file=sys.stderr)
        return 2
    if not changed:
        ap.print_help()
        return 2

    impacted = set(changed)
    for name in changed:
        impacted |= set(collect_downstream(name, ctx.plugins, context=ctx))

    report = {
        "changed": changed,
        "impacted": sorted(impacted),
        "unaffected": sorted(set(ctx.plugins) - impacted),
    }

    if args.storage_dir and args.run_id:
        stale = []
        for name in sorted(impacted):
            try:
                key = ctx.key_for(args.run_id, name)
            except Exception:
                continue
            if ctx.storage.exists(args.run_id, key):
                stale.append({"data_name": name, "key": key})
        report["stale_cache_entries"] = stale

    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        print(f"changed:    {', '.join(report['changed'])}")
        print(f"impacted:   {', '.join(report['impacted'])}")
        print(f"unaffected: {', '.join(report['unaffected'])}")
        for e in report.get("stale_cache_entries", []):
            print(f"stale cache: {e['data_name']} ({e['key']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
