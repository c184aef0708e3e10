#!/usr/bin/env python
"""Schema compatibility checker: detect breaking output-schema changes.

Behavioral analog of the reference checker (reference:
scripts/schema_compat_check.py): snapshots every registered plugin's spec
(fields, dtypes, versions) to JSON and diffs a current tree against a stored
snapshot — removed/retyped fields without a version bump fail the check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def snapshot() -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import tempfile

    from waveformanalysis_tpu.context.context import Context
    from waveformanalysis_tpu.plugins.plugin_sets import get_profile

    ctx = Context(storage_dir=tempfile.mkdtemp(), config={"show_progress": False})
    ctx.register(*get_profile("default"))
    out = {}
    for name, plugin in sorted(ctx.plugins.items()):
        spec = plugin._validated_spec
        out[name] = {
            "version": spec.version,
            "spec_hash": spec.spec_hash(),
            "fields": {
                f.name: f.dtype for f in (
                    spec.output_schema.fields if spec.output_schema else []
                )
            },
        }
    return out


def compare(old: dict, new: dict) -> list:
    problems = []
    for name, old_spec in old.items():
        new_spec = new.get(name)
        if new_spec is None:
            problems.append(f"plugin '{name}' was removed")
            continue
        version_bumped = new_spec["version"] != old_spec["version"]
        for field, dtype in old_spec["fields"].items():
            if field not in new_spec["fields"]:
                if not version_bumped:
                    problems.append(
                        f"{name}: field '{field}' removed without a version bump"
                    )
            elif new_spec["fields"][field] != dtype and not version_bumped:
                problems.append(
                    f"{name}: field '{field}' dtype changed "
                    f"{dtype} -> {new_spec['fields'][field]} without a version bump"
                )
        if new_spec["spec_hash"] != old_spec["spec_hash"] and not version_bumped:
            problems.append(
                f"{name}: spec changed (hash {old_spec['spec_hash']} -> "
                f"{new_spec['spec_hash']}) without a version bump"
            )
    return problems


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--snapshot", default="docs/schema_snapshot.json")
    p.add_argument("--update", action="store_true",
                   help="Write the current schemas as the new snapshot")
    args = p.parse_args()

    current = snapshot()
    snap_path = Path(args.snapshot)

    if args.update or not snap_path.exists():
        snap_path.parent.mkdir(parents=True, exist_ok=True)
        with open(snap_path, "w") as fh:
            json.dump(current, fh, indent=2, sort_keys=True)
        print(f"snapshot written to {snap_path} ({len(current)} plugins)")
        return 0

    with open(snap_path) as fh:
        stored = json.load(fh)
    problems = compare(stored, current)
    if problems:
        print("SCHEMA COMPATIBILITY PROBLEMS:")
        for line in problems:
            print(" ", line)
        return 1
    print(f"schemas compatible ({len(current)} plugins)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
