#!/usr/bin/env python
"""Verify the signal-processing lineage wiring end to end.

Walks the checks the reference's verification script performs
(examples/verify_signal_processing_lineage.py): plugin registration, the
dependency chain under the resolved wave source, per-plugin resolved
configs, lineage hashing (tracked options in, untracked out, key changes
on config changes), and the lineage plot hook.
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

from waveformanalysis_tpu.context.context import Context
from waveformanalysis_tpu.plugins.plugin_sets import default_plugins
from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms


def verify_registration(ctx) -> None:
    print("=" * 70)
    print("1. plugin registration")
    print("=" * 70)
    names = sorted(ctx.plugins)
    print(f"{len(names)} plugins: {', '.join(names)}")
    assert "hit" in names and "s1_s2" in names


def verify_dependency_chain(ctx, run_id) -> None:
    print("\n" + "=" * 70)
    print("2. dependency chain (resolved wave source)")
    print("=" * 70)

    def show(name, level=1):
        plugin = ctx.get_plugin(name)
        if plugin is None:
            print("  " * level + f"{name} (source data)")
            return
        deps = ctx.resolve_depends_on(plugin, run_id) \
            if hasattr(ctx, "resolve_depends_on") else plugin.depends_on
        print("  " * level + f"{name} <- {deps}")
        for d in deps:
            show(d, level + 1)

    show("s1_s2")


def verify_configs(ctx) -> None:
    print("\n" + "=" * 70)
    print("3. resolved configs (tracked vs untracked)")
    print("=" * 70)
    plugin = ctx.get_plugin("hit")
    tracked = [k for k, o in plugin.options.items() if o.track]
    untracked = [k for k, o in plugin.options.items() if not o.track]
    resolved = ctx.get_resolved_config("hit")
    print(f"hit: {len(tracked)} tracked, {len(untracked)} untracked "
          f"(untracked: {untracked})")
    print(f"resolved {len(resolved.values)} values "
          f"(e.g. height from {resolved.values['height'].source.value})")
    assert "height" in tracked


def verify_lineage_tracking(ctx, run_id) -> None:
    print("\n" + "=" * 70)
    print("4. lineage hashing")
    print("=" * 70)
    lineage = ctx.get_lineage("hit")
    print(f"lineage nodes: {sorted(lineage)}")
    key0 = ctx.key_for(run_id, "hit")
    ctx.set_config({"hit": {"height": 222.0}})  # tracked -> key changes
    key1 = ctx.key_for(run_id, "hit")
    ctx.set_config({"hit": {"overflow_policy": "warn"}})
    ctx.set_config({"hit": {"n_workers": 4}})  # untracked -> key stable
    key2 = ctx.key_for(run_id, "hit")
    print(f"key(default)={key0} key(height=222)={key1} key(+untracked)={key2}")
    assert key0 != key1, "tracked option must change the lineage key"
    assert key1 == key2, "untracked option must NOT change the lineage key"


def visualize_lineage(ctx) -> None:
    print("\n" + "=" * 70)
    print("5. lineage plot hook")
    print("=" * 70)
    if not hasattr(ctx, "plot_lineage"):
        print("! Context has no plot_lineage")
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        fig = ctx.plot_lineage("hit")
        print(f"plot_lineage('hit') -> {type(fig).__name__}")
    except Exception as exc:  # matplotlib optional in minimal installs
        print(f"plot skipped: {exc}")


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(storage_dir=tmp, config={"show_progress": False})
        ctx.register(*default_plugins())
        run_id = "run_001"
        ctx.inject_data(run_id, "st_waveforms", make_fake_st_waveforms(
            n_events=32, wave_length=64, n_channels=2, pulse_start=20,
            pulse_width=6, pulse_height=250, noise_rms=2.0, seed=4,
        ))
        verify_registration(ctx)
        verify_dependency_chain(ctx, run_id)
        verify_configs(ctx)
        verify_lineage_tracking(ctx, run_id)
        visualize_lineage(ctx)
        print("\nall lineage checks passed")


if __name__ == "__main__":
    main()
