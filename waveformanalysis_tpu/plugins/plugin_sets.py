"""Named plugin sets and registration profiles.

Behavioral analog of the reference plugin sets / profiles
(reference: waveform_analysis/core/plugins/plugin_sets/__init__.py and
profiles.py:20-66): named groups of builtin plugins composable into a
profile. The reference's ``jax`` profile raised NotImplementedError — here
the device-kernel set IS the default.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


def plugins_io() -> List[Any]:
    from waveformanalysis_tpu.plugins.builtin.waveforms import RawFileNamesPlugin

    return [RawFileNamesPlugin()]


def plugins_waveform() -> List[Any]:
    from waveformanalysis_tpu.plugins.builtin.filtering import FilteredWaveformsPlugin
    from waveformanalysis_tpu.plugins.builtin.waveforms import WaveformsPlugin

    return [WaveformsPlugin(), FilteredWaveformsPlugin()]


def plugins_records() -> List[Any]:
    from waveformanalysis_tpu.plugins.builtin.records import (
        RecordsPlugin,
        WavePoolFilteredPlugin,
        WavePoolPlugin,
    )

    return [RecordsPlugin(), WavePoolPlugin(), WavePoolFilteredPlugin()]


def plugins_peaks() -> List[Any]:
    from waveformanalysis_tpu.plugins.builtin.hit_finder import ThresholdHitPlugin
    from waveformanalysis_tpu.plugins.builtin.hit_merge import (
        HitMergeClustersPlugin,
        HitMergedComponentsPlugin,
        HitMergePlugin,
    )
    from waveformanalysis_tpu.plugins.builtin.peak_finding import HitFinderPlugin

    return [
        HitFinderPlugin(),
        ThresholdHitPlugin(),
        HitMergePlugin(),
        HitMergeClustersPlugin(),
        HitMergedComponentsPlugin(),
    ]


def plugins_basic_features() -> List[Any]:
    from waveformanalysis_tpu.plugins.builtin.basic_features import BasicFeaturesPlugin
    from waveformanalysis_tpu.plugins.builtin.waveform_width import WaveformWidthPlugin
    from waveformanalysis_tpu.plugins.builtin.waveform_width_integral import (
        WaveformWidthIntegralPlugin,
    )

    return [BasicFeaturesPlugin(), WaveformWidthPlugin(), WaveformWidthIntegralPlugin()]


def plugins_classification() -> List[Any]:
    from waveformanalysis_tpu.plugins.builtin.s1_s2_classifier import S1S2ClassifierPlugin

    return [S1S2ClassifierPlugin()]


def plugins_tabular() -> List[Any]:
    from waveformanalysis_tpu.plugins.builtin.dataframe import DataFramePlugin

    return [DataFramePlugin()]


def plugins_events() -> List[Any]:
    from waveformanalysis_tpu.plugins.builtin.event_analysis import (
        EventHitsPlugin,
        EventsPlugin,
        GroupedEventsPlugin,
        HitGroupedPlugin,
        PairedEventsPlugin,
    )

    return [GroupedEventsPlugin(), EventsPlugin(), EventHitsPlugin(),
            HitGroupedPlugin(), PairedEventsPlugin()]


PLUGIN_SETS: Dict[str, Callable[[], List[Any]]] = {
    "io": plugins_io,
    "waveform": plugins_waveform,
    "records": plugins_records,
    "peaks": plugins_peaks,
    "basic_features": plugins_basic_features,
    "classification": plugins_classification,
    "tabular": plugins_tabular,
    "events": plugins_events,
}


def get_plugin_set(name: str) -> List[Any]:
    if name not in PLUGIN_SETS:
        raise KeyError(f"Unknown plugin set {name!r}; available: {sorted(PLUGIN_SETS)}")
    return PLUGIN_SETS[name]()


def default_plugins() -> List[Any]:
    """The full device pipeline (reference analog: profiles.cpu_default)."""
    out: List[Any] = []
    for name in ("io", "waveform", "records", "peaks", "basic_features",
                 "classification", "tabular", "events"):
        out.extend(PLUGIN_SETS[name]())
    return out


# reference-compat aliases
def cpu_default() -> List[Any]:
    """Alias for the default profile (kernels run on whatever jax backend is
    active; 'cpu' retained for reference API parity)."""
    return default_plugins()


def streaming_default() -> List[Any]:
    """Full pipeline + the chunked streaming plugin family.

    The reference declares this profile but raises NotImplementedError
    (reference: core/plugins/profiles.py:33-35); here it is real: the
    static pipeline plus `signal_peaks_stream`, with the generic device
    chunk executor available via `StreamingContext.get_stream(...,
    executor_type="device")` for every derivable static name."""
    from waveformanalysis_tpu.plugins.builtin.signal_peaks import (
        SignalPeaksStreamPlugin,
    )

    return default_plugins() + [SignalPeaksStreamPlugin()]


def jax_accel() -> List[Any]:
    """The reference's never-implemented 'jax' profile
    (reference: profiles.py:39-41 raises NotImplementedError) — in this
    build EVERY profile is the jax-accelerated pipeline."""
    return default_plugins()


PROFILES: Dict[str, Callable[[], List[Any]]] = {
    "cpu": cpu_default,
    "cpu_default": cpu_default,
    "default": default_plugins,
    "streaming": streaming_default,
    "streaming_default": streaming_default,
    "jax": jax_accel,
    "jax_accel": jax_accel,
}


def get_profile(name: str) -> List[Any]:
    if name not in PROFILES:
        raise KeyError(f"Unknown profile {name!r}; available: {sorted(PROFILES)}")
    return PROFILES[name]()
