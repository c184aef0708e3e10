"""df_events / hit_grouped / df_paired plugins.

Behavioral analog of the reference event-analysis plugins
(reference: waveform_analysis/core/plugins/builtin/cpu/event_analysis.py:
23,69,109): time-window clustering of the df table into multi-channel
events, absolute-window coincidence grouping of merged hits, and cross
channel pairing.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from waveformanalysis_tpu.dtypes.schema import Field, Schema
from waveformanalysis_tpu.dtypes.table import Table
from waveformanalysis_tpu.foundation.constants import FeatureDefaults
from waveformanalysis_tpu.ops import grouping as G
from waveformanalysis_tpu.plugins.base import Option, Plugin
from waveformanalysis_tpu.processing.analyzer import EventAnalyzer


def _channel_slice(context: Any) -> int:
    """First channel index used to NAME df_paired's area_ch*/height_ch*
    columns (it never slices data). The reference reads the GLOBAL
    ``start_channel_slice`` config key with default 6 (reference
    event_analysis.py:60,139 -> analyzer.py:27); ``start_channel`` is
    kept as this build's alias (the CLI sets it). Untracked raw-config
    read on both sides."""
    cfg = context.config
    if "start_channel_slice" in cfg:
        return int(cfg["start_channel_slice"])
    return int(cfg.get("start_channel", 6))


class GroupedEventsPlugin(Plugin):
    """Cluster df rows into multi-channel events by time window."""

    provides = "df_events"
    depends_on = ["df"]
    description = "Group single-channel events into multi-channel events."
    version = "1.2.1"
    kernel_version = G.KERNEL_VERSION
    save_when = "always"
    output_dtype = "DataFrame"
    options = {
        "time_window_ns": Option(
            default=float(FeatureDefaults.TIME_WINDOW_NS), type=float,
            help="Clustering time window (ns)",
        ),
        "n_processes": Option(default=None, type=int, track=False,
                              help="Accepted for API parity (vectorized path)"),
        "grouping_backend": Option(
            default="auto", type=str, track=False,
            choices=("auto", "host", "device"),
            help="auto|host|device: device uses the jitted binary-lifting "
                 "clustering kernel (ops/grouping_device.py)",
        ),
    }

    def compute(self, context: Any, run_id: str, **kwargs: Any):
        df = context.get_data(run_id, "df")
        tw = float(context.get_config(self, "time_window_ns"))
        backend = context.get_config(self, "grouping_backend")
        analyzer = EventAnalyzer(
            n_channels=context.config.get("n_channels", 2),
            start_channel_slice=_channel_slice(context),
        )
        return analyzer.group_events(df, time_window_ns=tw, backend=backend)


EVENTS_SCHEMA = Schema(
    "events",
    (
        Field("event_id", "i8"),
        Field("t_min", "i8", unit="ps"),
        Field("t_max", "i8", unit="ps"),
        Field("dt_ns", "f8", unit="ns", doc="event span"),
        Field("n_hits", "i4"),
        Field("hit_offset", "i8", doc="row offset into event_hits"),
    ),
)
EVENTS_DTYPE = EVENTS_SCHEMA.numpy_dtype()

EVENT_HITS_SCHEMA = Schema(
    "event_hits",
    (
        Field("hit_event_id", "i8"),
        Field("hit_channel", "i2"),
        Field("hit_area", "f4"),
        Field("hit_height", "f4"),
        Field("hit_timestamp", "i8", unit="ps"),
    ),
)
EVENT_HITS_DTYPE = EVENT_HITS_SCHEMA.numpy_dtype()


def _grouping_options() -> Dict[str, Option]:
    return {
        "time_window_ns": Option(
            default=float(FeatureDefaults.TIME_WINDOW_NS), type=float,
            help="Clustering time window (ns)",
        ),
        "grouping_backend": Option(
            default="auto", type=str, track=False,
            choices=("auto", "host", "device"),
            help="auto|host|device clustering kernels",
        ),
    }


class EventsPlugin(Plugin):
    """Columnar per-event aggregates (events table + offsets).

    The device-friendly alternative to df_events' per-event object cells: the
    same clustering, but the outputs are flat device-consumable columns —
    pair with ``event_hits`` for the hit-level values. Values/order are
    bit-identical to the df_events cells (tests/test_event_layer.py).
    """

    provides = "events"
    depends_on = ["df"]
    description = "Columnar per-event aggregates with hit offsets."
    version = "1.0.0"
    kernel_version = G.KERNEL_VERSION
    save_when = "always"
    output_dtype = EVENTS_SCHEMA
    options = _grouping_options()

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        cols = G.group_events_columnar(
            context.get_data(run_id, "df"),
            float(context.get_config(self, "time_window_ns")),
            backend=context.get_config(self, "grouping_backend"),
        )
        return Table(
            {k: cols[k] for k in
             ("event_id", "t_min", "t_max", "dt_ns", "n_hits", "hit_offset")},
            schema=EVENTS_SCHEMA,
        )


class EventHitsPlugin(Plugin):
    """Flat hit-level rows in event-major, channel-sorted order."""

    provides = "event_hits"
    depends_on = ["df"]
    description = "Flat event-member hits aligned with the events table."
    # 1.1.0: hit_area/hit_height f8 -> f4 (the kernels' dtype; keeps the
    # columnar df_paired route dtype-identical to the classic path)
    version = "1.1.0"
    kernel_version = G.KERNEL_VERSION
    save_when = "always"
    output_dtype = EVENT_HITS_SCHEMA
    options = _grouping_options()

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        cols = G.group_events_columnar(
            context.get_data(run_id, "df"),
            float(context.get_config(self, "time_window_ns")),
            backend=context.get_config(self, "grouping_backend"),
        )
        return Table(
            {k: cols[k] for k in
             ("hit_event_id", "hit_channel", "hit_area", "hit_height",
              "hit_timestamp")},
            schema=EVENT_HITS_SCHEMA,
        )


class HitGroupedPlugin(Plugin):
    """Absolute-window coincidence grouping of merged hits."""

    provides = "hit_grouped"
    depends_on = ["hit_merged", "hit_merged_components", "hit_threshold"]
    description = "Group merged hits into coincidence events by absolute windows."
    version = "0.4.0"
    kernel_version = G.KERNEL_VERSION
    save_when = "always"
    output_dtype = "DataFrame"
    options = {
        "time_window_ns": Option(
            default=float(FeatureDefaults.TIME_WINDOW_NS), type=float,
            help="Coincidence window (ns) between hit windows",
        ),
        "dt": Option(
            default=None, type=int,
            help="Sample interval (ns) compat fallback, used only when the "
                 "hit_merged input lacks a dt field (reference "
                 "cpu/event_analysis.py:79)",
        ),
        "grouping_backend": Option(
            default="auto", type=str, track=False,
            choices=("auto", "host", "device"),
            help="auto|host|device: device uses the jitted chained-gap "
                 "cummax kernel (ops/grouping_device.py)",
        ),
    }

    def compute(self, context: Any, run_id: str, **kwargs: Any):
        merged = _as_columns(context.get_data(run_id, "hit_merged"))
        components = _as_columns(context.get_data(run_id, "hit_merged_components"))
        threshold_hits = _as_columns(context.get_data(run_id, "hit_threshold"))
        tw = float(context.get_config(self, "time_window_ns"))
        backend = context.get_config(self, "grouping_backend")
        # dt migration fallback, matching the reference's require_dt_array
        # (cpu/_dt_compat.py:51): rows carry dt when present; otherwise the
        # explicit config fills in, and its absence is an error.
        dt_values = None
        if "dt" not in merged:
            explicit_dt = context.get_config(self, "dt")
            n = len(next(iter(merged.values()))) if merged else 0
            if explicit_dt is None:
                if n:
                    raise ValueError(
                        "[hit_grouped] input 'hit_merged' is missing required "
                        "field 'dt'; provide explicit config 'dt'"
                    )
                dt_values = np.zeros(0, dtype=np.int32)
            else:
                explicit_dt = int(explicit_dt)
                if explicit_dt <= 0:
                    raise ValueError("[hit_grouped] dt must be > 0")
                dt_values = np.full(n, explicit_dt, dtype=np.int32)
        return G.group_hit_windows(
            merged, tw,
            dt_values=dt_values,
            component_rows=components,
            component_hits=threshold_hits,
            backend=backend,
        )


class PairedEventsPlugin(Plugin):
    """Cross-channel pairing of grouped events."""

    provides = "df_paired"
    depends_on = []  # dynamic (events_source)
    description = "Filter grouped events into cross-channel pairs."
    # 1.3.0: default paired-column prefix follows the reference's global
    # start_channel_slice key (default 6 -> area_ch6/7 out of the box)
    # 1.4.0: reference dtype rule on area_ch*/height_ch* (f4 when every
    # event has the channel, f8 NaN upcast otherwise — caught by the r5
    # CLI differential's CSV round-trip)
    version = "1.4.0"
    kernel_version = G.KERNEL_VERSION
    save_when = "always"
    output_dtype = "DataFrame"
    options = {
        "time_window_ns": Option(
            default=float(FeatureDefaults.TIME_WINDOW_NS), type=float,
            help="Maximum event span (ns) for pairing",
        ),
        "grouping_backend": Option(
            default="auto", type=str, track=False,
            choices=("auto", "host", "device"),
            help="auto|host|device: device runs the per-event gathers "
                 "(delta_t, area_ch*/height_ch*) as one jitted kernel "
                 "(ops/grouping_device.pair_events_device)",
        ),
        "events_source": Option(
            default="df_events", type=str,
            choices=("df_events", "columnar"),
            help="df_events keeps the reference's pandas contract "
                 "(object cells carried through); columnar pairs over the "
                 "flat events+event_hits tables and emits scalar columns "
                 "only — the device-friendly path",
        ),
    }

    def resolve_depends_on(self, context: Any, run_id=None):
        if context.get_config(self, "events_source") == "columnar":
            return ["events", "event_hits"]
        return ["df_events"]

    def compute(self, context: Any, run_id: str, **kwargs: Any):
        tw = float(context.get_config(self, "time_window_ns"))
        backend = context.get_config(self, "grouping_backend")
        n_channels = context.config.get("n_channels", 2)
        start = _channel_slice(context)
        if context.get_config(self, "events_source") == "columnar":
            return G.pair_events_columnar(
                context.get_data(run_id, "events"),
                context.get_data(run_id, "event_hits"),
                tw, n_channels=n_channels, start_channel=start,
                backend=backend,
            )
        df_events = context.get_data(run_id, "df_events")
        analyzer = EventAnalyzer(
            n_channels=n_channels,
            start_channel_slice=start,
        )
        return analyzer.pair_events(df_events, time_window_ns=tw,
                                    backend=backend)


def _as_columns(data: Any) -> Dict[str, np.ndarray]:
    if isinstance(data, Table):
        return {k: np.asarray(v) for k, v in data.columns.items()}
    if isinstance(data, np.ndarray) and data.dtype.names:
        return {name: np.asarray(data[name]) for name in data.dtype.names}
    raise ValueError(f"Expected Table or structured array, got {type(data)}")
