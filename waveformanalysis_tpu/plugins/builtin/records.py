"""records / wave_pool plugins with a shared in-memory bundle.

Behavioral analog of the reference records plugins
(reference: waveform_analysis/core/plugins/builtin/cpu/records.py:27-334):
``records`` and ``wave_pool`` are two views of one RecordsBundle built from
the raw files; the bundle is cached in Context memory keyed by lineage so
requesting both data names builds it only once. Per-channel polarity metadata
is applied to the bundle before exposure.
"""

from __future__ import annotations

import hashlib
import json
import logging
from typing import Any

import numpy as np

from waveformanalysis_tpu.dtypes.schema import RECORDS_SCHEMA
from waveformanalysis_tpu.dtypes.table import Table
from waveformanalysis_tpu.plugins.base import Option, Plugin
from waveformanalysis_tpu.plugins.builtin.filtering import (
    FilteredWaveformsPlugin as _FilteredWaveformsPlugin,
)
from waveformanalysis_tpu.processing.records_builder import (
    RecordsBundle,
    apply_records_polarity,
    build_records_from_raw_files,
)

logger = logging.getLogger(__name__)

_FILTER_OPTIONS = _FilteredWaveformsPlugin.options

_BUNDLE_PREFIX = "_records_bundle-"


def _bundle_options() -> dict:
    return {
        "daq_adapter": Option(default="vx2730", type=str, help="DAQ adapter name"),
        "dt": Option(default=None, type=int, help="Sample interval (ns)"),
        "baseline_samples": Option(
            default=None,
            help="Baseline window: int (first N samples) or (start, end)",
        ),
        "records_part_size": Option(
            default=250_000, type=int, track=False,
            help="Events per build part (perf knob, untracked; reference "
                 "name — 'part_size' remains as a compat alias)",
        ),
        "channel_workers": Option(
            default=None, type=int, track=False,
            help="Channel-level parse workers (default serial; pyarrow is "
                 "internally parallel and not thread-entry safe here)",
        ),
        # Reference CPU-scheduling knobs (cpu/records.py:220-254), accepted
        # untracked for config portability. On this build the decode path is
        # the native AVX-512 single-pass parser + fused device kernels; these
        # pool/engine choices have no equivalent and no effect on outputs
        # (they are perf-only on the reference too). Ledgered in
        # docs/PARITY.md "Inert reference options".
        "n_jobs": Option(
            default=None, type=int, track=False,
            help="Reference file-level parse workers (inert here; the native "
                 "decoder is single-pass)",
        ),
        "parse_engine": Option(
            default="auto", type=str, track=False,
            help="Reference CSV engine choice (inert here; native AVX-512 "
                 "decode with generic fallback is automatic)",
        ),
        "chunksize": Option(
            default=None, type=int, track=False,
            help="Reference CSV read chunk size (inert here)",
        ),
        "use_process_pool": Option(
            default=False, type=bool, track=False,
            help="Reference process-pool toggle for file parsing (inert here)",
        ),
        "channel_executor": Option(
            default="thread", type=str, track=False,
            help="Reference channel-level executor type (inert here; "
                 "channel_workers controls the one real knob)",
        ),
    }


def get_records_bundle(context: Any, run_id: str, plugin: Plugin) -> RecordsBundle:
    """Build (or fetch the memoized) RecordsBundle for a run.

    The memo key folds in the records lineage so config changes rebuild.
    """
    lineage = context.get_lineage("records") or context.get_lineage("wave_pool")
    h = hashlib.sha1(
        json.dumps(lineage, sort_keys=True, default=str).encode()
    ).hexdigest()[:8]
    memo_key = (run_id, f"{_BUNDLE_PREFIX}{h}")
    cached = context._results.get(memo_key)
    if cached is not None:
        return cached

    raw_files = context.get_data(run_id, "raw_files")
    adapter_name = (context.get_config(plugin, "daq_adapter") or "vx2730").lower()
    dt_ns = context.get_config(plugin, "dt")
    if dt_ns is None:
        from waveformanalysis_tpu.formats.adapter import get_adapter

        rate = get_adapter(adapter_name).format_spec.sampling_rate_hz or 500e6
        dt_ns = max(1, int(round(1e9 / rate)))
    baseline_samples = context.get_config(plugin, "baseline_samples")
    part_size = context.get_config(plugin, "records_part_size")
    channel_workers = context.get_config(plugin, "channel_workers")

    epoch_ns = None
    if raw_files and raw_files[0]:
        from pathlib import Path

        from waveformanalysis_tpu.formats.adapter import get_adapter

        try:
            epoch_ns = get_adapter(adapter_name).get_file_epoch(Path(raw_files[0][0]))
        except (FileNotFoundError, OSError):
            epoch_ns = None

    bundle = build_records_from_raw_files(
        raw_files,
        adapter_name=adapter_name,
        default_dt_ns=int(dt_ns),
        part_size=part_size,
        baseline_samples=baseline_samples,
        epoch_ns=epoch_ns,
        channel_workers=channel_workers,
    )
    bundle = apply_records_polarity(bundle, context, run_id)
    context._results[memo_key] = bundle
    return bundle


class RecordsPlugin(Plugin):
    """Time-sorted flat records (metadata view of the bundle)."""

    provides = "records"
    # outputs depend on run_config channel_metadata (hardware overrides)
    uses_run_config = True
    depends_on = ["raw_files"]
    description = "Globally time-sorted records with wave_pool addressing."
    version = "2.1.0"
    save_when = "always"
    output_dtype = RECORDS_SCHEMA
    options = _bundle_options()

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        return get_records_bundle(context, run_id, self).records


class WavePoolPlugin(Plugin):
    """Contiguous uint16 sample pool addressed by records.wave_offset."""

    provides = "wave_pool"
    # outputs depend on run_config channel_metadata (hardware overrides)
    uses_run_config = True
    depends_on = ["raw_files"]
    description = "Contiguous uint16 waveform sample pool."
    version = "2.1.0"
    save_when = "always"
    options = _bundle_options()

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> np.ndarray:
        return get_records_bundle(context, run_id, self).wave_pool


class WavePoolFilteredPlugin(Plugin):
    """Filtered wave_pool: the records-source analog of filtered_waveforms.

    Mirrors the reference WavePoolFilteredPlugin (records.py:337-440):
    SAME option surface and defaults as filtered_waveforms (filter_type
    SG(11,2)/BW, GHz-convention cutoffs, per-(board,channel)
    ``channel_config`` overrides), output = float32 pool with identical
    offsets, RAW wave filtered (baseline retained). Feature plugins with
    ``wave_source=records`` + ``use_filtered=True`` read their waves from
    THIS pool — the config-sweep differential's ``wave_source_records``
    sweep pins the whole path against the reference. v2.0.0: previously a
    non-reference option surface (filter_type butterworth/savgol/none +
    filter_config dict) that default-applied Butterworth; now reference
    semantics."""

    provides = "wave_pool_filtered"
    # per-channel filter overrides come from run_config channel_metadata
    uses_run_config = True
    depends_on = ["records", "wave_pool"]
    description = "Wave pool with per-channel digital filters applied."
    version = "2.1.0"  # 2.1: filter_backend option
    save_when = "always"
    # identical filter surface to filtered_waveforms (incl. the engine and
    # filter_backend knobs)
    options = dict(_FILTER_OPTIONS)

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> np.ndarray:
        from waveformanalysis_tpu.hardware import (
            group_indices_by_hardware_channel,
        )
        from waveformanalysis_tpu.ops import filtering as FLT
        from waveformanalysis_tpu.plugins.builtin.filtering import (
            get_filter_base_values,
            resolve_filter_config,
        )

        records = context.get_data(run_id, "records")
        pool = np.asarray(context.get_data(run_id, "wave_pool"))
        n = len(records)
        filtered_pool = np.zeros(len(pool), dtype=np.float32)
        if n == 0 or len(pool) == 0:
            return filtered_pool

        engine = context.get_config(self, "engine")
        backend = context.get_config(self, "filter_backend")
        channel_config = context.get_config(self, "channel_config")
        base_values = get_filter_base_values(context, self)

        offsets = np.asarray(records["wave_offset"], dtype=np.int64)
        lengths = np.asarray(records["event_length"], dtype=np.int64)
        boards = (np.asarray(records["board"]) if "board" in records
                  else np.zeros(n, np.int16))
        channels = (np.asarray(records["channel"]) if "channel" in records
                    else np.zeros(n, np.int16))

        groups = group_indices_by_hardware_channel(boards, channels)
        for hw, idx in groups.items():
            cfg = resolve_filter_config(
                context, self, run_id=run_id, board=hw.board,
                channel=hw.channel, base_values=base_values,
                channel_config=channel_config,
            )
            # filtering must see each record at its TRUE length, so batch
            # per unique event_length within the channel group
            for L in np.unique(lengths[idx]):
                if L <= 0:
                    continue
                rows = idx[lengths[idx] == L]
                gather = offsets[rows][:, None] + np.arange(int(L))[None, :]
                waves = pool[gather].astype(np.float32)
                filtered = FLT.apply_filter(
                    waves, cfg["filter_type"], bw_sos=cfg["bw_sos"],
                    sg_window_size=cfg["sg_window_size"],
                    sg_poly_order=cfg["sg_poly_order"], engine=engine,
                    backend=backend,
                )
                filtered_pool[gather.reshape(-1)] = np.asarray(
                    filtered, dtype=np.float32
                ).reshape(-1)
        return filtered_pool
