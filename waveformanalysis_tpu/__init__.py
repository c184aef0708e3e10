"""waveformanalysis_tpu — JAX DAQ waveform-processing framework for the GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
SnowingWolf/WaveformAnalysis: a strax-style plugin DAG (raw DAQ files ->
records + wave_pool -> filtering -> hits/peaks -> features -> S1/S2 ->
grouped events) orchestrated by a Context with content-addressed lineage
caching — with every per-waveform kernel running as jitted JAX/Pallas code
over batched arrays, and chunked streaming realized as a sharded scan over a
device mesh.

Public API mirrors the reference façade
(reference: waveform_analysis/__init__.py:25-99) via lazy imports.
"""

from __future__ import annotations

import importlib
from typing import Any

# Re-exported so tests/tools can monkeypatch the metadata source
# (reference: waveform_analysis/__init__.py version resolution).
from importlib.metadata import PackageNotFoundError, version as package_version

# Must track pyproject.toml's version (pinned by test_misc_parity):
# when driven from source the metadata lookup misses and this is the
# single source of truth.
_FALLBACK_VERSION = "0.1.0"


def _resolve_package_version() -> str:
    """Installed-distribution version, falling back when the package is
    driven from source (not pip-installed)."""
    try:
        return package_version("waveformanalysis-tpu")
    except PackageNotFoundError:
        return _FALLBACK_VERSION


__version__ = _resolve_package_version()

# name -> (module, attribute)
_LAZY_API = {
    # dtypes / data model
    "Table": ("waveformanalysis_tpu.dtypes.table", "Table"),
    "Schema": ("waveformanalysis_tpu.dtypes.schema", "Schema"),
    "ST_WAVEFORM_DTYPE": ("waveformanalysis_tpu.dtypes.schema", "ST_WAVEFORM_DTYPE"),
    "RECORDS_DTYPE": ("waveformanalysis_tpu.dtypes.schema", "RECORDS_DTYPE"),
    "create_record_dtype": ("waveformanalysis_tpu.dtypes.schema", "create_record_dtype"),
    "Chunk": ("waveformanalysis_tpu.dtypes.chunk", "Chunk"),
    # plugin system
    "Plugin": ("waveformanalysis_tpu.plugins.base", "Plugin"),
    "Option": ("waveformanalysis_tpu.plugins.base", "Option"),
    "option": ("waveformanalysis_tpu.plugins.base", "option"),
    "takes_config": ("waveformanalysis_tpu.plugins.base", "takes_config"),
    "PluginSpec": ("waveformanalysis_tpu.plugins.spec", "PluginSpec"),
    "StreamingPlugin": ("waveformanalysis_tpu.plugins.streaming", "StreamingPlugin"),
    "StreamingContext": ("waveformanalysis_tpu.plugins.streaming", "StreamingContext"),
    "get_streaming_context": ("waveformanalysis_tpu.plugins.streaming", "get_streaming_context"),
    # context / storage
    "Context": ("waveformanalysis_tpu.context.context", "Context"),
    "MemmapStorage": ("waveformanalysis_tpu.storage.memmap", "MemmapStorage"),
    # execution
    "parallel_map": ("waveformanalysis_tpu.execution.manager", "parallel_map"),
    "parallel_apply": ("waveformanalysis_tpu.execution.manager", "parallel_apply"),
    "ExecutorManager": ("waveformanalysis_tpu.execution.manager", "ExecutorManager"),
    "CancellationToken": ("waveformanalysis_tpu.execution.cancellation", "CancellationToken"),
    "DataExporter": ("waveformanalysis_tpu.data.export", "DataExporter"),
    "DependencyAnalyzer": ("waveformanalysis_tpu.data.dependency_analysis", "DependencyAnalyzer"),
    "RecordsView": ("waveformanalysis_tpu.data.records_view", "RecordsView"),
    "TimeRangeQueryEngine": ("waveformanalysis_tpu.data.query", "TimeRangeQueryEngine"),
    "SQLiteBackend": ("waveformanalysis_tpu.storage.backends", "SQLiteBackend"),
    "wrap_strax_plugin": ("waveformanalysis_tpu.plugins.adapters", "wrap_strax_plugin"),
    "StraxContextAdapter": ("waveformanalysis_tpu.plugins.adapters", "StraxContextAdapter"),
    "PluginLoader": ("waveformanalysis_tpu.plugins.loader", "PluginLoader"),
    "enable_hot_reload": ("waveformanalysis_tpu.plugins.hot_reload", "enable_hot_reload"),
    "PluginHotReloader": ("waveformanalysis_tpu.plugins.hot_reload", "PluginHotReloader"),
    # reference facade parity (waveform_analysis/__init__.py lazy names)
    "CacheManager": ("waveformanalysis_tpu.storage.function_cache", "CacheManager"),
    "CompressionManager": ("waveformanalysis_tpu.storage.compression", "CompressionManager"),
    "IntegrityChecker": ("waveformanalysis_tpu.storage.integrity", "IntegrityChecker"),
    "StorageBackend": ("waveformanalysis_tpu.storage.backends", "StorageBackend"),
    "ErrorContext": ("waveformanalysis_tpu.foundation.exceptions", "ErrorContext"),
    "EXECUTOR_CONFIGS": ("waveformanalysis_tpu.execution.manager", "EXECUTOR_CONFIGS"),
    "get_executor": ("waveformanalysis_tpu.execution.manager", "get_executor"),
    "get_executor_manager": ("waveformanalysis_tpu.execution.manager", "get_executor_manager"),
    "get_config": ("waveformanalysis_tpu.execution.manager", "get_config"),
    "register_config": ("waveformanalysis_tpu.execution.manager", "register_config"),
    "get_timeout_manager": ("waveformanalysis_tpu.execution.timeout", "get_timeout_manager"),
    "group_multi_channel_hits": ("waveformanalysis_tpu.ops.grouping", "group_multi_channel_hits"),
    "WaveformStruct": ("waveformanalysis_tpu.plugins.builtin.waveforms", "WaveformStruct"),
    "WaveformStructConfig": ("waveformanalysis_tpu.plugins.builtin.waveforms", "WaveformStructConfig"),
    "make_fake_st_waveforms": ("waveformanalysis_tpu.testing.fixtures", "make_fake_st_waveforms"),
    "make_tiny_context": ("waveformanalysis_tpu.testing.fixtures", "make_tiny_context"),
    "default_plugins": ("waveformanalysis_tpu.plugins.plugin_sets", "default_plugins"),
    "get_profile": ("waveformanalysis_tpu.plugins.plugin_sets", "get_profile"),
    "BatchProcessor": ("waveformanalysis_tpu.data.batch_processor", "BatchProcessor"),
    "PipelineServer": ("waveformanalysis_tpu.server", "PipelineServer"),
    # flagship fused model
    "ChainConfig": ("waveformanalysis_tpu.models.full_chain", "ChainConfig"),
    "full_chain_step": ("waveformanalysis_tpu.models.full_chain", "full_chain_step"),
    "make_jit_chain": ("waveformanalysis_tpu.models.full_chain", "make_jit_chain"),
    "make_sharded_chain": ("waveformanalysis_tpu.models.full_chain", "make_sharded_chain"),
    # GPU streaming-scan kernels (Pallas through Triton)
    "find_peaks_scan": ("waveformanalysis_tpu.ops.scan_kernels", "find_peaks_scan"),
    "threshold_hits_scan": ("waveformanalysis_tpu.ops.scan_kernels", "threshold_hits_scan"),
    "sosfiltfilt_scan": ("waveformanalysis_tpu.ops.scan_kernels", "sosfiltfilt_scan"),
    # foundation
    "Profiler": ("waveformanalysis_tpu.foundation.profiler", "Profiler"),
    "OneTimeGenerator": ("waveformanalysis_tpu.foundation.utils",
                         "OneTimeGenerator"),
    "ProgressTracker": ("waveformanalysis_tpu.foundation.progress", "ProgressTracker"),
    "ErrorSeverity": ("waveformanalysis_tpu.foundation.exceptions", "ErrorSeverity"),
    "PluginError": ("waveformanalysis_tpu.foundation.exceptions", "PluginError"),
    "StandardUnits": ("waveformanalysis_tpu.foundation.units", "StandardUnits"),
    "convert_time": ("waveformanalysis_tpu.foundation.units", "convert_time"),
    # DAQ utilities
    "DAQRun": ("waveformanalysis_tpu.utils.daq", "DAQRun"),
    "DAQAnalyzer": ("waveformanalysis_tpu.utils.daq", "DAQAnalyzer"),
    "parse_and_stack_files": ("waveformanalysis_tpu.utils.io", "parse_and_stack_files"),
    "WaveformPreviewer": ("waveformanalysis_tpu.utils.preview", "WaveformPreviewer"),
    "preview_waveforms": ("waveformanalysis_tpu.utils.preview", "preview_waveforms"),
    "plot_records_waveforms": ("waveformanalysis_tpu.utils.preview", "plot_records_waveforms"),
    # visualization (reference: utils/visualization/ public surface)
    "plot_lineage_labview": ("waveformanalysis_tpu.utils.visualization", "plot_lineage_labview"),
    "plot_lineage_plotly": ("waveformanalysis_tpu.utils.visualization", "plot_lineage_plotly"),
    "LineageGraphModel": ("waveformanalysis_tpu.foundation.model", "LineageGraphModel"),
    "build_lineage_graph": ("waveformanalysis_tpu.foundation.model", "build_lineage_graph"),
    "plot_waveforms": ("waveformanalysis_tpu.utils.visualization", "plot_waveforms"),
    "create_interactive_browser": ("waveformanalysis_tpu.utils.visualization", "create_interactive_browser"),
    "LineageStyle": ("waveformanalysis_tpu.utils.visualization", "LineageStyle"),
    # adapters
    "register_adapter": ("waveformanalysis_tpu.formats.adapter", "register_adapter"),
    "get_adapter": ("waveformanalysis_tpu.formats.adapter", "get_adapter"),
    "list_adapters": ("waveformanalysis_tpu.formats.adapter", "list_adapters"),
}

__all__ = sorted(_LAZY_API) + ["__version__"]


def __getattr__(name: str) -> Any:
    try:
        module_name, attr = _LAZY_API[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    module = importlib.import_module(module_name)
    value = getattr(module, attr)
    globals()[name] = value
    return value


def __dir__():
    return __all__
