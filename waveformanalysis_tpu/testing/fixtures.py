"""Public testing fixtures for downstream plugin authors.

Behavioral analog of the reference public fixture module
(reference: waveform_analysis/testing/fixtures.py:19-57):
``make_fake_st_waveforms`` builds synthetic structured waveforms with known
pulses; ``make_tiny_context`` returns a Context with those waveforms injected
so feature plugins can be unit-tested without DAQ decode.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from waveformanalysis_tpu.dtypes.schema import ST_WAVEFORM_SCHEMA, create_record_dtype
from waveformanalysis_tpu.dtypes.table import Table


def make_fake_st_waveforms(
    n_events: int = 16,
    wave_length: int = 128,
    n_channels: int = 2,
    baseline: float = 1000.0,
    pulse_height: int = 200,
    pulse_start: int = 50,
    pulse_width: int = 10,
    polarity: str = "negative",
    noise_rms: float = 0.0,
    dt_ns: int = 2,
    seed: int = 0,
    as_table: bool = False,
) -> Any:
    """Synthetic st_waveforms with a square pulse per event.

    Returns a NumPy structured array (reference layout) by default, or a
    Table when ``as_table=True``.
    """
    rng = np.random.default_rng(seed)
    dtype = create_record_dtype(wave_length)
    arr = np.zeros(n_events, dtype=dtype)
    arr["baseline"] = baseline
    arr["polarity"] = polarity
    arr["timestamp"] = np.arange(n_events, dtype=np.int64) * 10_000_000  # ps
    arr["record_id"] = np.arange(n_events)
    arr["dt"] = dt_ns
    arr["event_length"] = wave_length
    arr["board"] = 0
    arr["channel"] = np.arange(n_events) % n_channels

    waves = np.full((n_events, wave_length), baseline, dtype=np.float64)
    if noise_rms > 0:
        waves += rng.normal(0, noise_rms, size=waves.shape)
    sign = 1.0 if polarity == "positive" else -1.0
    waves[:, pulse_start : pulse_start + pulse_width] += sign * pulse_height
    arr["wave"] = np.clip(np.round(waves), -32768, 32767).astype(np.int16)

    if as_table:
        return Table.from_numpy(arr, schema=ST_WAVEFORM_SCHEMA)
    return arr


def format_csv_rows(values: np.ndarray, delimiter: str = ";") -> bytes:
    """Decimal text of a 2-D integer array: ``delimiter``-joined fields,
    one newline-terminated line per row — byte-identical to
    ``";".join(str(int(v)) for v in row) + "\\n"``, built with array ops."""
    v = np.asarray(values, dtype=np.int64)
    if v.size == 0:
        return b""
    neg = v < 0
    mag = np.abs(v)
    ndig = np.ones(v.shape, np.int64)
    for k in range(1, 19):
        ndig += mag >= 10 ** k
    width = ndig + neg + 1                     # digits, sign, separator
    ends = np.cumsum(width.ravel())            # one past each separator
    starts = ends - width.ravel()
    buf = np.empty(int(ends[-1]), np.uint8)
    buf[starts[neg.ravel()]] = ord("-")
    sep = np.full(v.shape, ord(delimiter), np.uint8)
    sep[:, -1] = ord("\n")
    buf[ends - 1] = sep.ravel()
    first = starts + neg.ravel()               # most significant digit
    flat_mag, flat_nd = mag.ravel(), ndig.ravel()
    for k in range(int(flat_nd.max())):        # k-th digit from the right
        has = flat_nd > k
        buf[(first + flat_nd - 1 - k)[has]] = (
            ord("0") + (flat_mag[has] // 10 ** k) % 10)
    return buf.tobytes()


def make_pulse_waves(
    n: int,
    wave_length: int,
    seed: int = 0,
    baseline: int = 8000,
    polarity: int = -1,
    noise: float = 3.0,
    chunk: int = 32768,
) -> np.ndarray:
    """(n, wave_length) int16 digitizer waves with realistic pulses.

    Every event holds one narrow (S1-like, sigma 1-3 samples) or wide
    (S2-like, sigma 12-25 samples) Gaussian pulse of 100-2000 ADC, a
    quarter also a second narrow pulse, on a baseline with Gaussian noise.
    Generated in row chunks so a full run needs no multi-GiB temporaries.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(wave_length, dtype=np.float32)
    out = np.empty((n, wave_length), np.int16)
    lo, hi = wave_length // 5, 3 * wave_length // 5
    for a in range(0, n, chunk):
        m = min(chunk, n - a)
        wide = rng.random(m) < 0.5
        sigma = np.where(wide, rng.uniform(12, 25, m), rng.uniform(1, 3, m))
        amp = rng.uniform(100, 2000, m)
        c1 = rng.uniform(lo, hi, m)
        c2 = c1 + rng.uniform(30, 60, m)
        amp2 = np.where(rng.random(m) < 0.25, rng.uniform(100, 800, m), 0.0)
        pulse = (amp[:, None] * np.exp(
            -((t - c1[:, None]) ** 2) / (2 * sigma[:, None] ** 2))
            + amp2[:, None] * np.exp(-((t - c2[:, None]) ** 2) / 8.0))
        w = baseline + polarity * pulse + rng.normal(0, noise, pulse.shape)
        out[a:a + m] = np.round(w).astype(np.int16)
    return out


def make_synthetic_vx2730_run(
    data_root: str,
    run_name: str = "run_001",
    n_channels: int = 2,
    n_files_per_channel: int = 1,
    n_rows: int = 32,
    n_samples: int = 48,
    baseline: int = 1000,
    pulse_height: int = 200,
    pulse_offset: int = 41,
    dt_between_ps: int = 10_000_000,
    noise: int = 3,
    seed: int = 0,
    pulses: Optional[Any] = None,
    channel_offset_ps: int = 0,
    waves: Optional[np.ndarray] = None,
) -> str:
    """Write a synthetic VX2730 CSV run tree and return the run directory.

    Layout matches the adapter's expectations
    (reference: utils/formats/vx2730.py:117-134): files under
    ``{data_root}/{run_name}/RAW/Data_CH{c}_{i}.CSV``, ``;``-separated rows
    ``board;channel;timetag;_;_;_;_;sample0;sample1;...`` with two header
    lines on each channel's first file only. Every waveform carries a
    negative square pulse of ``pulse_height`` ADC at ``pulse_offset`` —
    placed after the VX2730 baseline window (samples 0-40) by default so
    computed baselines stay clean.

    ``pulses`` overrides the single default pulse with an explicit list of
    ``(offset, height, width)`` square pulses per waveform — use it to
    build multi-pulse events that discriminate peak-finding options
    (distance/prominence/width) and hit-merging gaps.

    ``channel_offset_ps`` staggers channel ``ch``'s timestamps by
    ``ch * channel_offset_ps`` — cross-channel gaps then discriminate the
    event-layer time windows (df_events / hit_grouped / df_paired).

    ``waves`` (n_channels, n_rows, n_samples) writes the given integer
    samples instead (one file per channel). Rows are formatted in bulk by
    :func:`format_csv_rows`, so a run at full chunk scale writes in
    seconds.
    """
    import os

    rng = np.random.default_rng(seed)
    raw_dir = os.path.join(str(data_root), run_name, "RAW")
    os.makedirs(raw_dir, exist_ok=True)
    header = b"HEADER LINE 1\nHEADER LINE 2\n"
    for ch in range(n_channels):
        for fi in range(n_files_per_channel):
            if waves is not None:
                samples = np.asarray(waves[ch], dtype=np.int64)
            else:
                samples = np.full((n_rows, n_samples), baseline, np.int64)
                if noise:
                    # one draw per row: the same stream as a per-row loop
                    for i in range(n_rows):
                        samples[i] += rng.integers(-noise, noise + 1,
                                                   n_samples)
                if pulses is None:
                    samples[:, pulse_offset:pulse_offset + 5] -= pulse_height
                else:
                    for off, height, width in pulses:
                        samples[:, off:off + width] -= int(height)
            rows = len(samples)
            t0 = fi * rows * dt_between_ps
            ts = (t0 + np.arange(rows, dtype=np.int64) * dt_between_ps
                  + ch * channel_offset_ps)
            fields = np.zeros((rows, 7), np.int64)
            fields[:, 1] = ch
            fields[:, 2] = ts
            path = os.path.join(raw_dir, f"Data_CH{ch}_{fi}.CSV")
            with open(path, "wb") as fh:
                if fi == 0:
                    fh.write(header)
                fh.write(format_csv_rows(np.hstack([fields, samples])))
    return os.path.join(str(data_root), run_name)


def make_tiny_context(
    tmp_dir: str,
    st_waveforms: Optional[Any] = None,
    run_id: str = "test_run",
    config: Optional[dict] = None,
    **fake_kwargs: Any,
):
    """A Context over ``tmp_dir`` with st_waveforms injected for ``run_id``."""
    from waveformanalysis_tpu.context.context import Context

    cfg = {"show_progress": False}
    cfg.update(config or {})
    ctx = Context(storage_dir=str(tmp_dir), config=cfg)
    if st_waveforms is None:
        st_waveforms = make_fake_st_waveforms(**fake_kwargs)
    ctx.inject_data(run_id, "st_waveforms", st_waveforms)
    return ctx
