"""Zero-copy access to variable-length waves in a wave_pool.

Behavioral analog of the reference RecordsView
(reference: waveform_analysis/core/data/records_view.py:16-382): per-record
wave access by record_id (``waves``), polarity-normalized signal access
(``signals`` = baseline-relative, positive-going), and window slicing.

Device-path extension: :meth:`padded_wave_matrix` materializes the whole pool
as a padded (n_records, L_bucket) int16 matrix in one vectorized gather — the
layout every batched device kernel consumes — with per-record true lengths.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np

from waveformanalysis_tpu.dtypes.table import Table
from waveformanalysis_tpu.foundation.constants import pad_to_multiple


class RecordsView:
    """Read-only view joining a records table with its wave_pool."""

    def __init__(self, records: Union[Table, np.ndarray], wave_pool: np.ndarray) -> None:
        if not isinstance(records, Table):
            records = Table.from_numpy(records)
        self.records = records
        self.wave_pool = np.asarray(wave_pool)
        self._offsets = np.asarray(records["wave_offset"], dtype=np.int64)
        self._lengths = np.asarray(records["event_length"], dtype=np.int64)
        self._baselines = (
            np.asarray(records["baseline"], dtype=np.float64)
            if "baseline" in records
            else np.zeros(len(records))
        )
        self._polarity = (
            np.asarray(records["polarity"], dtype=np.int8)
            if "polarity" in records
            else np.zeros(len(records), dtype=np.int8)
        )
        # record_id -> row index map (records are usually id == row)
        rid = np.asarray(records["record_id"], dtype=np.int64)
        if len(rid) and not np.array_equal(rid, np.arange(len(rid))):
            self._row_of = {int(r): i for i, r in enumerate(rid)}
        else:
            self._row_of = None

    def __len__(self) -> int:
        return len(self.records)

    def _row(self, record_id: int) -> int:
        if self._row_of is None:
            return int(record_id)
        return self._row_of[int(record_id)]

    # -- per-record access ----------------------------------------------------

    def waves(self, record_id: int, window: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Raw uint16 samples of one record (zero-copy pool slice)."""
        i = self._row(record_id)
        off, length = self._offsets[i], self._lengths[i]
        wave = self.wave_pool[off : off + length]
        if window is not None:
            s, e = window
            wave = wave[s:e]
        return wave

    def signals(
        self,
        record_id: int,
        baseline: Optional[float] = None,
        window: Optional[Tuple[int, int]] = None,
    ) -> np.ndarray:
        """Polarity-normalized signal: positive-going pulse in float64.

        negative polarity (or unknown): baseline - wave
        positive polarity:             wave - baseline
        """
        i = self._row(record_id)
        wave = self.waves(record_id, window=window).astype(np.float64)
        b = self._baselines[i] if baseline is None else float(baseline)
        if self._polarity[i] > 0:
            return wave - b
        return b - wave

    def baseline(self, record_id: int) -> float:
        return float(self._baselines[self._row(record_id)])

    # -- batched access (device path) ------------------------------------------

    def padded_wave_matrix(
        self,
        pad_to: Optional[int] = None,
        dtype: Any = np.int16,
        rows: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """All (or selected) waves as one padded matrix.

        Returns (waves[n, L], event_length[n]); padding samples are 0 and the
        length array marks each record's true extent. L pads up to a multiple
        of 128 (bounding the number of compiled shapes) unless ``pad_to``
        overrides it.
        """
        offsets = self._offsets if rows is None else self._offsets[rows]
        lengths = self._lengths if rows is None else self._lengths[rows]
        n = len(offsets)
        if n == 0:
            return np.zeros((0, pad_to or 0), dtype=dtype), np.zeros(0, np.int32)
        max_len = int(lengths.max()) if len(lengths) else 0
        L = pad_to if pad_to is not None else pad_to_multiple(max(max_len, 1), 128)
        if max_len > L:
            raise ValueError(f"pad_to={L} smaller than longest wave {max_len}")
        col = np.arange(L, dtype=np.int64)[None, :]
        idx = offsets[:, None] + col
        mask = col < lengths[:, None]
        idx = np.where(mask, idx, 0)
        out = self.wave_pool[idx].astype(dtype, copy=False)
        out = np.where(mask, out, 0).astype(dtype, copy=False)
        return out, lengths.astype(np.int32)

    def padded_wave_matrix_device(
        self,
        pad_to: Optional[int] = None,
        dtype: Any = None,
    ):
        """Device-side variant of :meth:`padded_wave_matrix`.

        Uploads the flat pool ONCE and builds the padded matrix with a
        device gather (jnp.take), so feeding kernels from records costs one
        host->device transfer of pool-size bytes instead of materializing
        the padded matrix (pool x pad-factor bytes) in host memory first.
        Returns (waves[n, L] int16 device array, event_length[n] int32
        device array).
        """
        import jax.numpy as jnp

        n = len(self._offsets)
        if n == 0:
            L = pad_to or 0
            return (jnp.zeros((0, L), jnp.int16), jnp.zeros((0,), jnp.int32))
        max_len = int(self._lengths.max())
        L = pad_to if pad_to is not None else pad_to_multiple(max(max_len, 1), 128)
        if max_len > L:
            raise ValueError(f"pad_to={L} smaller than longest wave {max_len}")
        if len(self.wave_pool) >= 2**31 - (L + 1):
            # device gather indices are int32 under default jax config
            # (x64 disabled); offsets past 2^31 samples would wrap — build
            # the padded matrix on the host (exact int64 indexing) instead
            waves, lens = self.padded_wave_matrix(pad_to=L, dtype=dtype or np.int16)
            return jnp.asarray(waves), jnp.asarray(lens)
        pool = jnp.asarray(self.wave_pool)  # single transfer
        offs = jnp.asarray(self._offsets.astype(np.int32))
        lens = jnp.asarray(self._lengths.astype(np.int32))
        col = jnp.arange(L, dtype=jnp.int32)[None, :]
        mask = col < lens[:, None]
        idx = jnp.where(mask, offs[:, None] + col, 0)
        out = jnp.where(mask, jnp.take(pool, idx), 0).astype(dtype or jnp.int16)
        return out, lens

    def signal_matrix(
        self, pad_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Polarity-normalized float32 signal matrix (positive-going)."""
        waves, lengths = self.padded_wave_matrix(pad_to=pad_to, dtype=np.float32)
        sign = np.where(self._polarity > 0, 1.0, -1.0).astype(np.float32)
        signal = sign[:, None] * (waves - self._baselines[:, None].astype(np.float32))
        col = np.arange(waves.shape[1])[None, :]
        signal = np.where(col < lengths[:, None], signal, 0.0)
        return signal.astype(np.float32), lengths
