"""Native (C++) helpers for host-side hot paths.

The device compute path is JAX/Pallas; the host runtime around it (DAQ decode,
IO) uses small C++ components where Python-side conversion dominated
profiles. Components are built on demand with the system g++ into the
package directory and loaded via ctypes (no pybind11 in this toolchain);
every caller must degrade gracefully when the toolchain is unavailable.

Currently: ``csv_decode`` — one-pass delimited-numeric decoder used by the
VX2730 reader (see csv_decode.cpp for the rationale and the C ABI).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_DIR = Path(__file__).parent
_SRC = _DIR / "csv_decode.cpp"
_LIB = _DIR / "libwfa_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> bool:
    """Compile the shared library if missing or stale. Returns success."""
    try:
        if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
            return True
        # per-process temp name: concurrent builders must not share a tmp
        # file (interleaved g++ output would install a corrupt .so); the
        # final rename is atomic, so whichever finishes last wins cleanly
        tmp = _LIB.with_suffix(f".so.tmp.{os.getpid()}")
        # -march=native: the SWAR digit kernels and memchr scans benefit
        # from BMI2/AVX codegen; fall back to plain -O3 if the compiler
        # rejects the flag (exotic/virtualized hosts)
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               str(_SRC), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            cmd = ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
        if proc.returncode != 0:
            logger.warning("native build failed: %s", proc.stderr[-500:])
            return False
        tmp.replace(_LIB)
        return True
    except Exception as err:  # toolchain missing, read-only dir, ...
        logger.warning("native build unavailable: %s", err)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if the
    toolchain or build is unavailable (callers fall back to Python paths)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not _build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_LIB))
            lib.wfa_csv_shape.restype = ctypes.c_longlong
            lib.wfa_csv_shape.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_char, ctypes.POINTER(ctypes.c_longlong),
            ]
            lib.wfa_csv_decode.restype = ctypes.c_longlong
            lib.wfa_csv_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_char, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.wfa_csv_decode_typed.restype = ctypes.c_longlong
            lib.wfa_csv_decode_typed.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_char, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_uint16),
            ]
            lib.wfa_v1725_scan.restype = ctypes.c_longlong
            lib.wfa_v1725_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_longlong),
            ]
            lib.wfa_v1725_decode.restype = ctypes.c_longlong
            lib.wfa_v1725_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint16),
            ]
            lib.wfa_v1725_headers.restype = ctypes.c_longlong
            lib.wfa_v1725_headers.argtypes = [
                ctypes.c_char_p, ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        except Exception as err:
            logger.warning("native load failed: %s", err)
            _load_failed = True
    return _lib


def decode_csv_bytes(data: bytes, skip_rows: int = 0,
                     delimiter: str = ";") -> Optional[np.ndarray]:
    """Decode delimited numeric text to a row-major float64 matrix.

    Rows whose field count differs from the first data row are skipped; a
    trailing delimiter does not open a field. Returns None when the native
    library is unavailable (caller falls back) or the file has no data.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    if n == 0:
        return np.zeros((0, 0), dtype=np.float64)
    ncols = ctypes.c_longlong(0)
    delim = delimiter.encode()[:1]
    rows = lib.wfa_csv_shape(data, n, skip_rows, delim,
                             ctypes.byref(ncols))
    if rows <= 0 or ncols.value <= 0:
        return np.zeros((0, 0), dtype=np.float64)
    out = np.empty((rows, ncols.value), dtype=np.float64)
    got = lib.wfa_csv_decode(
        data, n, skip_rows, delim, ncols.value, rows,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out[:got]


def decode_csv_vx2730_typed(
    data: bytes,
    skip_rows: int = 0,
    delimiter: str = ";",
    samples_start: int = 7,
    baseline_start: int = 7,
    baseline_end: int = 47,
) -> Optional[dict]:
    """Typed single-pass VX2730 decode (see wfa_csv_decode_typed).

    Returns {board i16, channel i16, timestamp i64, baseline f8,
    samples u16 (n, L)} or None when the native library is unavailable OR
    the file contains anomalies the strict typed parser rejects — the
    caller then falls back to :func:`decode_csv_bytes` + the generic part
    builder, preserving bit-parity on weird inputs.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    if n == 0:
        return {"board": np.zeros(0, np.int16), "channel": np.zeros(0, np.int16),
                "timestamp": np.zeros(0, np.int64),
                "baseline": np.zeros(0, np.float64),
                "samples": np.zeros((0, 0), np.uint16)}
    ncols = ctypes.c_longlong(0)
    delim = delimiter.encode()[:1]
    rows = lib.wfa_csv_shape(data, n, skip_rows, delim, ctypes.byref(ncols))
    if rows <= 0 or ncols.value <= samples_start:
        return None  # unusual shape: let the generic path handle it
    n_samples = ncols.value - samples_start
    board = np.empty(rows, dtype=np.int16)
    channel = np.empty(rows, dtype=np.int16)
    timestamp = np.empty(rows, dtype=np.int64)
    baseline = np.empty(rows, dtype=np.float64)
    samples = np.empty((rows, n_samples), dtype=np.uint16)
    got = lib.wfa_csv_decode_typed(
        data, n, skip_rows, delim, ncols.value, rows,
        samples_start, baseline_start, baseline_end,
        board.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        channel.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        timestamp.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        baseline.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    )
    if got < 0:
        return None  # anomaly: strict parser rejected, use the generic path
    return {
        "board": board[:got], "channel": channel[:got],
        "timestamp": timestamp[:got], "baseline": baseline[:got],
        "samples": samples[:got],
    }


def scan_v1725_headers_bytes(data: bytes) -> Optional[dict]:
    """Header-only V1725 walk: per-record metadata + sample BYTE offsets.

    No samples are copied — the device-unpack path uploads ``data`` once
    and gathers on the accelerator (ops/v1725_device.py). Same truncation
    semantics as the full decoder; None when the library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    total_samples = ctypes.c_longlong(0)
    records = lib.wfa_v1725_scan(data, n, ctypes.byref(total_samples))
    channel = np.empty(records, dtype=np.int16)
    timestamp = np.empty(records, dtype=np.int64)
    baseline = np.empty(records, dtype=np.float64)
    trunc = np.empty(records, dtype=np.uint8)
    offset = np.empty(records, dtype=np.int64)
    length = np.empty(records, dtype=np.int32)
    if records:
        got = lib.wfa_v1725_headers(
            data, n,
            channel.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            timestamp.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            baseline.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            trunc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offset.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            length.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        assert got == records, (got, records)
    return {
        "channel": channel, "timestamp": timestamp, "baseline": baseline,
        "trunc": trunc, "offset": offset, "n_samples": length,
    }


def decode_v1725_bytes(data: bytes) -> Optional[dict]:
    """Decode one V1725 DAW_DEMO binary buffer to columnar arrays.

    Returns {channel i16, timestamp i64, baseline f8, trunc u8,
    wave_offset i64, event_length i32, wave_pool u16} or None when the
    native library is unavailable. Bit-identical to the Python reader
    (formats/v1725.py), including stop-at-malformed-tail behavior.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    total_samples = ctypes.c_longlong(0)
    records = lib.wfa_v1725_scan(data, n, ctypes.byref(total_samples))
    channel = np.empty(records, dtype=np.int16)
    timestamp = np.empty(records, dtype=np.int64)
    baseline = np.empty(records, dtype=np.float64)
    trunc = np.empty(records, dtype=np.uint8)
    offset = np.empty(records, dtype=np.int64)
    length = np.empty(records, dtype=np.int32)
    pool = np.empty(total_samples.value, dtype=np.uint16)
    if records:
        got = lib.wfa_v1725_decode(
            data, n,
            channel.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            timestamp.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            baseline.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            trunc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offset.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            length.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            pool.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        )
        assert got == records, (got, records)
    return {
        "channel": channel, "timestamp": timestamp, "baseline": baseline,
        "trunc": trunc, "wave_offset": offset, "event_length": length,
        "wave_pool": pool,
    }
