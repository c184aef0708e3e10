"""Malformed / truncated DAQ input handling (VERDICT r1 item 6).

Reference analog: the adapter robustness tests around
waveform_analysis/utils/formats/ — the decode layer must degrade cleanly on
truncated binaries, malformed CSV rows, BOM/blank lines, and empty files,
never crash, and the typed native fast path must agree with the generic
decoder on every such input.
"""

from pathlib import Path

import numpy as np
import pytest

from utils import (
    VX_HEADER,
    make_v1725_event,
    make_vx2730_csv_rows,
    write_vx2730_file,
)
from waveformanalysis_tpu.formats.adapter import get_adapter
from waveformanalysis_tpu.native import (
    decode_csv_bytes,
    decode_csv_vx2730_typed,
    decode_v1725_bytes,
)


class TestCSVCorruption:
    def _decode_both(self, data: bytes, skip_rows=0):
        gen = decode_csv_bytes(data, skip_rows=skip_rows)
        typ = decode_csv_vx2730_typed(data, skip_rows=skip_rows,
                                      samples_start=7,
                                      baseline_start=7, baseline_end=47)
        return gen, typ

    def _assert_typed_matches(self, gen, typ):
        """When the typed parser accepts a file, it must equal the generic."""
        if typ is None:
            return  # fell back; the generic result stands alone
        assert len(typ["timestamp"]) == len(gen)
        if len(gen):
            np.testing.assert_array_equal(
                typ["timestamp"], gen[:, 2].astype(np.int64))
            np.testing.assert_array_equal(
                typ["samples"], gen[:, 7:].astype(np.uint16))

    def test_short_rows_skipped(self):
        rows = make_vx2730_csv_rows(4, channel=0, n_samples=16)
        rows.insert(2, "0;1;12345;0;0")  # far too few fields
        data = ("\n".join(rows) + "\n").encode()
        gen, typ = self._decode_both(data)
        assert len(gen) == 4
        self._assert_typed_matches(gen, typ)

    def test_long_rows_skipped(self):
        rows = make_vx2730_csv_rows(4, channel=0, n_samples=16)
        rows.insert(1, rows[0] + ";999;999")  # extra fields
        data = ("\n".join(rows) + "\n").encode()
        gen, typ = self._decode_both(data)
        assert len(gen) == 4
        self._assert_typed_matches(gen, typ)

    def test_garbage_field_nan_and_typed_fallback(self):
        rows = make_vx2730_csv_rows(3, channel=0, n_samples=8)
        parts = rows[1].split(";")
        parts[8] = "notanumber"
        rows[1] = ";".join(parts)
        data = ("\n".join(rows) + "\n").encode()
        gen, typ = self._decode_both(data)
        assert len(gen) == 3
        assert np.isnan(gen[1, 8])
        assert typ is None  # strict typed parser must fall back

    def test_blank_lines_and_crlf(self):
        rows = make_vx2730_csv_rows(3, channel=0, n_samples=8)
        text = "\r\n\r\n" + "\r\n".join(rows) + "\r\n\r\n"
        gen, typ = self._decode_both(text.encode())
        assert len(gen) == 3
        self._assert_typed_matches(gen, typ)

    def test_empty_and_header_only_files(self):
        assert decode_csv_bytes(b"", 0).shape == (0, 0)
        gen = decode_csv_bytes(VX_HEADER.encode(), skip_rows=2)
        assert len(gen) == 0

    def test_truncated_final_row(self):
        rows = make_vx2730_csv_rows(3, channel=0, n_samples=8)
        full = "\n".join(rows) + "\n"
        cut = full[: len(full) - 20]  # rip the tail off the last row
        gen, typ = self._decode_both(cut.encode())
        assert len(gen) == 2  # final mangled row dropped
        self._assert_typed_matches(gen, typ)

    def test_reader_engine_fallback_on_corrupt_file(self, tmp_path):
        # a file the typed parser rejects still loads via the reader chain
        rows = make_vx2730_csv_rows(4, channel=0, n_samples=16)
        parts = rows[2].split(";")
        parts[9] = "3.75"  # float where the typed parser wants u16
        rows[2] = ";".join(parts)
        f = tmp_path / "Data_CH0_0.CSV"
        write_vx2730_file(f, rows, with_header=True)
        reader = get_adapter("vx2730").format_reader
        arr = reader.read_file(f, is_first_file=True)
        assert len(arr) == 4
        assert arr[2, 9] == 3.75


class TestV1725Corruption:
    def _event_bytes(self, n_samples=16, ts=1000):
        wave = np.full(n_samples, 900, dtype=np.int16)
        return make_v1725_event({0: wave}, timestamps={0: ts},
                                baselines={0: 900})

    def test_truncated_channel_header(self):
        blob = self._event_bytes() + self._event_bytes(ts=2000)
        cut = blob[: len(blob) - (16 + 10)]  # second event header + partial
        out = decode_v1725_bytes(cut)
        assert len(out["timestamp"]) == 1  # stops at the malformed tail
        assert out["timestamp"][0] == 1000

    def test_truncated_samples(self):
        blob = self._event_bytes() + self._event_bytes(ts=2000)
        cut = blob[: len(blob) - 8]  # rip samples off the second event
        out = decode_v1725_bytes(cut)
        assert len(out["timestamp"]) == 1

    def test_empty_buffer(self):
        out = decode_v1725_bytes(b"")
        assert len(out["timestamp"]) == 0
        assert len(out["wave_pool"]) == 0

    def test_garbage_header(self):
        out = decode_v1725_bytes(b"\xff" * 64)
        # a garbage size field must not crash or overrun; whatever parses
        # must be internally consistent
        assert len(out["wave_offset"]) == len(out["event_length"])
        total = int(np.sum(out["event_length"]))
        assert total == len(out["wave_pool"])

    def test_python_reader_parity_on_truncation(self, tmp_path):
        # native and Python fallback walkers must agree on truncated files
        reader = get_adapter("v1725").format_reader
        blob = self._event_bytes() + self._event_bytes(ts=2000)
        for cut_at in (len(blob), len(blob) - 5, len(blob) - 20, 10, 0):
            f = tmp_path / f"test_raw_b0_cut{cut_at}.bin"
            f.write_bytes(blob[:cut_at])
            native = decode_v1725_bytes(blob[:cut_at])
            py = reader.read_events(f, use_native=False) \
                if hasattr(reader, "read_events") else None
            if py is None:
                continue
            assert len(native["timestamp"]) == len(py["timestamp"]), cut_at
            np.testing.assert_array_equal(
                native["timestamp"], np.asarray(py["timestamp"]))


class TestContextLevelCorruption:
    def test_run_with_one_corrupt_file_still_processes(self, tmp_path):
        from waveformanalysis_tpu.context.context import Context
        from waveformanalysis_tpu.plugins.plugin_sets import default_plugins

        daq = tmp_path / "daq"
        raw = daq / "run_x" / "RAW"
        rows0 = make_vx2730_csv_rows(8, channel=0, n_samples=32)
        write_vx2730_file(raw / "Data_CH0_0.CSV", rows0, with_header=True)
        rows1 = make_vx2730_csv_rows(8, channel=1, n_samples=32)
        rows1.insert(4, "garbage;;;row")
        write_vx2730_file(raw / "Data_CH1_0.CSV", rows1, with_header=True)

        ctx = Context(
            storage_dir=str(tmp_path / "st"),
            config={"show_progress": False, "data_root": str(daq),
                    "daq_adapter": "vx2730"},
        )
        ctx.register(*default_plugins())
        rec = ctx.get_data("run_x", "records")
        assert len(rec) == 16  # malformed row skipped, the rest parsed
