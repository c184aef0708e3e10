#!/usr/bin/env python
"""Scaffold a new plugin module with schema, options, kernel stub, and test.

Behavioral analog of the reference scaffolder (reference:
scripts/scaffold_plugin.py): generates an idiomatic device plugin
skeleton — Table output, jitted kernel stub, parity-test template.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

PLUGIN_TEMPLATE = '''"""{provides} plugin."""

from __future__ import annotations

from functools import partial
from typing import Any, Optional

import numpy as np

import jax
import jax.numpy as jnp

from waveformanalysis_tpu.dtypes.schema import Field, Schema
from waveformanalysis_tpu.dtypes.table import Table
from waveformanalysis_tpu.plugins.base import Option, Plugin

KERNEL_VERSION = "{provides}-v1"

{schema_const} = Schema(
    "{provides}",
    (
        Field("value", "f4", doc="TODO: describe"),
        Field("timestamp", "i8", unit="ps"),
        Field("channel", "i2"),
        Field("record_id", "i8"),
    ),
)


@jax.jit
def {provides}_kernel(waves: jax.Array) -> jax.Array:
    """TODO: the device kernel. Runs once per (shape, config)."""
    return jnp.zeros(waves.shape[0], jnp.float32)


class {class_name}(Plugin):
    """TODO: one-line description."""

    provides = "{provides}"
    depends_on = ["{depends_on}"]
    description = "TODO"
    version = "0.1.0"
    kernel_version = KERNEL_VERSION
    save_when = "always"
    output_dtype = {schema_const}
    options = {{
        "example_option": Option(default=1.0, type=float, help="TODO"),
    }}

    def compute(self, context: Any, run_id: str, **kwargs: Any) -> Table:
        data = context.get_data(run_id, "{depends_on}")
        if not isinstance(data, Table):
            data = Table.from_numpy(data)
        n = len(data)
        if n == 0:
            return Table.zeros(0, {schema_const})
        values = np.asarray({provides}_kernel(jnp.asarray(np.asarray(data["wave"]))))
        return Table(
            {{
                "value": values.astype(np.float32),
                "timestamp": np.asarray(data["timestamp"], np.int64),
                "channel": np.asarray(data["channel"], np.int16),
                "record_id": np.asarray(data["record_id"], np.int64),
            }},
            schema={schema_const},
        )
'''

TEST_TEMPLATE = '''"""Tests for the {provides} plugin."""

import numpy as np

from waveformanalysis_tpu.testing.fixtures import (
    make_fake_st_waveforms,
    make_tiny_context,
)

from {module_path} import {class_name}


def test_{provides}_runs(tmp_path):
    ctx = make_tiny_context(tmp_path,
                            st_waveforms=make_fake_st_waveforms(8, 64))
    ctx.register({class_name}())
    out = ctx.get_data("test_run", "{provides}")
    assert len(out) == 8
'''


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("provides", help="Data name the plugin provides")
    p.add_argument("--depends-on", default="st_waveforms")
    p.add_argument("--out-dir", default="waveformanalysis_tpu/plugins/builtin")
    p.add_argument("--test-dir", default="tests")
    args = p.parse_args()

    provides = args.provides
    class_name = "".join(w.capitalize() for w in provides.split("_")) + "Plugin"
    schema_const = provides.upper() + "_SCHEMA"

    out = Path(args.out_dir) / f"{provides}.py"
    if out.exists():
        print(f"error: {out} already exists", file=sys.stderr)
        return 1
    out.write_text(PLUGIN_TEMPLATE.format(
        provides=provides, class_name=class_name,
        depends_on=args.depends_on, schema_const=schema_const,
    ))
    module_path = str(out.with_suffix("")).replace("/", ".")
    test = Path(args.test_dir) / f"test_{provides}.py"
    test.write_text(TEST_TEMPLATE.format(
        provides=provides, class_name=class_name, module_path=module_path,
    ))
    print(f"created {out} and {test}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
