# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Metric logging: stdout and CSV (port of ``utils/metrics.py``).

Every trainer emits flat records through one logger: one line each on
stdout and a row each in ``<log_dir>/metrics.csv``. The JAX package's
optional TensorBoard writer (``flax.metrics``) is left out, since the
port imports no Flax.
"""

from __future__ import annotations

import csv
import json
import os
import sys
import time
from typing import IO, Mapping, Optional


class MetricLogger:
    """Append-only metric stream.

    Args:
        log_dir: directory for ``metrics.csv``; ``None`` logs to stdout only.
        stdout: echo one-line summaries to stdout.
    """

    def __init__(self, log_dir: Optional[str] = None, stdout: bool = True):
        self._stdout = stdout
        self._csv_file: Optional[IO] = None
        self._csv_writer = None
        self._t0 = time.time()
        self.log_dir = log_dir
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._csv_path = os.path.join(log_dir, "metrics.csv")

    def write(self, record: Mapping) -> None:
        """Log one record (flat dict of scalars)."""
        record = dict(record)
        record.setdefault("wall_time", round(time.time() - self._t0, 3))
        if self._stdout:
            parts = [f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in record.items()]
            print("  ".join(parts), file=sys.stdout, flush=True)
        if self.log_dir is not None:
            if self._csv_writer is None:
                self._csv_file = open(self._csv_path, "a", newline="")
                self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=list(record), extrasaction="ignore")
                if self._csv_file.tell() == 0:
                    self._csv_writer.writeheader()
            self._csv_writer.writerow(record)
            self._csv_file.flush()

    def write_json(self, record: Mapping) -> None:
        """One machine-readable JSON line to stdout."""
        print(json.dumps(dict(record)), flush=True)

    def close(self) -> None:
        if self._csv_file is not None:
            self._csv_file.close()
