# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The row table the rollout kernel reads, held against the JAX package's.

``csrc/rollout.cu`` merges each row of a packed board by one read of a
table in shared memory, split from ``engine/lut.py``'s packed entries into
codes, one-byte score offsets and the list of distinct scores
(``fused.row_tables``), uploaded as ``fused.row_table_bytes``. Both forms
must give JAX's ``rein48_tpu.engine.lut.build_row_lut()`` back on all 65,536
rows.
"""

from __future__ import annotations

import numpy as np
import torch

from rein48_tpu.engine import lut as jlut
from rein48_tpu_torch.engine import fused

torch.set_num_threads(1)

ROWS = 1 << 16


def test_split_tables_give_the_jax_table_back():
    codes, offsets, quarters = fused.row_tables()
    assert (codes.dtype, codes.shape) == (np.uint16, (ROWS,))
    assert (offsets.dtype, offsets.shape) == (np.uint8, (ROWS,))
    assert (quarters.dtype, quarters.shape) == (np.uint16, (128,))
    assert (offsets % 2 == 0).all()  # the kernel reads a uint16 at each offset
    packed = codes.astype(np.uint32) | (quarters[offsets // 2].astype(np.uint32) << 16)
    np.testing.assert_array_equal(packed, jlut.build_row_lut())
    np.testing.assert_array_equal(quarters[offsets // 2].astype(np.int64) * 4, jlut.lut_score(jlut.build_row_lut()))


def test_scores_are_distinct_and_cover_the_cap():
    _, offsets, quarters = fused.row_tables()
    used = np.unique(offsets // 2)
    assert len(used) == len(np.unique(quarters[used]))  # one slot per distinct score
    assert quarters[0] == 0 and int(quarters.max()) * 4 == 2 * 2**16  # [15, 15, 15, 15]: two 15+15 merges


def test_uploaded_bytes_are_the_split_tables():
    codes, offsets, quarters = fused.row_tables()
    blob = fused.row_table_bytes()
    assert blob.dtype == np.uint8 and blob.size == 2 * ROWS + ROWS + 2 * 128 and blob.size % 16 == 0
    np.testing.assert_array_equal(blob[: 2 * ROWS].view("<u2"), codes)
    np.testing.assert_array_equal(blob[2 * ROWS : 3 * ROWS], offsets)
    np.testing.assert_array_equal(blob[3 * ROWS :].view("<u2"), quarters)


def test_device_table_is_uploaded_once():
    dev = torch.device("cpu")
    fused._device_tables.pop(dev, None)
    first = fused._device_table(dev)
    assert fused._device_table(dev) is first
    np.testing.assert_array_equal(first.numpy(), fused.row_table_bytes())
    fused._device_tables.pop(dev, None)
