# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""``python -m rein48_tpu_torch`` entry point."""

from rein48_tpu_torch.cli import main

raise SystemExit(main())
