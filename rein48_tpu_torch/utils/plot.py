# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Training-curve plots from a ``MetricLogger`` CSV (port of ``utils/plot.py``).

Curves render to a PNG from the ``metrics.csv`` the logger writes, apart
from training:

    python -m rein48_tpu_torch.utils.plot runs/dqn/metrics.csv [out.png]

matplotlib is imported when a plot is drawn, so the package imports
without it.
"""

from __future__ import annotations

import csv
import os
import sys
from typing import List, Optional

DEFAULT_COLUMNS = ("avg_episode_tile_sum", "best_tile", "loss", "entropy", "steps_per_sec")


def plot_metrics(csv_path: str, out_path: Optional[str] = None, columns: Optional[List[str]] = None) -> str:
    """Render the selected metric columns against the update index to a PNG
    (``curves.png`` beside the CSV by default); returns its path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"{csv_path} is empty")
    cols = [c for c in (columns or DEFAULT_COLUMNS) if c in rows[0] and any(r.get(c) not in (None, "") for r in rows)]
    x = [float(r.get("update", i)) for i, r in enumerate(rows)]

    fig, axes = plt.subplots(len(cols), 1, figsize=(8, 2.2 * len(cols)), sharex=True)
    if len(cols) == 1:
        axes = [axes]
    for ax, c in zip(axes, cols):
        ys = [float(r[c]) if r.get(c) not in (None, "") else float("nan") for r in rows]
        ax.plot(x, ys, lw=1.2)
        ax.set_ylabel(c)
        ax.grid(True, alpha=0.3)
    axes[-1].set_xlabel("update")
    fig.tight_layout()
    out_path = out_path or os.path.join(os.path.dirname(os.path.abspath(csv_path)), "curves.png")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m rein48_tpu_torch.utils.plot <metrics.csv> [out.png]")
        return 2
    print(plot_metrics(argv[0], argv[1] if len(argv) > 1 else None))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
