# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Where the device time goes (counterpart of ``utils/profiling.py``).

:func:`device_breakdown` runs a function under ``torch.profiler`` and
reports, per call: host wall time, device kernel time, the device's busy
share (kernel time over wall time; one stream, so kernels do not
overlap), the number of kernel launches, and the kernels that take the
most device time. Run as a script on a card, it profiles one call of each
main path of the port at the sizes ``chip_smoke.py`` drives:

    python -m rein48_tpu_torch.utils.profiling

and prints one JSON line per path.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_breakdown(fn, *, warmup: int = 1, reps: int = 3, top: int = 6) -> dict:
    """Profile ``reps`` calls of ``fn()`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / reps
    kernels.sort(key=_device_us, reverse=True)
    return {
        "wall_ms": round(wall_ms, 3),
        "device_ms": round(device_ms, 3),
        "busy_share": round(device_ms / wall_ms, 4) if wall_ms else None,
        "launches": sum(e.count for e in kernels) // reps,
        "top": [
            {"kernel": e.key[:80], "ms": round(_device_us(e) / 1e3 / reps, 3), "calls": e.count // reps}
            for e in kernels[:top]
        ],
    }


def main() -> None:
    from rein48_tpu_torch.engine import fused, vector
    from rein48_tpu_torch.models import nets
    from rein48_tpu_torch.train import evaluate

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    state = vector.reset_batch(0, 65536, dev)
    out = {"rollout B=65536 T=2048": device_breakdown(lambda: fused.rollout_random_fused(state, 1, 2048))}

    model = nets.ResNetPolicy(64, 4, generator=torch.Generator().manual_seed(20260)).to(dev).eval()
    for depth, envs, chunk in ((0, 1024, None), (1, 256, 4)):
        policy = evaluate._build_search_policy(depth, model, "onehot", 0.99, "log2", chunk)
        st = vector.reset_batch(123, envs, dev)

        @torch.inference_mode()
        def step(policy=policy, st=st):
            vector.step_autoreset(st, policy(st.boards))

        out[f"serve depth={depth} envs={envs} chance_chunk={chunk} (one step)"] = device_breakdown(step)
    for name, r in out.items():
        print(json.dumps({"path": name, "card": card, **r}))


if __name__ == "__main__":
    main()
