# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Depth-2 expectimax over the deep afterstate-TD net (counterpart of
``examples/eval_afterstate_depth2_tpu.py``).

    python -m rein48_tpu_torch.examples.eval_afterstate_depth2 {probe|run} [envs] [steps] [chance_chunk] [launch_chunk] [tag]

16,384 ResNet leaf evaluations per board per move. ``probe`` plays one
``launch_chunk``-step sweep twice (the first pays the warm-up) and prints
ms per env-step and the full run's projected time; ``run`` plays the
first-episode row and writes ``runs/<tag>/eval_depth2.json`` after every
launch chunk (lower-bound statistics and ``partial: true``), stopping
early once every first episode has finished. ``tag`` names the checkpoint
and run directory (``afterstate_td_cuda``).
"""

from __future__ import annotations

import time

from rein48_tpu_torch.device import resolve_device
from rein48_tpu_torch.examples import _recipe
from rein48_tpu_torch.train.afterstate import AfterstateTDConfig
from rein48_tpu_torch.train.evaluate import evaluate_search
from rein48_tpu_torch.utils.checkpoint import Checkpointer


def parse(argv=None) -> list:
    """``[mode, num_envs, num_steps, chance_chunk, launch_chunk, tag]``."""
    return _recipe.positional(
        argv, (str, "probe"), (int, lambda mode: 8 if mode == "probe" else 32), (int, 16384), (int, 8), (int, 128),
        (str, "afterstate_td_cuda"),
    )


def make_config() -> AfterstateTDConfig:
    return AfterstateTDConfig()


def evaluations(config: AfterstateTDConfig, mode: str, num_envs: int, num_steps: int, chance_chunk: int,
                launch_chunk: int) -> list:
    """``(tag, evaluate_search keywords)``: two probe sweeps, or the row."""
    common = dict(
        depth=2, obs_encoding=config.obs_encoding, gamma=config.gamma, reward_transform=config.reward_transform,
        chance_chunk=chance_chunk, protocol="first", launch_chunk=launch_chunk, num_envs=num_envs,
    )
    if mode == "probe":
        return [(tag, dict(common, num_steps=launch_chunk, seed=99)) for tag in ("compile+run", "steady")]
    return [("depth2", dict(common, num_steps=num_steps, seed=123))]


def main(argv=None, *, device=None) -> dict:
    mode, num_envs, num_steps, chance_chunk, launch_chunk, tag = parse(argv)
    device = resolve_device(device)
    config = make_config()
    ckpt = Checkpointer(f"ckpt/{tag}")
    model = config.make_model().to(device)
    model.load_state_dict(ckpt.restore_field("model"))
    step_loaded = ckpt.latest_step()
    print(f"restored afterstate-TD checkpoint step {step_loaded}", flush=True)
    plan = evaluations(config, mode, num_envs, num_steps, chance_chunk, launch_chunk)

    if mode == "probe":
        return _recipe.probe(plan, lambda kwargs: evaluate_search(model=model, device=device, **kwargs), num_envs, num_steps)

    out_path = f"runs/{tag}/eval_depth2.json"
    t0 = time.perf_counter()

    def write(stats, *, steps_done, partial):
        wall = time.perf_counter() - t0
        out = {
            "checkpoint_step": step_loaded,
            "depth": 2,
            "num_envs": num_envs,
            "num_steps": num_steps,
            "steps_done": steps_done,
            "partial": partial,
            "chance_chunk": chance_chunk,
            "launch_chunk": launch_chunk,
            "wall_sec": round(wall, 1),
            "sec_per_move_per_env": round(wall / (steps_done * num_envs), 6),
            "results": stats,
        }
        _recipe.write_json(out_path, out)
        return out

    progress = {"steps_done": num_steps}

    def on_chunk(steps_done, stats):
        progress["steps_done"] = steps_done
        write(stats, steps_done=steps_done, partial=True)
        print(
            f"  [{steps_done}/{num_steps}] unfinished {stats['unfinished']:.0f} "
            f"avg_score {stats['avg_score']:.0f} best {stats['best_tile']:.0f}",
            flush=True,
        )
        return stats["unfinished"] == 0.0  # every first episode done: stop early

    (_, kwargs), = plan
    stats = evaluate_search(model=model, device=device, on_chunk=on_chunk, **kwargs)
    stats["wall_sec"] = round(time.perf_counter() - t0, 1)
    out = write(stats, steps_done=progress["steps_done"], partial=False)
    print("EVAL depth2:", stats, flush=True)
    return out


if __name__ == "__main__":
    main()
