# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's public surface against the JAX package's, module for module.

Read with ``ast`` from both packages: every public module-level function's
parameter names and every public class's fields (annotated class
attributes, and ``__init__``'s parameters, which is where Flax fields land
in the port) must be in the port's counterpart. What differs on purpose is
listed in ``DIFFERENCES``, each with its reason; an entry that no longer
differs fails too, so the list stays true.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT, PORT_ROOT = REPO / "rein48_tpu", REPO / "rein48_tpu_torch"

KEY = "a JAX PRNG key: the port names its draws by seeds (engine/philox.py) or takes the draws themselves"
PARAMS = "a params pytree: the port's modules hold their parameters"
SHARDING = "a JAX sharding object or spec (ROADMAP.md Queue 1): the port shards through torch.distributed"
LANES = "the TPU kernel's lane layout or Pallas interpret mode (engine/fused.py)"
SCAN = "a lax.scan record: the port's loops are Python loops"
STATE = "a functional state's params, optimizer state and key: the port's state holds modules, an Optimizer and a seed"

# (module, name) -> (the JAX names the port lacks, why); a name alone for a missing function or class.
DIFFERENCES = {
    ("agents/a3c.py", "sample_actions"): ({"key"}, KEY),
    ("agents/dqn.py", "epsilon_greedy"): ({"key"}, KEY),
    ("agents/replay.py", "replay_sample"): ({"key", "batch_size"}, KEY + " (the sampled indices)"),
    ("agents/replay.py", "replay_sample_nstep"): ({"key", "batch_size"}, KEY + " (the sampled indices)"),
    ("control/__init__.py", "random_policy"): ({"key"}, KEY),
    ("control/__init__.py", "random_legal_policy"): ({"key"}, KEY),
    ("control/search.py", "make_value_leaf"): ({"params"}, PARAMS),
    ("engine/core.py", "random_spawn"): ({"board", "key"}, KEY + " (batched boards and their uniforms)"),
    ("engine/core.py", "reset"): ({"key"}, KEY),
    ("engine/core.py", "EnvState"): ({"key"}, KEY + " (Philox seed, env id and counter)"),
    ("engine/fused.py", "boards_to_soa"): (None, LANES),
    ("engine/fused.py", "soa_to_boards"): (None, LANES),
    ("engine/fused.py", "rollout_random_fused"): ({"block_envs", "interpret"}, LANES),
    ("engine/vector.py", "reset_batch"): ({"key"}, KEY),
    ("models/nets.py", "count_params"): ({"params"}, PARAMS),
    ("parallel/mesh.py", "make_mesh"): ({"devices"}, SHARDING + " (ranks of a process group, not devices)"),
    ("parallel/mesh.py", "batch_sharding"): (None, SHARDING),
    ("parallel/mesh.py", "replicated_sharding"): (None, SHARDING),
    ("parallel/mesh.py", "shard_params"): ({"params"}, PARAMS),
    ("parallel/spmd.py", "psum_mean_grads"): ({"axis_name"}, SHARDING + " (a process group)"),
    ("parallel/spmd.py", "replicate_spec"): (None, SHARDING),
    ("parallel/spmd.py", "dp_batch_spec"): (None, SHARDING),
    ("train/a3c.py", "init_a3c"): ({"key"}, KEY),
    ("train/a3c.py", "Transition"): (None, SCAN),
    ("train/a3c.py", "A3CTrainState"): ({"params", "opt_state", "key"}, STATE),
    ("train/afterstate.py", "init_afterstate_td"): ({"key"}, KEY),
    ("train/afterstate.py", "AfterstateTDState"): ({"params", "opt_state", "key"}, STATE),
    ("train/common.py", "tree_norm"): ({"tree"}, PARAMS + " (a list of tensors)"),
    ("train/ddpg.py", "init_ddpg"): ({"key"}, KEY),
    ("train/ddpg.py", "make_ddpg_step"): ({"actor", "critic", "tx"}, STATE + " (the step reads them from the state)"),
    ("train/ddpg.py", "DDPGTrainState"): (
        {"actor_params", "critic_params", "target_actor_params", "target_critic_params", "key"}, STATE
    ),
    ("train/dqn.py", "init_dqn"): ({"key"}, KEY),
    ("train/dqn.py", "DQNTrainState"): ({"params", "target_params", "opt_state", "key"}, STATE),
    ("train/evaluate.py", "evaluate_policy"): ({"params"}, PARAMS),
    ("train/evaluate.py", "evaluate_search"): ({"params"}, PARAMS),
    ("train/ntuple.py", "init_ntuple"): ({"key"}, KEY),
    ("train/ppo.py", "init_ppo"): ({"key"}, KEY),
    ("train/ppo.py", "PPOTransition"): (None, SCAN),
    ("train/ppo.py", "PPOTrainState"): ({"params", "opt_state", "key"}, STATE),
    ("utils/flops.py", "model_forward_flops"): (
        {"train"}, "the training-mode forward: dropout adds no product, so the port's count is the same in both modes"
    ),
    ("utils/metrics.py", "MetricLogger"): (
        {"tensorboard"}, "Flax's TensorBoard writer: no caller in either package sets it; the port writes stdout and the CSV"
    ),
    ("utils/profiling.py", "Throughput"): (
        None, "an env-steps/s meter whose clock starts at the first tick, so warm-up is timed: nothing in the port used it"
    ),
}


def public_surface(path: Path) -> dict:
    """``name -> parameter or field names`` of a module's public functions and classes."""
    surface = {}
    for node in ast.parse(path.read_text()).body:
        if node.name.startswith("_") if isinstance(node, (ast.FunctionDef, ast.ClassDef)) else True:
            continue
        if isinstance(node, ast.FunctionDef):
            a = node.args
            surface[node.name] = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
        else:
            names = {s.target.id for s in node.body if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)}
            for s in node.body:
                if isinstance(s, ast.FunctionDef) and s.name == "__init__":
                    names |= {x.arg for x in s.args.args[1:] + s.args.kwonlyargs}
            surface[node.name] = names
    return surface


PAIRS = sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py"))


@pytest.mark.parametrize("module", PAIRS)
def test_public_surface_matches_jax(module):
    port_path = PORT_ROOT / module
    assert port_path.exists(), f"no port of {module}"
    jax, port = public_surface(JAX_ROOT / module), public_surface(port_path)
    for name, names in jax.items():
        lacking = None if name not in port else names - port[name]
        allowed = DIFFERENCES.get((module, name))
        if allowed is None:
            assert name in port and not lacking, (name, lacking)
        else:
            assert lacking == allowed[0], (name, lacking, allowed)


def test_every_difference_is_read():
    """Each allow-list entry names a module pair and a JAX name that exist."""
    for module, name in DIFFERENCES:
        assert name in public_surface(JAX_ROOT / module), (module, name)
        assert DIFFERENCES[module, name][1]
