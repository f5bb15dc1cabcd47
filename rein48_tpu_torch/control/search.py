# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Batched exact expectimax (port of ``control/search.py``).

Max over legal moves, expectation over the spawn distribution (uniform
blank cell; 2 w.p. 0.9, 4 w.p. 0.1), with the snake heuristic or a value
net at the leaves. As in the JAX package the tree is never walked node by
node: each level is one tensor expansion, ``[N]`` boards to ``[N, 4]``
afterstates to ``[N, 4, 32]`` chance children, and the leaves of the whole
batch go through the leaf evaluator as one batch (``B * 4 * 32 * 4`` boards
at depth 1). ``chance_chunk`` evaluates the 32 chance children a group at
a time, which bounds the leaf batch; the sum is the same.

Every call of the leaf evaluator, whatever it is (a value net, an n-tuple
network, the heuristic), is one ``search.leaf`` span and counts the boards
it is fed in ``search.leaf_boards`` (``utils/profiling``), in
:func:`_leaf_values` alone, so that no leaf counts twice.

On the card a move is thousands of small launches, so eagerly the host
sets the pace; :class:`Replayed` hands the card the whole move as one CUDA
graph replay. Both learned players use it: the value-net player
(``train/evaluate._build_search_policy``) and the n-tuple player
(``train/ntuple._get_ntuple_policy``).
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch

from rein48_tpu_torch.engine import core
from rein48_tpu_torch.train import common
from rein48_tpu_torch.utils import profiling

NUM_ACTIONS = core.NUM_ACTIONS
NUM_CELLS = core.NUM_CELLS
CHANCE_BRANCH = 2 * NUM_CELLS
SPAWN_P4 = 0.1
# Value of a dead max node for the snake heuristic; dominates any reachable
# heuristic value (max ~2^16 * 4^15 ~ 7e13).
DEATH_VALUE = -1e15

_SNAKE_RANK = np.array(
    [
        [15, 14, 13, 12],
        [8, 9, 10, 11],
        [7, 6, 5, 4],
        [0, 1, 2, 3],
    ],
    dtype=np.float32,
)
_SNAKE_WEIGHTS = (4.0**_SNAKE_RANK).astype(np.float32)


def _snake_weights(device) -> torch.Tensor:
    """The 8 symmetries of the snake weights, ``[8, 4, 4]``, in the JAX order."""
    w = torch.from_numpy(_SNAKE_WEIGHTS).to(device)
    out = []
    for flip_h in (False, True):
        for flip_v in (False, True):
            for transpose in (False, True):
                ww = w.T if transpose else w
                if flip_h:
                    ww = ww.flip(1)
                if flip_v:
                    ww = ww.flip(0)
                out.append(ww)
    return torch.stack(out)


def heuristic(boards: torch.Tensor) -> torch.Tensor:
    """Snake-weighted tile sum, the best of the 8 symmetries, float32."""
    vals = core.boards_to_values(boards).to(torch.float32)
    best = None
    for ww in _snake_weights(boards.device):
        s = (vals * ww).sum((-2, -1))
        best = s if best is None else torch.maximum(best, s)
    return best


def _chance_children(after: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All spawn outcomes of afterstates ``[..., 4, 4]``.

    Returns ``(children[..., 32, 4, 4], probs[..., 32])``, ordered cell 0
    tile 2, ..., cell 15 tile 2, cell 0 tile 4, ...; a non-blank cell's
    child, of probability 0, is the afterstate itself. Spawning on a taken
    cell would raise its tile, up to exponent 17 from a 2^15 tile, past
    the 16 values a cell of an n-tuple table holds.
    """
    blanks = (after == 0).reshape(after.shape[:-2] + (NUM_CELLS,))
    n_blanks = blanks.sum(-1, keepdim=True).to(torch.float32)
    p_cell = blanks.to(torch.float32) / torch.clamp(n_blanks, min=1.0)
    probs = torch.cat([p_cell * (1.0 - SPAWN_P4), p_cell * SPAWN_P4], dim=-1)
    eye = torch.eye(NUM_CELLS, dtype=after.dtype, device=after.device).reshape(NUM_CELLS, 4, 4)
    spawns = torch.cat([eye, 2 * eye])
    children = after[..., None, :, :] + spawns * (probs > 0)[..., None, None]
    return children, probs


def _afterstates(boards: torch.Tensor):
    """Afterstates of every action: ``[..., 4, 4, 4]`` + reward + legal."""
    lead = boards.shape[:-2]
    actions = torch.arange(NUM_ACTIONS, device=boards.device).expand(lead + (NUM_ACTIONS,))
    tiled = boards[..., None, :, :].expand(lead + (NUM_ACTIONS,) + boards.shape[-2:])
    return core.move_boards(tiled, actions)


def _value_max(boards, depth, leaf_value, reward_fn, gamma, death_value, chance_chunk=None):
    """Expectimax value of max nodes ``[...]``."""
    q, legal = _action_values(boards, depth, leaf_value, reward_fn, gamma, death_value, chance_chunk)
    dead = ~legal.any(-1)
    best = torch.where(legal, q, -torch.inf).amax(-1)
    return torch.where(dead, death_value, best)


def _leaf_values(leaf_value, after: torch.Tensor) -> torch.Tensor:
    """``leaf_value(after)`` as one ``search.leaf`` span, its boards counted."""
    with profiling.span("search.leaf"):
        profiling.count("search.leaf_boards", after.numel() // NUM_CELLS)
        return leaf_value(after)


def _value_chance(after, depth, leaf_value, reward_fn, gamma, death_value, chance_chunk=None):
    """Expected value of chance nodes (afterstates) ``[...]``.

    ``chance_chunk`` (must divide 32) evaluates the children that many at a
    time and sums the partial expectations, chunk by chunk.
    """
    if depth <= 0:
        return _leaf_values(leaf_value, after)
    children, probs = _chance_children(after)
    if chance_chunk is None or chance_chunk >= CHANCE_BRANCH:
        child_values = _value_max(children, depth - 1, leaf_value, reward_fn, gamma, death_value, chance_chunk)
        return (probs * child_values).sum(-1)
    if CHANCE_BRANCH % chance_chunk:
        raise ValueError(f"chance_chunk {chance_chunk} must divide {CHANCE_BRANCH}")
    total = None
    for k in range(0, CHANCE_BRANCH, chance_chunk):
        v = _value_max(
            children[..., k : k + chance_chunk, :, :],
            depth - 1,
            leaf_value,
            reward_fn,
            gamma,
            death_value,
            chance_chunk,
        )
        part = (probs[..., k : k + chance_chunk] * v).sum(-1)
        total = part if total is None else total + part
    return total


def _action_values(boards, depth, leaf_value, reward_fn, gamma, death_value=DEATH_VALUE, chance_chunk=None):
    """Q(board, a) = merge reward + gamma * E[value of afterstate]."""
    after, reward, legal = _afterstates(boards)
    q = reward_fn(reward) + gamma * _value_chance(
        after, depth, leaf_value, reward_fn, gamma, death_value, chance_chunk
    )
    return q, legal


def _argmax_legal(q: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """First best legal action; action 0 when no action is legal."""
    q = torch.where(legal, q, -torch.inf)
    q = torch.where(~legal.any(-1, keepdim=True), 0.0, q)
    return q.argmax(-1)


def expectimax_policy(boards: torch.Tensor, depth: int = 1) -> torch.Tensor:
    """Best action per board by depth-``depth`` expectimax on the heuristic."""
    q, legal = _action_values(boards, depth, heuristic, lambda r: r, 1.0)
    return _argmax_legal(q, legal)


def make_expectimax_policy(
    depth: int,
    *,
    leaf_value=heuristic,
    reward_fn=lambda r: r,
    gamma: float = 1.0,
    death_value: float = DEATH_VALUE,
    chance_chunk: int | None = None,
):
    """Build ``policy(boards) -> actions`` with a custom leaf evaluator.

    With a value net as the leaf (:func:`make_value_leaf`), pass the
    critic's ``reward_fn`` and ``gamma``, and ``death_value=0.0`` (trainers
    bootstrap V=0 at done); see the JAX docstring for why the leaf should
    be an afterstate value function. Each call is one ``search.policy`` span.
    """

    def policy(boards: torch.Tensor) -> torch.Tensor:
        with profiling.span("search.policy"):
            q, legal = _action_values(boards, depth, leaf_value, reward_fn, gamma, death_value, chance_chunk)
            return _argmax_legal(q, legal)

    return policy


def make_value_leaf(model, obs_encoding: str = "onehot"):
    """Leaf evaluator from a policy/value module's value head.

    Accepts the search's ``[..., 4, 4]`` board tensors of any leading rank:
    they are flattened to one batch for the network (``B * 4 * 32 * 4``
    boards at depth 1) and the values reshaped back. The tree spans and
    counts each call (:func:`_leaf_values`).
    """

    def leaf_value(boards: torch.Tensor) -> torch.Tensor:
        lead = boards.shape[:-2]
        flat = boards.reshape((-1,) + boards.shape[-2:])
        _, value = model(common.encode_obs(flat, obs_encoding))
        return value.reshape(lead)

    return leaf_value


def _state_key(held) -> tuple:
    """Name, address, shape and type of every tensor of ``held`` that a
    graph reads in place: a dict's tensors by key, a module's parameters
    and buffers by name."""
    out = []
    for obj in held:
        named = obj.items() if isinstance(obj, dict) else itertools.chain(obj.named_parameters(), obj.named_buffers())
        out.append(tuple((k, v.data_ptr(), tuple(v.shape), v.dtype) for k, v in sorted(named)))
    return tuple(out)


class Replayed:
    """``policy(*state, boards) -> actions`` that replays a CUDA graph of
    ``eager``, called with the same arguments.

    ``state`` are the arguments read in place, such as the n-tuple
    player's dict of tables; ``closes_over`` the modules or dicts that
    ``eager`` reads without being passed them, such as the value net of
    :func:`make_value_leaf`. On the card, the first call with a key (the
    boards' shape, type and device, the grad and inference modes, and the
    name, address, shape and type of every tensor of ``state`` and
    ``closes_over``, :meth:`key`) runs eagerly; the next call with the same
    key captures the graph and every later one replays it, on the tensors
    at those addresses as they stand. So tensors updated in place between
    calls (``load_state_dict``, an optimizer step, a table update) are
    read anew, and a replaced tensor is a new key: that call runs eagerly
    and the next one captures anew. The boards are copied in and the
    actions cloned out. A replay runs the kernels its capture launched, on
    the same inputs as the eager move; cuDNN may pick other convolution
    algorithms under capture, which can break a float tie of the value
    net's q the other way.

    A replay adds to the counters (``utils/profiling``) what its capture
    counted, so ``search.leaf_boards`` and each kernel's launches read as
    they do eagerly. While spans are on (``profiling.tracing()``) every
    call runs eagerly, since a span times its work on the device's clock
    between events that a replay does not record. On the card each call
    counts one of ``replay.eager``, ``replay.captures`` and
    ``replay.replays``; on the CPU every call runs eagerly and counts
    none. A graph replays the kernels it captured: code patched in after
    the capture does not reach it.
    """

    def __init__(self, eager, closes_over=()):
        self.eager = eager
        self.closes_over = tuple(closes_over)
        self._seen = None
        self._graph = None  # (key, graph, boards_in, actions_out, counts)

    def key(self, *args) -> tuple:
        """What a graph of a call with ``args`` holds fixed."""
        *state, boards = args
        return (tuple(boards.shape), boards.dtype, boards.device, torch.is_grad_enabled(),
                torch.is_inference_mode_enabled(), _state_key(tuple(state) + self.closes_over))

    def __call__(self, *args):
        *state, boards = args
        if not boards.is_cuda:
            return self.eager(*args)
        if profiling.on():
            profiling.count("replay.eager")
            return self.eager(*args)
        key = self.key(*args)
        if self._graph is not None and self._graph[0] == key:
            profiling.count("replay.replays")
        elif self._seen != key:
            self._seen = key
            profiling.count("replay.eager")
            return self.eager(*args)
        else:
            self._graph = None
            self._graph = self._capture(key, state, boards)
            profiling.count("replay.captures")
        _, graph, boards_in, actions, counts = self._graph
        boards_in.copy_(boards)
        with torch.cuda.device(boards.device):
            graph.replay()
        for name, n in counts.items():
            profiling.count(name, n)
        return actions.clone()

    def _capture(self, key, state, boards):
        boards_in = boards.clone()
        before = profiling.snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(boards.device), torch.cuda.graph(graph):
            actions = self.eager(*state, boards_in)
        counts = {k: v - before.get(k, 0) for k, v in profiling.counters.items() if v != before.get(k, 0)}
        for name, n in counts.items():
            profiling.count(name, -n)
        return key, graph, boards_in, actions, counts
