# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The recipes of the JAX package's ``examples/``, as entry points of the port.

One module per recipe, named after the JAX script with ``_tpu`` dropped, run
with the script's positional arguments and defaults::

    python -m rein48_tpu_torch.examples.train_ntuple 4000 1024 delayed

Each module has ``main(argv=None, *, device=None)``, builds its trainer
config in ``make_config``, lists the keyword arguments of its
``evaluate_*`` calls in ``evaluations`` (all but ``a3c_parity_curve``, which
scores under the reference's own protocol), and writes ``runs/<tag>/`` and ``ckpt/<tag>/``
under the working directory, the tag being the JAX script's with ``_tpu``
replaced by ``_cuda``. Every recipe runs on the card unless ``device="cpu"``
is passed. ``JAX_RECORDS`` maps what a recipe writes to the committed record
of the JAX recipe whose keys it has (``_recipe.jax_keys``). The frontier
sweeps (``ntuple_frontier``, ``ntuple_frontier_b``) write one record of legs
under ``runs/`` (the JAX ones wrote theirs under ``benchmarks/``).

Recipes that warm-start read the port's own checkpoints (the port reads no
orbax): ``train_ppo_afterstate`` starts its policy from
``ckpt/ppo_flagship_cuda`` and ``train_afterstate_td`` its value net from the
critic of ``ckpt/ppo_afterstate_cuda``.
"""
