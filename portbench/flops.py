"""Model operations counted from shapes, and the card's peak.

A 3x3 SAME convolution on the 4x4 board reads, per output cell, only the
taps that land inside the board: 4 at a corner, 6 on an edge, 9 inside, so
100 of the 144 taps per channel pair. At 2 operations per multiply-add a
``ResNetPolicy(64, 4)`` forward of one board costs

* stem ``2 * 100 * 16 * 64`` = 204,800;
* eight block convolutions ``8 * 2 * 100 * 64 * 64`` = 6,553,600;
* heads ``2 * (1024 * 64 + 64 * 4 + 1024 * 64 + 64)`` = 262,784;

7,021,184 in all. Counting all 144 taps, padding included, gives
9,994,880. Biases, norms and activations are not counted.

The layer norms (``csrc/layer_norm.cu``, each with its ReLU) are counted in
bytes: 1 + 2 x blocks of them a forward, each over the 16 cells of a board
(its rows) at the tower's channels. A forward reads ``x`` and writes ``y`` in
the tower's type; one that keeps the row statistics for a backward adds
their 8 B a row (float32 mean and rstd). A backward reads ``x`` and ``dy``,
writes ``dx``, and reads the statistics. Each byte is counted once.
"""

from __future__ import annotations

# Dense bf16 tensor-core rate of one H100 SXM at 700 W (NVIDIA's data sheet:
# 1,979 TFLOP/s with sparsity, half of it dense).
PEAK_BF16 = 989e12
# HBM3 bandwidth of one H100 SXM (NVIDIA's data sheet: 3.35 TB/s).
PEAK_HBM = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}
STATS_BYTES = 8  # a row's float32 mean and rstd


def conv_taps(padded: bool = False) -> int:
    """Taps of a 3x3 SAME convolution over the 4x4 board, summed over the
    output cells: those inside the board, or all of them."""
    if padded:
        return 16 * 9
    span = [min(i + 1, 3) - max(i - 1, 0) + 1 for i in range(4)]  # rows (or columns) each cell reaches
    return sum(r * c for r in span for c in span)


def resnet_forward(channels: int = 64, blocks: int = 4, padded: bool = False) -> int:
    """Operations of one board's forward pass (16 one-hot input planes)."""
    taps = conv_taps(padded=padded)
    convs = 2 * taps * 16 * channels + 2 * blocks * 2 * taps * channels * channels
    flat = 16 * channels
    heads = 2 * (flat * channels + channels * 4 + flat * channels + channels * 1)
    return convs + heads


def ppo_per_frame(epochs: int) -> int:
    """Forward-equivalents per env step of a PPO update: one acting
    forward, and per epoch a forward and a backward (two forwards' worth)."""
    return 1 + 3 * epochs


def layer_norm_bytes(config: dict, boards: int, train: bool = False) -> int:
    """Bytes the layer norms of ``boards`` boards' forward passes move at
    least, with the backward's when ``train``."""
    rows = boards * 16 * (1 + 2 * config["num_blocks"])
    x = config["channels"] * DTYPE_BYTES[config["dtype"]]
    if not train:
        return rows * 2 * x
    return rows * (2 * x + STATS_BYTES) + rows * (3 * x + STATS_BYTES)


def ppo_layer_norm_bytes(config: dict, ppo: dict) -> int:
    """Layer-norm bytes of one PPO update: ``unroll_len`` + 1 acting passes
    of the batch, then epochs x minibatches learning passes of a minibatch,
    each with its backward."""
    b, t, passes = ppo["batch_size"], ppo["unroll_len"], ppo["num_epochs"] * ppo["num_minibatches"]
    return (t + 1) * layer_norm_bytes(config, b) + passes * layer_norm_bytes(config, b * t // ppo["num_minibatches"], True)
