"""The layer norm kernels' roofline share, on hand-built profiled segments:
the work's bytes over the kernels' device time over the card's bandwidth."""

import pytest
import torch

from conftest import SEED
from portbench import flops, harness

FORWARD = "void (anonymous namespace)::layer_norm_relu_forward<__nv_bfloat16, 8>(...)"
BACKWARD = "void (anonymous namespace)::layer_norm_relu_backward<__nv_bfloat16, 8>(...)"
SUM = "(anonymous namespace)::layer_norm_relu_sum(float const*, int, int, float*, float*)"
OTHER = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"


def ctx_with(name: str, kernels: dict, counters: dict, units: int = 2):
    """A full-size cell's context with the first profiled segment given."""
    ctx = harness.Ctx(cell=harness.find_cell(name), seed=SEED, device=torch.device("cpu"), sync=lambda: None)
    ctx.profile = {"units": units, "kernels": kernels, "counters": counters}
    return ctx


def read(ctx):
    return harness.load_module("metrics", f"layer_norm_roofline.{ctx.cell.name.split('_')[0]}").read(ctx)


def test_ppo_share_counts_the_traffic():
    ctx = ctx_with("ppo_flagship", {FORWARD: 0.03, BACKWARD: 0.05, SUM: 0.001, OTHER: 1.0}, {})
    want = 100 * 2 * 109_018_349_568 / flops.PEAK_HBM / 0.081
    assert read(ctx) == pytest.approx(want)


def test_search_share_counts_the_boards_fed():
    boards = 20 * 131_072
    ctx = ctx_with("search_depth1", {FORWARD: 0.002, OTHER: 1.0}, {"search.leaf_boards": boards}, units=20)
    assert read(ctx) == pytest.approx(100 * boards * 16 * 9 * 256 / flops.PEAK_HBM / 0.002)
    # Fewer boards fed for the same moves: fewer bytes, never a higher share.
    ctx = ctx_with("search_depth1", {FORWARD: 0.002}, {"search.leaf_boards": boards // 3}, units=20)
    assert read(ctx) == pytest.approx(100 * (boards // 3) * 16 * 9 * 256 / flops.PEAK_HBM / 0.002)


@pytest.mark.parametrize("name,kernels,counters", [
    ("ppo_flagship", {OTHER: 1.0}, {}),                       # no layer norm kernel ran: the CPU
    ("search_depth1", {FORWARD: 0.002}, {}),                  # no boards fed
    ("search_depth1", {}, {"search.leaf_boards": 131_072}),
])
def test_silent_without_kernels_or_work(name, kernels, counters):
    assert read(ctx_with(name, kernels, counters)) is None

