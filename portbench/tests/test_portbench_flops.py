"""Operations counted from shapes."""

from portbench import flops, harness


def test_resnet_forward_counts():
    assert flops.conv_taps() == 100
    assert flops.conv_taps(padded=True) == 144
    assert flops.resnet_forward(64, 4) == 7_021_184
    assert flops.resnet_forward(64, 4, padded=True) == 9_994_880
    assert flops.ppo_per_frame(4) == 13


def test_padded_count_is_the_port_flop_counter():
    """The padded count is what ``FlopCounterMode`` reads from the port."""
    import torch

    from rein48_tpu_torch.models import nets
    from rein48_tpu_torch.utils import flops as port_flops

    model = nets.ResNetPolicy(64, 4, dtype=torch.float32)
    assert port_flops.model_forward_flops(model) == flops.resnet_forward(64, 4, padded=True)


def test_layer_norm_bytes_of_a_ppo_update():
    """At the cell's traffic: 109.0 GB an update, 32.54 ms at 3.35 TB/s."""
    cell = harness.find_cell("ppo_flagship")
    rows = 16 * 9  # a board's rows in each of a ResNetPolicy(64, 4) pass's nine norms
    assert flops.layer_norm_bytes(cell.config, 1) == rows * 2 * 128
    assert flops.layer_norm_bytes(cell.config, 1, train=True) == rows * (2 * 128 + 8 + 3 * 128 + 8)
    n = flops.ppo_layer_norm_bytes(cell.config, cell.traffic["ppo"])
    assert n == 109_018_349_568
    assert round(1e3 * n / flops.PEAK_HBM, 2) == 32.54
