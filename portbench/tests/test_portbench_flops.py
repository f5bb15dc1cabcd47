"""Operations counted from shapes."""

from portbench import flops


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
