"""The flagship residual policy/value tower in plain float32 PyTorch.

Written from the published description (the project's ``ResNetPolicy``,
after its Flax original): one-hot planes of the exponents, a SAME stem
convolution, pre-activation blocks ``x + conv(relu(norm(conv(relu(norm
x)))))``, a layer norm and a relu, then a policy head (dense
``head_hidden``, relu, dense ``num_actions``) and a value head (dense
``head_hidden``, relu, dense 1) on the features flattened in (row, column,
channel) order. Layer norms run over the channels. Every size comes from
the configuration's file (``spec``): ``channels``, ``num_blocks``,
``kernel_size``, ``planes``, ``num_actions``, ``head_hidden`` and
``norm_epsilon``; the reference computes in float32 and refuses a
configuration that states other parameter or norm types.

Parameters are a dict of float32 tensors under the names the benchmark
gives them (``stem.weight`` OIHW, ``blocks.<i>.norm0.scale``, ...,
``policy_fc.weight`` ``[out, in]``). ``quant``, when given, is applied to
the input and the weight of every convolution and dense layer: the control
runs the same tower through an 8-bit float that way.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

def _checked(spec: dict) -> dict:
    if spec["padding"] != "SAME" or spec["kernel_size"] % 2 == 0:
        raise NotImplementedError("the reference implements odd SAME convolutions")
    if (spec["param_dtype"], spec["norm_dtype"]) != ("float32", "float32"):
        raise NotImplementedError("the reference implements float32 parameters and norms")
    return spec


def param_shapes(spec: dict) -> dict:
    """Every parameter's name and shape, in a fixed order."""
    _checked(spec)
    c, k, h = spec["channels"], spec["kernel_size"], spec["head_hidden"]
    shapes = {"stem.weight": (c, spec["planes"], k, k), "stem.bias": (c,)}
    for i in range(spec["num_blocks"]):
        for j in (0, 1):
            shapes[f"blocks.{i}.norm{j}.scale"] = (c,)
            shapes[f"blocks.{i}.norm{j}.bias"] = (c,)
            shapes[f"blocks.{i}.conv{j}.weight"] = (c, c, k, k)
            shapes[f"blocks.{i}.conv{j}.bias"] = (c,)
    shapes["norm.scale"] = (c,)
    shapes["norm.bias"] = (c,)
    for head, out in (("policy", spec["num_actions"]), ("value", 1)):
        shapes[f"{head}_fc.weight"] = (h, 16 * c)
        shapes[f"{head}_fc.bias"] = (h,)
        shapes[f"{head}_out.weight"] = (out, h)
        shapes[f"{head}_out.bias"] = (out,)
    return shapes


def make_params(spec: dict, seed: int, device) -> dict:
    """Weights drawn on ``device`` from ``seed`` in one call: normal kernels
    of variance 1/fan_in cut at two standard deviations, zero biases, unit
    norm scales (the tower's usual initialisation)."""
    shapes = param_shapes(spec)
    kernels = {k: s for k, s in shapes.items() if k.endswith(".weight")}
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(math.prod(s) for s in kernels.values()), generator=gen, device=device)
    draw = draw.clamp(-2.0, 2.0)
    params, at = {}, 0
    for k, s in shapes.items():
        if k in kernels:
            n = math.prod(s)
            fan_in = n // s[0]
            params[k] = (draw[at : at + n] * (1.0 / math.sqrt(fan_in) / 0.8796256610342398)).reshape(s)
            at += n
        elif k.endswith(".scale"):
            params[k] = torch.ones(s, device=device)
        else:
            params[k] = torch.zeros(s, device=device)
    return params


@contextlib.contextmanager
def exact_float32():
    """Float32 products without TF32, as the reference computes them."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 under a per-tensor scale (amax to 448), back to float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    # Straight-through: the rounding passes the gradient unchanged.
    return x + (q - x).detach()


def onehot(boards: torch.Tensor, planes: int) -> torch.Tensor:
    """``uint8[N, 4, 4]`` -> float32 ``[N, planes, 4, 4]`` planes (NCHW)."""
    k = torch.arange(planes, device=boards.device)
    return (boards.long()[:, None] == k[None, :, None, None]).to(torch.float32)


def _norm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """Layer norm over the channel axis of NCHW activations."""
    mean = x.mean(1, keepdim=True)
    var = ((x - mean) ** 2).mean(1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale[None, :, None, None] + bias[None, :, None, None]


def forward(params: dict, boards: torch.Tensor, spec: dict, quant=None):
    """``(logits float32[N, num_actions], value float32[N])`` of boards ``[N, 4, 4]``."""
    q = quant or (lambda t: t)
    eps, pad = spec["norm_epsilon"], _checked(spec)["kernel_size"] // 2

    def conv(x, name):
        return F.conv2d(q(x), q(params[f"{name}.weight"]), params[f"{name}.bias"], padding=pad)

    def dense(x, name):
        return F.linear(q(x), q(params[f"{name}.weight"]), params[f"{name}.bias"])

    x = conv(onehot(boards, spec["planes"]), "stem")
    for i in range(spec["num_blocks"]):
        p = f"blocks.{i}"
        h = conv(F.relu(_norm(x, params[f"{p}.norm0.scale"], params[f"{p}.norm0.bias"], eps)), f"{p}.conv0")
        h = conv(F.relu(_norm(h, params[f"{p}.norm1.scale"], params[f"{p}.norm1.bias"], eps)), f"{p}.conv1")
        x = x + h
    x = F.relu(_norm(x, params["norm.scale"], params["norm.bias"], eps))
    flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    logits = dense(F.relu(dense(flat, "policy_fc")), "policy_out")
    value = dense(F.relu(dense(flat, "value_fc")), "value_out")[:, 0]
    return logits, value


def forward_blocks(params: dict, boards: torch.Tensor, spec: dict, quant=None, rows: int = 32768):
    """:func:`forward` over ``rows`` boards at a time, without gradients."""
    outs = [forward(params, b, spec, quant) for b in boards.split(rows)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
