# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The ResNet's layer norm and the ReLU after it, forward and backward.

Flax's ``nn.LayerNorm`` over the last (channel) axis, as ``models/nets.py``
computes it: epsilon 1e-6, statistics in float32 with the fast variance
``E[x^2] - E[x]^2`` clipped at 0, the affine ``(x - mean) * (rsqrt(var +
eps) * scale) + bias``, the output rounded to ``x``'s type, then the ReLU
that follows every norm of the ResNet. Rounding first and taking the ReLU
after is the same as the other way round, so fusing the ReLU is exact.

In the JAX package XLA fuses this function; run eagerly it is about 12
float32 launches forward and as many backward. On the card
:func:`layer_norm_relu` is one launch of the kernel of
``csrc/layer_norm.cu`` forward, and two backward (the rows, then the sum
of the blocks' partial ``dscale``/``dbias`` rows), through a
:class:`torch.autograd.Function`; see the note at the top of that file. A
CPU tensor runs the plain version, :func:`layer_norm_reference` then
``F.relu``, the composition the port used before the kernel, bit for bit;
any other device raises. The counters ``layer_norm.forward_launches``,
``layer_norm.backward_launches`` and ``layer_norm.backward_sum_launches``
(``utils/profiling.counters``) count kernel launches, never those of the
plain version; ``layer_norm.bound_bytes`` adds up the bytes each launch
must move at least (its bound: ``x`` read and the output written, the row
statistics where kept; backward ``x``, ``dy`` and the statistics read and
``dx`` written).

Inputs: ``x`` contiguous float32 or bfloat16 (the type the model computes
in, which is also the output's) with at most :data:`MAX_CHANNELS` channels
on its last axis (the convolutions' output is channels last); ``scale`` and
``bias`` float32 ``[C]``. Anything else raises, on every device.

Exactness on the card: the kernel rounds every product and sum as the plain
version does, but adds the row sums in another order, so its statistics
differ by float32 ulps and a bfloat16 output can land one ulp over on a
rounding boundary. The backward sums in a fixed order (no float atomics):
it gives the same bits on every run.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from rein48_tpu_torch.ops.tables import _raise_on, _stream
from rein48_tpu_torch.utils import profiling

MAX_CHANNELS = 256  # channels of a row: 32 lanes of 8 (csrc/layer_norm.cu kMaxChannels)
MAX_CTAS = 1024  # partial rows of a backward (csrc/layer_norm.cu kMaxCtas)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's type codes
STATS_BYTES = 8  # a row's float32 mean and rstd

_vp, _ll, _int, _float = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "rein48_layer_norm_relu_forward": [_vp, _ll, _int, _int, _vp, _vp, _float, _vp, _vp, _vp, _vp],
    "rein48_layer_norm_relu_backward": [_vp, _vp, _ll, _int, _int, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp],
}
_fns: dict = {}


def _fn(name: str):
    """The C function ``name`` of ``csrc/layer_norm.cu``, built on first use."""
    fn = _fns.get(name)
    if fn is None:
        from rein48_tpu_torch import build

        fn = getattr(build.load("layer_norm"), name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
        _fns[name] = fn
    return fn


def layer_norm_reference(x, scale, bias, eps: float = 1e-6, dtype=torch.bfloat16):
    """Plain layer norm, the kernel's without its ReLU: the float32
    composition, the output cast to ``dtype``."""
    x = x.to(torch.float32)
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = (x - mean) * (torch.rsqrt(var + eps) * scale) + bias
    return y.to(dtype)


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> None:
    """Raises on what the kernel does not take."""
    if x.dtype not in DTYPES:
        raise ValueError(f"layer_norm_relu takes float32 or bfloat16, got {x.dtype}")
    if x.ndim < 1 or not 1 <= x.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"layer_norm_relu takes 1 to {MAX_CHANNELS} channels on the last axis, got shape {list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"layer_norm_relu needs x contiguous, its channels last, got strides {x.stride()}")
    c = x.shape[-1]
    for name, p in (("scale", scale), ("bias", bias)):
        if p.dtype != torch.float32 or p.shape != (c,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32[{c}] on {x.device}, got {p.dtype}{list(p.shape)} on {p.device}")


def _forward(x, scale, bias, eps, stats: bool):
    """The kernel's output (contiguous, ``x``'s shape and type) and, with
    ``stats``, each row's float32 mean and rstd."""
    c = x.shape[-1]
    n = x.numel() // c
    out = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean, rstd = torch.empty((2, n), dtype=torch.float32, device=x.device).unbind(0)
    if n == 0:
        return out, mean, rstd
    with torch.cuda.device(x.device):
        err = _fn("rein48_layer_norm_relu_forward")(
            x.data_ptr(), n, c, DTYPES[x.dtype], scale.data_ptr(), bias.data_ptr(), eps, out.data_ptr(),
            None if mean is None else mean.data_ptr(), None if rstd is None else rstd.data_ptr(), _stream(x.device))
    profiling.count("layer_norm.forward_launches")
    profiling.count("layer_norm.bound_bytes", n * (2 * c * x.element_size() + (STATS_BYTES if stats else 0)))
    _raise_on(err, "layer_norm_relu_forward")
    return out, mean, rstd


class _LayerNormReLU(torch.autograd.Function):
    """The kernel under autograd: the forward keeps the row statistics, the
    backward launches the rows and the partial-sum kernels."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        out, mean, rstd = _forward(x, scale, bias, eps, stats=True)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        c = x.shape[-1]
        n = x.numel() // c
        dx = torch.empty_like(x)
        # Two tensors, not views of one buffer: the parameters' gradients
        # share no storage, as autograd's own reductions give them.
        dscale, dbias = ((torch.empty if n else torch.zeros)(c, dtype=torch.float32, device=x.device) for _ in range(2))
        if n:
            dy = dy.contiguous()
            partials = torch.empty((MAX_CTAS, 2, c), dtype=torch.float32, device=x.device)
            with torch.cuda.device(x.device):
                err = _fn("rein48_layer_norm_relu_backward")(
                    x.data_ptr(), dy.data_ptr(), n, c, DTYPES[x.dtype], scale.data_ptr(), bias.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), partials.data_ptr(), dscale.data_ptr(),
                    dbias.data_ptr(), _stream(x.device))
            profiling.count("layer_norm.backward_launches")
            profiling.count("layer_norm.backward_sum_launches")
            profiling.count("layer_norm.bound_bytes", n * (3 * c * x.element_size() + STATS_BYTES))
            _raise_on(err, "layer_norm_relu_backward")
        return dx, dscale, dbias, None


def layer_norm_relu(x, scale, bias, eps: float = 1e-6) -> torch.Tensor:
    """``relu(LayerNorm(x))`` over the last axis, in ``x``'s type.

    On the card the kernel (one launch; the statistics kept for the
    backward only when autograd records), on the CPU the plain version.
    """
    _check(x, scale, bias)
    if x.device.type == "cpu":
        return F.relu(layer_norm_reference(x, scale, bias, eps, x.dtype))
    if x.device.type != "cuda":
        raise ValueError(f"no layer norm kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        return _LayerNormReLU.apply(x, scale, bias, eps)
    return _forward(x, scale, bias, eps, stats=False)[0]
