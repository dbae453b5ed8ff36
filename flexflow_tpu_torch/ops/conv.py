"""Convolution and pooling: Conv2D, Pool2D (port of
``flexflow_tpu/ops/conv.py``).

The JAX package computes these with ``lax.conv_general_dilated`` and
``lax.reduce_window``, outside any Pallas kernel; here they are
``torch.nn.functional``'s convolution and pooling (cuDNN on the card).
Layout is NCHW, weights OIHW, as in the JAX package. The convolution
accumulates in float32 and rounds once to the op's dtype, as
``preferred_element_type=float32`` then ``astype``: on the card cuDNN
accumulates a 2-byte convolution in float32; on the CPU a 2-byte
convolution runs on float32 copies (exact widenings) and is rounded
once. Max pooling pads with -inf; average pooling divides by the window's
real elements (``count_include_pad=False``); a 2-byte average pool adds
its window in the input's type, element by element, rounding each sum
as ``lax.reduce_window`` does.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn.functional as F

from ..core.tensor import TensorSpec
from ..core.types import ActiMode, DataType, OpType, PoolType
from .base import LowerCtx, OpCost, OpDef, WeightSpec, io_cost, register_op
from .elementwise import apply_activation


def _pad2(p):
    """Padding entry: int (symmetric) or (before, after) pair."""
    return (p, p) if isinstance(p, int) else tuple(p)


def _out_dim(size, kernel, stride, pad):
    lo, hi = _pad2(pad)
    out = (size + lo + hi - kernel) // stride + 1
    if out <= 0:
        raise ValueError(
            f"conv/pool output dim collapsed to {out}: input {size}, "
            f"kernel {kernel}, stride {stride}, padding {pad}"
        )
    return out


def _symmetric(padding, kernel=None):
    """``(ph, pw)`` when PyTorch's own padding can take ``padding`` (both
    sides equal and, for pooling, at most half the window), else None."""
    (ht, hb), (wl, wr) = _pad2(padding[0]), _pad2(padding[1])
    if ht != hb or wl != wr:
        return None
    if kernel is not None and (2 * ht > kernel[0] or 2 * wl > kernel[1]):
        return None
    return ht, wl


def _explicit_pad(x, padding, value):
    (ht, hb), (wl, wr) = _pad2(padding[0]), _pad2(padding[1])
    return F.pad(x, (wl, wr, ht, hb), value=value)


def _window_sum(x, kernel, stride):
    """Sums over the pooling windows of an already padded ``x``, one
    window position at a time in row-major order."""
    (kh, kw), (sh, sw) = kernel, stride
    oh, ow = (x.shape[2] - kh) // sh + 1, (x.shape[3] - kw) // sw + 1
    total = None
    for dy in range(kh):
        for dx in range(kw):
            v = x[:, :, dy:dy + sh * (oh - 1) + 1:sh, dx:dx + sw * (ow - 1) + 1:sw]
            total = v if total is None else total + v
    return total


@dataclasses.dataclass(frozen=True)
class Conv2DParams:
    out_channels: int
    kernel: tuple  # (kh, kw)
    stride: tuple  # (sh, sw)
    padding: tuple  # (ph, pw)
    groups: int = 1
    use_bias: bool = True
    activation: ActiMode = ActiMode.NONE
    dtype: DataType = DataType.FLOAT
    kernel_initializer: str = "glorot_uniform"


@register_op
class Conv2DOp(OpDef):
    op_type = OpType.CONV2D
    params_cls = Conv2DParams

    @staticmethod
    def infer_output_specs(params: Conv2DParams, input_specs: List[TensorSpec]):
        (x,) = input_specs
        n, c, h, w = x.shape
        oh = _out_dim(h, params.kernel[0], params.stride[0], params.padding[0])
        ow = _out_dim(w, params.kernel[1], params.stride[1], params.padding[1])
        return [TensorSpec((n, params.out_channels, oh, ow), params.dtype)]

    @staticmethod
    def weight_specs(params: Conv2DParams, input_specs: List[TensorSpec]) -> List[WeightSpec]:
        (x,) = input_specs
        cin = x.shape[1]
        ws = [
            WeightSpec(
                "kernel",
                TensorSpec((params.out_channels, cin // params.groups) + tuple(params.kernel),
                           params.dtype),
                params.kernel_initializer,
            )
        ]
        if params.use_bias:
            ws.append(WeightSpec("bias", TensorSpec((params.out_channels,), params.dtype), "zeros"))
        return ws

    @staticmethod
    def lower(params: Conv2DParams, inputs, weights, ctx: LowerCtx):
        (x,) = inputs
        w = weights["kernel"]
        dtype = params.dtype.torch
        if x.device.type == "cpu" and dtype in (torch.bfloat16, torch.float16):
            x, w = x.float(), w.float()
        pad = _symmetric(params.padding)
        if pad is None:
            x, pad = _explicit_pad(x, params.padding, 0.0), (0, 0)
        y = F.conv2d(x, w, stride=tuple(params.stride), padding=pad,
                     groups=params.groups).to(dtype)
        if params.use_bias:
            y = y + weights["bias"].reshape(1, -1, 1, 1)
        return [apply_activation(params.activation, y)]

    @staticmethod
    def cost(params: Conv2DParams, input_specs, output_specs) -> OpCost:
        (x,) = input_specs
        (y,) = output_specs
        cin = x.shape[1]
        flops = 2.0 * y.num_elements * (cin // params.groups) * params.kernel[0] * params.kernel[1]
        w_bytes = (params.out_channels * (cin // params.groups) * params.kernel[0]
                   * params.kernel[1] * params.dtype.size_bytes)
        c = io_cost(input_specs, output_specs, flops=flops, extra_mem=w_bytes)
        c.bytes_accessed += w_bytes
        return c


@dataclasses.dataclass(frozen=True)
class Pool2DParams:
    kernel: tuple
    stride: tuple
    padding: tuple
    pool_type: PoolType = PoolType.MAX
    activation: ActiMode = ActiMode.NONE


@register_op
class Pool2DOp(OpDef):
    op_type = OpType.POOL2D
    params_cls = Pool2DParams

    @staticmethod
    def infer_output_specs(params: Pool2DParams, input_specs: List[TensorSpec]):
        (x,) = input_specs
        n, c, h, w = x.shape
        oh = _out_dim(h, params.kernel[0], params.stride[0], params.padding[0])
        ow = _out_dim(w, params.kernel[1], params.stride[1], params.padding[1])
        return [TensorSpec((n, c, oh, ow), x.dtype)]

    @staticmethod
    def lower(params: Pool2DParams, inputs, weights, ctx):
        (x,) = inputs
        k, s = tuple(params.kernel), tuple(params.stride)
        pad = _symmetric(params.padding, k)
        if params.pool_type == PoolType.MAX:
            if pad is None:
                x, pad = _explicit_pad(x, params.padding, float("-inf")), (0, 0)
            y = F.max_pool2d(x, k, s, pad)
        elif pad is not None and x.dtype == torch.float32:
            y = F.avg_pool2d(x, k, s, pad, count_include_pad=False)
        else:
            # the window sum over zero padding, added element by element in
            # the input's type as lax.reduce_window adds (a 2-byte sum is
            # rounded at each addition), divided by the window's real elements
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
            y = (_window_sum(_explicit_pad(x, params.padding, 0.0), k, s)
                 / _window_sum(_explicit_pad(ones, params.padding, 0.0), k, s))
        return [apply_activation(params.activation, y)]

    @staticmethod
    def cost(params: Pool2DParams, input_specs, output_specs) -> OpCost:
        k = params.kernel[0] * params.kernel[1]
        return io_cost(input_specs, output_specs, flops=float(k) * output_specs[0].num_elements)
