"""Recurrent operators: Elman RNN and LSTM (port of
``flexflow_tpu/ops/recurrent.py``).

The input part of every timestep is one product, ``einsum("btd,dh->tbh",
x, wx) + bias``; only the hidden recurrence runs over time, as the JAX
package's ``lax.scan`` does. Each step's recurrent product accumulates
in float32 and is cast to the step's dtype (``preferred_element_type=
float32`` in JAX). The ops are plain PyTorch ops in JAX's order, so a
2-byte step rounds where JAX's does; no ``torch.nn.LSTM`` (cuDNN's RNN
orders its sums otherwise). On the card the step's Python loop issues
every timestep's ops; a captured CUDA graph of the training step
(``Executor.train_window``) replays them as one launch.

Layout: sequences are batch-first [B, T, D], hidden states [B, H]. RNN
emits (sequence, h_T), LSTM (sequence, h_T, c_T), so an encoder's final
states can start a decoder (the optional inputs h0[, c0]). LSTM gates
are (i, f, g, o) with a forget bias of 1.0.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..core.tensor import TensorSpec
from ..core.types import ActiMode, DataType, OpType
from .base import LowerCtx, OpCost, OpDef, WeightSpec, io_cost, register_op
from .elementwise import _sigmoid, _weak, apply_activation
from .linear import promoted


@dataclasses.dataclass(frozen=True)
class RecurrentParams:
    hidden_size: int
    dtype: DataType = DataType.FLOAT
    activation: ActiMode = ActiMode.TANH  # RNN cell nonlinearity
    kernel_initializer: str = "glorot_uniform"


def _input_projection(x: torch.Tensor, wx: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """[T, B, G]: every timestep's ``x_t @ wx + bias`` in one product."""
    return torch.einsum("btd,dg->tbg", *promoted(x, wx)) + bias


def _recurrent(h: torch.Tensor, wh: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``jnp.dot(h, wh, preferred_element_type=float32).astype(dtype)``."""
    return torch.matmul(*promoted(h, wh)).to(dtype)


@register_op
class RNNOp(OpDef):
    """Elman RNN: h_t = act(x_t @ Wx + h_{t-1} @ Wh + b)."""

    op_type = OpType.RNN
    params_cls = RecurrentParams

    @staticmethod
    def infer_output_specs(params: RecurrentParams, input_specs: List[TensorSpec]):
        x = input_specs[0]
        b, t = x.shape[0], x.shape[1]
        h = params.hidden_size
        return [TensorSpec((b, t, h), params.dtype), TensorSpec((b, h), params.dtype)]

    @staticmethod
    def weight_specs(params: RecurrentParams, input_specs: List[TensorSpec]):
        d, h = input_specs[0].shape[-1], params.hidden_size
        init = params.kernel_initializer
        return [
            WeightSpec("wx", TensorSpec((d, h), params.dtype), init),
            WeightSpec("wh", TensorSpec((h, h), params.dtype), "orthogonal"),
            WeightSpec("bias", TensorSpec((h,), params.dtype), "zeros"),
        ]

    @staticmethod
    def lower(params: RecurrentParams, inputs, weights, ctx: LowerCtx):
        x = inputs[0]
        xp = _input_projection(x, weights["wx"], weights["bias"])
        h = inputs[1] if len(inputs) > 1 else xp.new_zeros((x.shape[0], params.hidden_size))
        ys = []
        for t in range(xp.shape[0]):
            h = apply_activation(params.activation, xp[t] + _recurrent(h, weights["wh"], xp.dtype))
            ys.append(h)
        return [torch.stack(ys, dim=1), h]

    @staticmethod
    def cost(params: RecurrentParams, input_specs, output_specs) -> OpCost:
        x = input_specs[0]
        b, t, d = x.shape[0], x.shape[1], x.shape[-1]
        h = params.hidden_size
        flops = 2.0 * b * t * (d * h + h * h)
        w_bytes = (d * h + h * h + h) * params.dtype.size_bytes
        c = io_cost(input_specs, output_specs, flops=flops, extra_mem=w_bytes)
        c.bytes_accessed += w_bytes + t * b * h * params.dtype.size_bytes
        return c


@register_op
class LSTMOp(OpDef):
    """LSTM with fused gates (i, f, g, o), forget bias 1.0
    (reference: nmt/lstm.cc's cudnnRNN LSTM mode)."""

    op_type = OpType.LSTM
    params_cls = RecurrentParams

    @staticmethod
    def infer_output_specs(params: RecurrentParams, input_specs: List[TensorSpec]):
        x = input_specs[0]
        b, t = x.shape[0], x.shape[1]
        h = params.hidden_size
        return [TensorSpec((b, t, h), params.dtype), TensorSpec((b, h), params.dtype),
                TensorSpec((b, h), params.dtype)]

    @staticmethod
    def weight_specs(params: RecurrentParams, input_specs: List[TensorSpec]):
        d, h = input_specs[0].shape[-1], params.hidden_size
        init = params.kernel_initializer
        return [
            WeightSpec("wx", TensorSpec((d, 4 * h), params.dtype), init),
            WeightSpec("wh", TensorSpec((h, 4 * h), params.dtype), "orthogonal"),
            WeightSpec("bias", TensorSpec((4 * h,), params.dtype), "zeros"),
        ]

    @staticmethod
    def lower(params: RecurrentParams, inputs, weights, ctx: LowerCtx):
        x = inputs[0]
        xp = _input_projection(x, weights["wx"], weights["bias"])
        zeros = xp.new_zeros((x.shape[0], params.hidden_size))
        h = inputs[1] if len(inputs) > 1 else zeros
        c = inputs[2] if len(inputs) > 2 else zeros
        one = _weak(1.0, xp)
        ys = []
        for t in range(xp.shape[0]):
            gates = xp[t] + _recurrent(h, weights["wh"], xp.dtype)
            i, f, g, o = gates.chunk(4, dim=-1)
            i = _sigmoid(i)
            f = _sigmoid(f + one)  # forget-gate bias 1.0
            g = torch.tanh(g)
            o = _sigmoid(o)
            c = f * c + i * g
            h = o * torch.tanh(c)
            ys.append(h)
        return [torch.stack(ys, dim=1), h, c]

    @staticmethod
    def cost(params: RecurrentParams, input_specs, output_specs) -> OpCost:
        x = input_specs[0]
        b, t, d = x.shape[0], x.shape[1], x.shape[-1]
        h = params.hidden_size
        flops = 2.0 * b * t * 4 * (d * h + h * h)
        w_bytes = (d * 4 * h + h * 4 * h + 4 * h) * params.dtype.size_bytes
        c = io_cost(input_specs, output_specs, flops=flops, extra_mem=w_bytes)
        c.bytes_accessed += w_bytes + t * b * h * params.dtype.size_bytes
        return c
