"""Recommender models: DLRM, XDL, candle_uno, MLP_Unify (port of
``flexflow_tpu/models/recommender.py``, with its names, defaults and
layer names; each runs on the GPU unless ``device="cpu"``).

Reference: examples/cpp/DLRM/dlrm.cc (sparse embedding bags + bottom/top
MLPs + pairwise-dot feature interaction, attribute-parallel embedding
strategy files), examples/cpp/XDL/xdl.cc, examples/cpp/candle_uno/
candle_uno.cc (multi-input dense towers), examples/cpp/MLP_Unify/
mlp.cc.
"""
from __future__ import annotations

from typing import Sequence

from ..config import FFConfig
from ..core.types import ActiMode, AggrMode, DataType
from ..model import FFModel


def build_mlp_unify(config: FFConfig, in_dim: int = 1024,
                    hidden: Sequence[int] = (4096, 4096, 4096, 1024), device=None) -> FFModel:
    """Reference: examples/cpp/MLP_Unify/mlp.cc."""
    model = FFModel(config, device=device)
    x = model.create_tensor((config.batch_size, in_dim), name="input")
    t = x
    for i, h in enumerate(hidden):
        t = model.dense(t, h, ActiMode.RELU, name=f"fc{i}")
    model.softmax(t, name="softmax")
    return model


def build_dlrm(
    config: FFConfig,
    embedding_sizes: Sequence[int] = (1000000,) * 8,
    embedding_dim: int = 64,
    embedding_bag_size: int = 1,
    dense_dim: int = 64,
    bottom_mlp: Sequence[int] = (512, 256, 64),
    top_mlp: Sequence[int] = (512, 256, 1),
    device=None,
) -> FFModel:
    """Reference: examples/cpp/DLRM/dlrm.cc — per-table SUM-aggregated
    embedding bags; interaction = concat (the reference's
    interop_dot path is concat in dlrm.cc's default strategy)."""
    model = FFModel(config, device=device)
    b = config.batch_size
    # sparse inputs: one [B, bag] int tensor per table
    sparse = [
        model.create_tensor((b, embedding_bag_size), DataType.INT32, name=f"sparse{i}")
        for i in range(len(embedding_sizes))
    ]
    dense_in = model.create_tensor((b, dense_dim), name="dense")
    embeds = [
        model.embedding(s, n, embedding_dim, AggrMode.SUM, name=f"embed{i}")
        for i, (s, n) in enumerate(zip(sparse, embedding_sizes))
    ]
    t = dense_in
    for i, h in enumerate(bottom_mlp):
        t = model.dense(t, h, ActiMode.RELU, name=f"bot{i}")
    t = model.concat(embeds + [t], axis=1, name="interact")
    for i, h in enumerate(top_mlp[:-1]):
        t = model.dense(t, h, ActiMode.RELU, name=f"top{i}")
    t = model.dense(t, top_mlp[-1], name="top_out")
    model.sigmoid(t, name="sigmoid")
    return model


def build_xdl(
    config: FFConfig,
    embedding_sizes: Sequence[int] = (1000000,) * 8,
    embedding_dim: int = 16,
    dense_dim: int = 16,
    mlp: Sequence[int] = (512, 256, 128, 1),
    device=None,
) -> FFModel:
    """Reference: examples/cpp/XDL/xdl.cc — sparse embeddings + deep MLP."""
    model = FFModel(config, device=device)
    b = config.batch_size
    sparse = [
        model.create_tensor((b, 1), DataType.INT32, name=f"sparse{i}")
        for i in range(len(embedding_sizes))
    ]
    dense_in = model.create_tensor((b, dense_dim), name="dense")
    embeds = [
        model.embedding(s, n, embedding_dim, AggrMode.SUM, name=f"embed{i}")
        for i, (s, n) in enumerate(zip(sparse, embedding_sizes))
    ]
    t = model.concat(embeds + [dense_in], axis=1, name="concat")
    for i, h in enumerate(mlp[:-1]):
        t = model.dense(t, h, ActiMode.RELU, name=f"fc{i}")
    t = model.dense(t, mlp[-1], name="out")
    model.sigmoid(t, name="sigmoid")
    return model


def build_candle_uno(
    config: FFConfig,
    input_dims: Sequence[int] = (942, 5270, 2048),
    feature_layers: Sequence[int] = (1000, 1000, 1000),
    top_layers: Sequence[int] = (1000, 1000, 1000, 1),
    device=None,
) -> FFModel:
    """Reference: examples/cpp/candle_uno/candle_uno.cc — per-input
    feature towers concatenated into a regression head."""
    model = FFModel(config, device=device)
    b = config.batch_size
    towers = []
    for i, d in enumerate(input_dims):
        t = model.create_tensor((b, d), name=f"input{i}")
        for j, h in enumerate(feature_layers):
            t = model.dense(t, h, ActiMode.RELU, name=f"tower{i}_fc{j}")
        towers.append(t)
    t = model.concat(towers, axis=1, name="concat")
    for j, h in enumerate(top_layers[:-1]):
        t = model.dense(t, h, ActiMode.RELU, name=f"top{j}")
    model.dense(t, top_layers[-1], name="out")
    return model
