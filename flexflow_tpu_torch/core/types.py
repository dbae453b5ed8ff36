"""Core enums (port of ``flexflow_tpu/core/types.py``).

Only the members the ported slices use: float32 parameters, activations
and KV cache (the JAX default), bfloat16 parameters and activations for
training (``bench.py``'s BERT-Base cell), a bfloat16 or float16 KV cache
for serving (``CacheConfig.dtype``), int32 tokens, positions and
block tables, int64 for the sampler's emulated uint32 words, bool and
float64 for Cast; the op types of the BERT graphs with their heads, of
the seq2seq transformer, of the vision models (convolution, pooling,
BatchNorm, the elementwise unary and binary families), of NMT (RNN,
LSTM, batch matmul) and the recommenders, the reductions and the graph's
weight and no-op nodes, the parallel ops the strategy search writes
into a graph, and the activation, pooling, aggregation, loss, metric,
compilation and gradient-sync modes around them.
"""
from __future__ import annotations

import enum

import torch


class DataType(enum.Enum):
    """Tensor element types (reference: ffconst.h DataType)."""

    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    FLOAT = "float32"
    DOUBLE = "float64"

    @property
    def torch(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def size_bytes(self) -> int:
        return torch.empty((), dtype=self.torch).element_size()

    @classmethod
    def from_torch(cls, dtype: torch.dtype) -> "DataType":
        return cls(str(dtype).replace("torch.", ""))


class ActiMode(enum.Enum):
    """Fused activation modes (reference: ffconst.h ActiMode)."""

    NONE = "none"
    RELU = "relu"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    GELU = "gelu"


class PoolType(enum.Enum):
    """Pooling modes (reference: ffconst.h PoolType)."""

    MAX = "max"
    AVG = "avg"


class AggrMode(enum.Enum):
    """Embedding aggregation (reference: ffconst.h AggrMode)."""

    NONE = "none"
    SUM = "sum"
    AVG = "avg"


class LossType(enum.Enum):
    """Loss functions (reference: include/flexflow/loss_functions.h:27)."""

    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR = "mean_squared_error"
    MEAN_SQUARED_ERROR_AVG_REDUCE = "mean_squared_error_avg_reduce"
    MEAN_SQUARED_ERROR_SUM_REDUCE = "mean_squared_error_sum_reduce"
    IDENTITY = "identity"


class MetricsType(enum.Enum):
    """Metrics (reference: include/flexflow/metrics_functions.h:27)."""

    ACCURACY = "accuracy"
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR = "mean_squared_error"
    ROOT_MEAN_SQUARED_ERROR = "root_mean_squared_error"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"


class CompMode(enum.Enum):
    """Compilation mode (reference: ffconst.h:41-44)."""

    TRAINING = "training"
    INFERENCE = "inference"


class ParameterSyncType(enum.Enum):
    """Gradient sync strategy (reference: ffconst.h:46-50)."""

    NONE = "none"
    PS = "ps"
    NCCL = "allreduce"


class ParameterSyncOption(enum.Enum):
    """Per-parameter allreduce schedule (fork feature, ffconst.h:52-57):
    what the simulator and the allreduce-schedule pass
    (``search/simulator.py::allreduce_optimize``) choose between."""

    DEFAULT = "default"
    RING = "ring"
    BUTTERFLY = "butterfly"
    DOUBLE_BINARY_TREE = "double_binary_tree"


class OpType(enum.Enum):
    """The operators of the ported training graphs (values as in the JAX
    package, so node keys read the same in both)."""

    INPUT = "input"
    LINEAR = "linear"
    CONV2D = "conv2d"
    POOL2D = "pool2d"
    EMBEDDING = "embedding"
    MULTIHEAD_ATTENTION = "multihead_attention"
    LAYERNORM = "layer_norm"
    BATCHNORM = "batch_norm"
    # elementwise binary
    EW_ADD = "add"
    EW_SUB = "subtract"
    EW_MUL = "multiply"
    EW_DIV = "divide"
    EW_MAX = "max"
    EW_MIN = "min"
    # elementwise unary
    RELU = "relu"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    ELU = "elu"
    GELU = "gelu"
    IDENTITY = "identity"
    EXP = "exp"
    SIN = "sin"
    COS = "cos"
    RSQRT = "rsqrt"
    POW = "pow"
    SCALAR_ADD = "scalar_add"
    SCALAR_SUB = "scalar_sub"
    SCALAR_MUL = "scalar_multiply"
    SCALAR_TRUE_DIV = "scalar_true_div"
    FLAT = "flat"
    RESHAPE = "reshape"
    TRANSPOSE = "transpose"
    REVERSE = "reverse"
    CONCAT = "concat"
    SPLIT = "split"
    SOFTMAX = "softmax"
    DROPOUT = "dropout"
    CAST = "cast"
    # graph sources (reference: noop.cc; the weight node roots a tensor)
    WEIGHT = "weight"
    NOOP = "noop"
    BATCH_MATMUL = "batch_matmul"
    # reductions (reference: gather.cc, reduce.cc, mean.cc)
    GATHER = "gather"
    REDUCE_SUM = "reduce_sum"
    MEAN = "mean"
    # recurrent (reference: nmt/ LSTM/RNN via cudnnRNN)
    RNN = "rnn"
    LSTM = "lstm"
    # mixture of experts (reference: topk.cc, group_by.cc, aggregate.cc,
    # aggregate_spec.cc, cache.cc; EXPERTS is the batched expert FFN)
    TOPK = "topk"
    GROUP_BY = "group_by"
    AGGREGATE = "aggregate"
    AGGREGATE_SPEC = "aggregate_spec"
    CACHE = "cache"
    EXPERTS = "experts"
    FUSED = "fused"
    # parallel ops: sharding transitions the search writes into the graph
    # (reference: src/parallel_ops/; ops/parallel_ops.py)
    REPARTITION = "repartition"
    COMBINE = "combine"
    REPLICATE = "replicate"
    REDUCTION = "reduction"
    ALLREDUCE = "allreduce"
    FUSED_PARALLEL = "fused_parallel"
    PIPELINE = "pipeline"


PARALLEL_OP_TYPES = frozenset(
    {
        OpType.REPARTITION,
        OpType.COMBINE,
        OpType.REPLICATE,
        OpType.REDUCTION,
        OpType.ALLREDUCE,
        OpType.FUSED_PARALLEL,
        OpType.PIPELINE,
    }
)
