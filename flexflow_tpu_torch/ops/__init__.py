"""Operators of the port: the training graphs' ops (registered on
import: the BERT encoder, its heads and dropout, the seq2seq decoder's,
the shape ops, the vision models' convolution, pooling, BatchNorm and
elementwise families, NMT's recurrent ops and batch matmul, the
reductions, the weight and no-op nodes, the mixture-of-experts family,
the parallel ops the strategy search writes into a graph)
and the generation path's attention."""
from . import (  # noqa: F401 (registers the ops)
    attention,
    batch_matmul,
    conv,
    elementwise,
    embedding,
    io_ops,
    linear,
    moe_ops,
    norm,
    parallel_ops,
    recurrent,
    reduction_ops,
    shape_ops,
    softmax,
)
from .base import (
    LowerCtx,
    OpCost,
    OpDef,
    WeightSpec,
    get_op_def,
    io_cost,
    register_op,
    registered_ops,
)

__all__ = ["LowerCtx", "OpCost", "OpDef", "WeightSpec", "get_op_def", "io_cost", "register_op",
           "registered_ops"]
