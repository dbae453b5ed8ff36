"""The onnx and fx phases of ``chip_smoke.py`` by themselves, and the
ONNX graph both of them (and the CPU tests) build.

    PYTHONPATH=. python3 <this file> [--seed N] [--phases onnx,fx]

``bert_onnx_graph`` writes a BERT encoder as onnxruntime's transformer
fusion leaves it, as a ModelProto-shaped object (the ``onnx`` package is
not needed): ids -> ``Gather`` of the word table -> ``LayerNormalization``
-> per layer [com.microsoft ``Attention`` (packed qkv weight and bias) ->
``MatMul`` -> ``Add`` (residual) -> ``LayerNormalization`` -> ``MatMul``
-> ``Gelu`` -> ``MatMul`` -> ``Add`` -> ``LayerNormalization``] ->
``Gather`` (axis 1, index 0: the CLS row) -> ``MatMul`` (``logits``) ->
``Softmax`` (``probs``). Weights are drawn from ``numpy.random.
RandomState(seed)`` at BERT's init std 0.02, LayerNorm scales at 1.

``main`` builds the kernels, then runs ``chip_smoke.onnx_phase`` (the
graph at BERT-Base width served over HTTP through the flash forward) and
``chip_smoke.fx_phase`` (an HF-style BERT-Base imported by torch.fx and
trained), with every gate, or the ``--phases`` named. Prints the card's
name and power limit first. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List

import numpy as np

PHASES = ("onnx", "fx")
# AttributeProto types
_INT, _FLOAT = 2, 1


@dataclasses.dataclass
class Attr:
    """An AttributeProto of ``type`` 1 (FLOAT, in ``f``) or 2 (INT, in ``i``)."""

    name: str
    type: int
    i: int = 0
    f: float = 0.0


@dataclasses.dataclass
class Node:
    op_type: str
    input: List[str]
    output: List[str]
    name: str = ""
    attribute: List[Attr] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ValueInfo:
    name: str


@dataclasses.dataclass
class Init:
    """An initializer: ``numpy`` holds its value."""

    name: str
    numpy: np.ndarray


@dataclasses.dataclass
class Graph:
    node: List[Node]
    input: List[ValueInfo]
    output: List[ValueInfo]
    initializer: List[Init]


@dataclasses.dataclass
class Model:
    graph: Graph


def bert_onnx_graph(seed: int, vocab: int, layers: int, hidden: int, heads: int, ff: int,
                    classes: int = 2, std: float = 0.02, eps: float = 1e-12) -> Model:
    """The fused BERT encoder with a CLS head; graph input ``ids``,
    outputs ``logits`` and ``probs``."""
    rs = np.random.RandomState(seed)
    inits: List[Init] = []

    def w(name, *shape):
        inits.append(Init(name, (rs.standard_normal(shape) * std).astype(np.float32)))
        return name

    def ones(name, n):
        inits.append(Init(name, np.ones(n, np.float32)))
        return name

    def zeros(name, n):
        inits.append(Init(name, np.zeros(n, np.float32)))
        return name

    def ln(x, out, tag):
        return Node("LayerNormalization", [x, ones(f"{tag}.scale", hidden), zeros(f"{tag}.bias", hidden)],
                    [out], tag, [Attr("axis", _INT, i=-1), Attr("epsilon", _FLOAT, f=eps)])

    nodes = [Node("Gather", [w("word_embeddings", vocab, hidden), "ids"], ["emb"], "embed",
                  [Attr("axis", _INT, i=0)]),
             ln("emb", "h0", "embed_ln")]
    x = "h0"
    for i in range(layers):
        p = f"layer{i}"
        nodes += [
            Node("Attention", [x, w(f"{p}.qkv", hidden, 3 * hidden), w(f"{p}.qkv_bias", 3 * hidden)],
                 [f"{p}.ctx"], f"{p}.attention", [Attr("num_heads", _INT, i=heads)]),
            Node("MatMul", [f"{p}.ctx", w(f"{p}.out", hidden, hidden)], [f"{p}.attn"],
                 f"{p}.attn_out"),
            Node("Add", [f"{p}.attn", x], [f"{p}.res1"], f"{p}.res1"),
            ln(f"{p}.res1", f"{p}.h1", f"{p}.ln1"),
            Node("MatMul", [f"{p}.h1", w(f"{p}.fc1", hidden, ff)], [f"{p}.f1"], f"{p}.fc1"),
            Node("Gelu", [f"{p}.f1"], [f"{p}.g"], f"{p}.gelu"),
            Node("MatMul", [f"{p}.g", w(f"{p}.fc2", ff, hidden)], [f"{p}.f2"], f"{p}.fc2"),
            Node("Add", [f"{p}.f2", f"{p}.h1"], [f"{p}.res2"], f"{p}.res2"),
            ln(f"{p}.res2", f"{p}.h2", f"{p}.ln2"),
        ]
        x = f"{p}.h2"
    inits.append(Init("cls_index", np.array(0, np.int64)))
    nodes += [
        Node("Gather", [x, "cls_index"], ["cls"], "cls", [Attr("axis", _INT, i=1)]),
        Node("MatMul", ["cls", w("classifier", hidden, classes)], ["logits"], "classifier"),
        Node("Softmax", ["logits"], ["probs"], "probs", [Attr("axis", _INT, i=-1)]),
    ]
    return Model(Graph(nodes, [ValueInfo("ids")], [ValueInfo("logits"), ValueInfo("probs")], inits))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES), help=f"comma-separated, of {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        ap.error(f"--phases takes {PHASES}")

    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("frontend_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    # as chip_smoke.py: full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    out = {}
    t0 = time.perf_counter()
    if "onnx" in phases:
        out["onnx"] = cs.onnx_phase(args.seed)
    if "fx" in phases:
        out["fx"] = cs.fx_phase(args.seed)
    out["phases_s"] = time.perf_counter() - t0
    cs.print_frontends(card, out.get("onnx"), out.get("fx"))
    print(json.dumps({"card": card, **out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
