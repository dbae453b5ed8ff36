"""Graph JSON between the packages: a graph written by either package's
``PCGraph.to_json`` is read by the other's ``from_json`` with the same
guids, names, op types, params and edges, and written back as the same
text (the model repository's ``graph.json``)."""
import json

import pytest

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.graph import PCGraph as JPCGraph
from flexflow_tpu.core.types import AggrMode as JAggrMode
from flexflow_tpu.core.types import DataType as JDataType
from flexflow_tpu.model import FFModel as JFFModel
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.models.transformer import build_transformer_seq2seq as jbuild_seq2seq
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.core.types import AggrMode, DataType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models import TransformerConfig, build_transformer
from flexflow_tpu_torch.models import build_transformer_seq2seq

pytestmark = pytest.mark.torch_port

KW = dict(num_layers=2, hidden_size=32, num_heads=2, ff_size=64, seq_length=8, dropout=0.1)


def _zoo(ff, dt, aggr):
    """Every shape op, the embedding modes and a cast, on one graph."""
    tok = ff.create_tensor((4, 6), dt.INT32, name="tok")
    bag = ff.embedding(tok, 20, 8, aggr=aggr.SUM, name="bag_sum")
    avg = ff.embedding(tok, 20, 8, aggr=aggr.AVG, name="bag_avg")
    seq = ff.embedding(tok, 20, 8, datatype=dt.BFLOAT16, name="seq")
    t = ff.cast(seq, dt.FLOAT, name="up")
    t = ff.transpose(t, (0, 2, 1), name="tr")
    t = ff.reverse(t, 1, name="rev")
    a, b = ff.split(t, [3, 5], axis=1, name="sp")
    t = ff.concat([b, a], axis=1, name="cat")
    t = ff.flat(t, name="fl")
    ff.reshape(t, (4, 8, -1), name="rs")
    t = ff.dense(ff.concat([bag, avg], axis=1, name="bags"), 16, activation="relu", name="fc")
    return ff.softmax(ff.dropout(t, 0.2, name="drop"), name="sm")


def _jax_graph(kind):
    jc = JFFConfig(batch_size=4, workers_per_node=1)
    if kind == "bert_cls":
        return jbuild_transformer(jc, JTransformerConfig(**KW, vocab_size=50, num_classes=2)).graph
    if kind == "bert_mlm":
        return jbuild_transformer(jc, JTransformerConfig(**KW, vocab_size=50)).graph
    if kind == "seq2seq":
        return jbuild_seq2seq(jc, JTransformerConfig(**KW, vocab_size=40), num_decoder_layers=1,
                              src_seq_length=12).graph
    ff = JFFModel(jc)
    _zoo(ff, JDataType, JAggrMode)
    return ff.graph


def _port_graph(kind):
    c = FFConfig(batch_size=4)
    if kind == "bert_cls":
        return build_transformer(c, TransformerConfig(**KW, vocab_size=50, num_classes=2),
                                 device="cpu").graph
    if kind == "bert_mlm":
        return build_transformer(c, TransformerConfig(**KW, vocab_size=50), device="cpu").graph
    if kind == "seq2seq":
        return build_transformer_seq2seq(c, TransformerConfig(**KW, vocab_size=40),
                                         num_decoder_layers=1, src_seq_length=12,
                                         device="cpu").graph
    ff = FFModel(c, device="cpu")
    _zoo(ff, DataType, AggrMode)
    return ff.graph


def _summary(graph):
    """guid -> (name, op type value, params as JSON data), and the edges."""
    d = json.loads(graph.to_json())
    return ({n["guid"]: (n["name"], n["op_type"], n["params"]) for n in d["nodes"]},
            sorted(tuple(sorted(e.items())) for e in d["edges"]))


KINDS = ["bert_cls", "bert_mlm", "seq2seq", "shape_ops"]


@pytest.mark.parametrize("kind", KINDS)
def test_jax_graph_reads_in_the_port(kind):
    jg = _jax_graph(kind)
    text = jg.to_json()
    pg = PCGraph.from_json(text)
    assert pg.to_json() == text
    assert set(pg.nodes) == set(jg.nodes)
    for guid, jn in jg.nodes.items():
        pn = pg.nodes[guid]
        assert (pn.name, pn.op_type.value) == (jn.name, jn.op_type.value)
        assert type(pn.params).__name__ == type(jn.params).__name__
        assert [e.src for e in pg.in_edges(guid)] == [e.src for e in jg.in_edges(guid)]


@pytest.mark.parametrize("kind", KINDS)
def test_port_graph_reads_in_jax(kind):
    pg = _port_graph(kind)
    text = pg.to_json()
    jg = JPCGraph.from_json(text)
    assert jg.to_json() == text
    assert _summary(jg) == _summary(pg)


@pytest.mark.parametrize("kind", KINDS)
def test_both_builders_write_the_same_graph_but_guids(kind):
    """The port's builders make the JAX package's graphs: the same nodes
    in the same order with the same names, op types and params."""
    (jn, je), (pn, pe) = _summary(_jax_graph(kind)), _summary(_port_graph(kind))
    jl, pl = sorted(jn.items()), sorted(pn.items())
    assert [v for _, v in jl] == [v for _, v in pl]
    assert len(je) == len(pe)
