"""Keras-style Sequential and functional Model (port of
``flexflow_tpu/frontends/keras/models.py``).

Reference: python/flexflow/keras/models/base_model.py:31 (BaseModel:
compile :128, fit :198, evaluate :260, summary :106), sequential.py:23,
model.py:23. The first fit, evaluate or predict at a batch size replays
the symbolic layer DAG into an FFModel and compiles it on one device
(``compile(..., device=)``: None is the GPU); a rebuild at another batch
size carries the weights and the optimizer state over by layer name.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ...config import FFConfig
from ...core.types import LossType, MetricsType
from ...model import FFModel
from ...runtime.executor import node_key as _node_key
from .layers import InputLayer, Layer
from .losses import Loss, _LOSS_BY_NAME
from .metrics import Metric, _METRIC_BY_NAME
from .optimizers import Optimizer
from .tensor import KerasTensor


def _to_loss_type(loss) -> LossType:
    if isinstance(loss, LossType):
        return loss
    if isinstance(loss, Loss):
        return loss.loss_type
    return _LOSS_BY_NAME[loss].loss_type


def _to_metric_types(metrics) -> List[MetricsType]:
    out = []
    for m in metrics or ():
        if isinstance(m, MetricsType):
            out.append(m)
        elif isinstance(m, Metric):
            out.append(m.metrics_type)
        else:
            out.append(_METRIC_BY_NAME[m].metrics_type)
    return out


class BaseModel:
    """Reference: base_model.py:31."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__.lower()
        self.ffmodel: Optional[FFModel] = None
        self.ffconfig: Optional[FFConfig] = None
        self.optimizer: Optional[Optimizer] = None
        self.loss_type: Optional[LossType] = None
        self.metric_types: List[MetricsType] = []
        self._layers: List[Layer] = []
        self._compiled_batch_size: Optional[int] = None
        self.device = None

    @property
    def layers(self) -> List[Layer]:
        return [l for l in self._layers if not isinstance(l, InputLayer)]

    # -- to be provided by subclasses --------------------------------
    def _topo_layers(self) -> List[Layer]:
        raise NotImplementedError

    # -- compile ------------------------------------------------------
    def compile(self, optimizer, loss=None, loss_weights=None, metrics=None,
                config: Optional[FFConfig] = None, device=None, **kw):
        if isinstance(optimizer, str):
            from .optimizers import SGD, Adam

            optimizer = {"sgd": SGD(), "adam": Adam()}[optimizer.lower()]
        self.optimizer = optimizer
        self.loss_type = _to_loss_type(loss) if loss is not None else None
        self.metric_types = _to_metric_types(metrics)
        self.ffconfig = config or FFConfig()
        self._layers = self._topo_layers()
        self.device = device
        self._compiled_batch_size = None  # built lazily on first fit/predict

    def _build(self, batch_size: int):
        """Replay the symbolic DAG into a fresh FFModel at this batch size.

        Weights (and optimizer state) carry over from a previously built
        executor by stable layer name, so changing batch size between fit
        and predict does not discard training progress.
        """
        old = self.ffmodel if self.ffmodel is not None and self.ffmodel.executor is not None else None
        self.ffconfig.batch_size = batch_size
        ffmodel = FFModel(self.ffconfig, device=self.device)
        tensor_map: Dict[int, object] = {}  # id(KerasTensor) -> ff Tensor
        for layer in self._layers:
            ff_ins = [tensor_map[id(t)] for t in layer.inbound]
            ff_outs = layer.build_ff(ffmodel, ff_ins)
            for kt, ft in zip(layer.outbound, ff_outs):
                tensor_map[id(kt)] = ft
        outputs = [tensor_map[id(t)] for t in self._output_tensors()]
        ffmodel.compile(
            optimizer=self.optimizer.to_ff() if isinstance(self.optimizer, Optimizer) else self.optimizer,
            loss_type=self.loss_type,
            metrics=self.metric_types,
            outputs=outputs,
        )
        if old is not None:
            _transfer_state(old, ffmodel)
        self.ffmodel = ffmodel
        self._compiled_batch_size = batch_size

    def _output_tensors(self) -> List[KerasTensor]:
        raise NotImplementedError

    def _ensure_built(self, batch_size: int):
        if self.ffmodel is None or self._compiled_batch_size != batch_size:
            self._build(batch_size)

    # -- training loop ------------------------------------------------
    def fit(self, x, y, epochs=1, batch_size=None, callbacks=None, verbose=True):
        assert self.optimizer is not None, "call compile() first"
        bs = batch_size or self.ffconfig.batch_size
        self._ensure_built(bs)
        callbacks = list(callbacks or [])
        for cb in callbacks:
            cb.set_model(self)
            cb.on_train_begin()
        history = []
        for epoch in range(epochs):
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            perf = self.ffmodel.fit(x, y, epochs=1, batch_size=bs, verbose=verbose)
            history.append(perf)
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs=perf)
        for cb in callbacks:
            cb.on_train_end()
        return history

    def evaluate(self, x, y, batch_size=None):
        bs = batch_size or self.ffconfig.batch_size
        self._ensure_built(bs)
        return self.ffmodel.evaluate(x, y, batch_size=bs)

    def predict(self, x, batch_size=None):
        if isinstance(x, (list, tuple)):
            n = x[0].shape[0]
        else:
            n = x.shape[0]
        self._ensure_built(batch_size or n)
        return self.ffmodel.predict(x).detach().cpu().numpy()

    def set_learning_rate(self, lr: float):
        if self.ffmodel is not None and self.ffmodel.executor is not None:
            self.ffmodel.executor.set_learning_rate(lr)
        if self.optimizer is not None:
            self.optimizer.lr = lr

    def get_layer_weights(self, name: str):
        ex = self.ffmodel.executor
        out = {}
        for node in self.ffmodel.graph.nodes.values():
            if node.name == name:
                for wname, arr in ex.params.get(_node_key(node), {}).items():
                    out[wname] = arr.detach().float().cpu().numpy()
        return out

    def summary(self, print_fn=print):
        """Reference: base_model.py:106."""
        lines = [f'Model: "{self.name}"', "_" * 65]
        lines.append(f"{'Layer (type)':<30}{'Output Shape':<25}{'#in'}")
        lines.append("=" * 65)
        for l in self._layers:
            shape = l.outbound[0].batch_shape if l.outbound else "?"
            lines.append(f"{l.name + ' (' + type(l).__name__ + ')':<30}{str(shape):<25}{len(l.inbound)}")
        lines.append("=" * 65)
        for ln in lines:
            print_fn(ln)


@torch.no_grad()
def _transfer_state(old_model: FFModel, new_model: FFModel) -> None:
    """Copy trained weights + optimizer state between two builds of the
    same layer DAG, matching nodes by stable layer name (guids are from a
    global counter and differ across rebuilds). Copied into the new
    executor's own tensors."""
    old_ex, new_ex = old_model.executor, new_model.executor
    old_by_name = {n.name: _node_key(n) for n in old_model.graph.nodes.values() if n.name}
    mapping = {}  # new key -> (new guid, old key)
    for node in new_model.graph.nodes.values():
        ok = old_by_name.get(node.name)
        if ok is not None:
            mapping[_node_key(node)] = (node.guid, ok)
    for nk, (guid, ok) in mapping.items():
        if ok in old_ex.params and nk in new_ex.params:
            for wname, arr in old_ex.params[ok].items():
                new_ex.params[nk][wname].copy_(arr)
    if old_ex.opt_state and new_ex.opt_state:
        for field in ("v", "m"):
            ov, nv = old_ex.opt_state.get(field), new_ex.opt_state.get(field)
            if isinstance(ov, dict) and isinstance(nv, dict):
                for nk, (_, ok) in mapping.items():
                    if ok in ov and nk in nv:
                        for wname, arr in ov[ok].items():
                            nv[nk][wname].copy_(arr)
        if "step" in old_ex.opt_state:
            new_ex.opt_state["step"] = old_ex.opt_state["step"]
        if "lr" in old_ex.opt_state:
            new_ex.opt_state["lr"].copy_(old_ex.opt_state["lr"])


class Sequential(BaseModel):
    """Reference: sequential.py:23."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None, name=None):
        super().__init__(name=name or "sequential")
        self._added: List[Layer] = []
        for l in layers or ():
            self.add(l)

    def add(self, layer: Layer):
        self._added.append(layer)

    def pop(self):
        self._added.pop()

    def _topo_layers(self) -> List[Layer]:
        # Wire the chain symbolically (supports input_shape on first layer
        # or an explicit InputLayer, as in the reference)
        layers = list(self._added)
        if not layers:
            raise ValueError("empty Sequential")
        if not isinstance(layers[0], InputLayer):
            shape = layers[0].input_shape_arg
            assert shape is not None, "first layer needs input_shape= or use InputLayer"
            layers.insert(0, InputLayer(shape=shape))
        cur = layers[0].outbound[0]
        for l in layers[1:]:
            cur = l(cur)
        self._out = cur
        return layers

    def _output_tensors(self):
        return [self._out]


class Model(BaseModel):
    """Functional model (reference: model.py:23)."""

    def __init__(self, inputs, outputs, name=None):
        super().__init__(name=name or "model")
        self.inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        self.outputs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]

    def _topo_layers(self) -> List[Layer]:
        # DFS from outputs; inputs must appear first and in declared order
        order: List[Layer] = []
        seen = set()

        def visit(t: KerasTensor):
            l = t.from_layer
            if l is None or id(l) in seen:
                return
            seen.add(id(l))
            for ti in l.inbound:
                visit(ti)
            order.append(l)

        input_layers = [t.from_layer for t in self.inputs]
        for l in input_layers:
            seen.add(id(l))
        for t in self.outputs:
            visit(t)
        return input_layers + order

    def _output_tensors(self):
        return self.outputs
