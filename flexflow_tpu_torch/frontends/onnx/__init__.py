"""flexflow_tpu_torch.frontends.onnx: the ONNX graph importer (port of
``flexflow_tpu/frontends/onnx``).

Reference: python/flexflow/onnx/model.py (375 LoC).
"""
from .model import ONNXModel, onnx_to_flexflow

__all__ = ["ONNXModel", "onnx_to_flexflow"]
