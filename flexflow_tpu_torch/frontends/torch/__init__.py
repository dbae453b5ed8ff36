"""flexflow_tpu_torch.frontends.torch: the torch.fx importer (port of
``flexflow_tpu/frontends/torch``).

Reference: python/flexflow/torch/model.py (2607 LoC): symbolic-trace a
torch.nn.Module and replay each fx node as an FFModel builder call.
"""
from .model import PyTorchModel, copy_weights, replay_ff, torch_to_flexflow

__all__ = ["PyTorchModel", "torch_to_flexflow", "copy_weights", "replay_ff"]
