"""Shape propagation over the graph, the repeated-block discovery that
rematerialization and pipeline candidates use, the machine description,
the mesh's axis names and device-count check, and the parallelization
strategies (``strategy.py``). Executing a strategy over several GPUs
(the ``torch.distributed`` mesh, the pipeline schedule) waits for the
multi-GPU slice."""
from .pipeline import detect_repeats
from .propagation import infer_all_specs

__all__ = ["detect_repeats", "infer_all_specs"]
