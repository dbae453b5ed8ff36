"""Shape propagation over the graph, the repeated-block discovery that
rematerialization and pipeline candidates use, the machine description,
the mesh's axis names and device-count check, the parallelization
strategies (``strategy.py``), and the generation engine's serving mesh
and tensor-parallel group (``mesh.py::serving_mesh``,
``distributed.py``). Executing a training strategy over several GPUs
(the ``torch.distributed`` mesh, the pipeline schedule) waits for the
parallel training slice."""
from .pipeline import detect_repeats
from .propagation import infer_all_specs

__all__ = ["detect_repeats", "infer_all_specs"]
