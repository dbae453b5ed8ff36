"""Probes of the port's kernels on a GPU (run as modules, e.g.
``python3 -m flexflow_tpu_torch.tools.flash_probe``)."""
