"""The port's serving tools (loadgen, obsreport, simfleet, genbench,
perfwatch, chaoscheck, flexlint: ports of the JAX package's ``tools/``)
and the probes of the port on a GPU, each run as a module (e.g.
``python3 -m flexflow_tpu_torch.tools.loadgen`` or
``python3 -m flexflow_tpu_torch.tools.flash_probe``)."""
