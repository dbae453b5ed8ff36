"""Hand-written CUDA kernels (sources in ``csrc/``, built at first use by
``_build.py``) and their plain PyTorch versions."""
