"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu for NVIDIA
Hopper (H100).

The package mirrors ``flexflow_tpu``'s module paths so each counterpart
is easy to find (``flexflow_tpu_torch.generation.engine`` ports
``flexflow_tpu.generation.engine``). It imports ``torch`` and never
``jax`` or anything of ``flexflow_tpu``: where it needs a definition from
the JAX package it keeps its own copy.

Slice 1 holds the paged-KV generation serving path: the block KV cache,
the decoder's four forwards, the generation engine and the continuous-
batching scheduler, with the paged decode/append attention written as
CUDA C++ kernels for ``sm_90a`` (``ops/kernels/csrc/``). Importing the
package builds nothing; the kernels compile at first use on a GPU.
"""

__version__ = "0.1.0"
