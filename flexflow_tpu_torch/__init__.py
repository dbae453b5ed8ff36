"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu for NVIDIA
Hopper (H100).

The package mirrors ``flexflow_tpu``'s module paths so each counterpart
is easy to find (``flexflow_tpu_torch.generation.engine`` ports
``flexflow_tpu.generation.engine``). It imports ``torch`` and never
``jax`` or anything of ``flexflow_tpu``: where it needs a definition from
the JAX package it keeps its own copy.

Slice 1 holds the paged-KV generation serving path: the block KV cache,
the decoder's four forwards, the generation engine (with JAX's threefry
sampling bits) and the continuous-batching scheduler, with the paged
decode/append attention written as CUDA C++ kernels for ``sm_90a``
(``ops/kernels/csrc/``). Slice 2 holds the single-GPU training path,
``FFModel`` -> ``compile`` -> ``fit``, for BERT-style encoders, with the
flash-attention forward, dQ and dK/dV kernels in CUDA C++; slice 3 moved
the forward and dK/dV onto the tensor cores at fp32 accuracy (3xTF32).
Importing the package builds nothing; the kernels compile at first use on
a GPU.
"""

__version__ = "0.1.0"
