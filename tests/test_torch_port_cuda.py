"""The port's CUDA kernels against their plain versions, on a card.

Every case is marked ``gpu`` and skips where no GPU is present: a CUDA
kernel has no CPU mode. This file imports neither JAX nor the JAX
package, so it also runs on a GPU machine without them:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerance: fp32, atol/rtol 1e-4 (the kernels sum in another order).
"""
import pytest
import torch

from flexflow_tpu_torch.ops.kernels import flash_attention as fa

pytestmark = [pytest.mark.torch_port, pytest.mark.gpu]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("sq,sk,d,causal", [
    (128, 128, 64, False), (96, 96, 64, True), (40, 70, 100, False),
    # the tensor-core kernels' tile edges: one row, ragged 64-row blocks
    # and 16/32-row tiles, head dims padded to 32 and to 128, D % 4 != 0
    # (4-byte copies), and D = 256 on the CUDA-core forward and dK/dV
    (1, 1, 64, False), (63, 63, 64, True), (65, 65, 64, False), (129, 129, 64, True),
    (128, 128, 8, False), (65, 65, 100, True), (129, 129, 128, False), (70, 70, 33, False),
    (65, 65, 256, True), (512, 512, 64, True),
])
def test_cuda_kernels_match_plain_versions(cuda, sq, sk, d, causal):
    """The three flash kernels, causal and ragged, and the autograd path."""
    gen = torch.Generator().manual_seed(sq + sk + d)
    q = torch.randn(2, sq, 3, d, generator=gen).to(cuda)
    k = torch.randn(2, sk, 3, d, generator=gen).to(cuda)
    v = torch.randn(2, sk, 3, d, generator=gen).to(cuda)
    do = torch.randn(2, sq, 3, d, generator=gen).to(cuda)
    scale = d ** -0.5
    o, lse = fa.flash_forward_kernel(q, k, v, causal, scale)
    po, plse = fa.reference_flash_forward(q, k, v, causal, scale)
    torch.testing.assert_close(o, po, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-4)
    delta = fa.flash_delta(do, po)
    dq = fa.flash_backward_dq_kernel(q, k, v, do, plse, delta, causal, scale)
    dk, dv = fa.flash_backward_dkv_kernel(q, k, v, do, plse, delta, causal, scale)
    want = fa.reference_flash_backward(q, k, v, do, plse, delta, causal, scale)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, atol=1e-4, rtol=1e-4)
    fa.reset_launch_counts()
    grads = []
    for backend in ("auto", "plain"):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        (fa.flash_attention(*leaves, causal=causal, backend=backend) * do).sum().backward()
        grads.append([t.grad for t in leaves])
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_cuda_dkv_kernel_is_deterministic(cuda):
    """dK/dV is gridded over key tiles with no atomics: the same inputs
    give the same bits on every run."""
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(4, 256, 4, 64, generator=gen).to(cuda) for _ in range(4))
    o, lse = fa.flash_forward_kernel(q, k, v, True, 0.125)
    delta = fa.flash_delta(do, o)
    first = fa.flash_backward_dkv_kernel(q, k, v, do, lse, delta, True, 0.125)
    for _ in range(3):
        again = fa.flash_backward_dkv_kernel(q, k, v, do, lse, delta, True, 0.125)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.randn(1, 16, 1, 300, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 16, 1, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
