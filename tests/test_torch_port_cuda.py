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


@pytest.mark.parametrize("sq,sk,d,causal", [(128, 128, 64, False), (96, 96, 64, True),
                                            (40, 70, 100, False)])
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


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.randn(1, 16, 1, 300, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 16, 1, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
