"""Flash attention, forward and backward (port of
``flexflow_tpu/ops/kernels/flash_attention.py``).

The training path's attention core: ``MultiHeadAttentionOp`` calls
:func:`flash_attention` over [B, S, H, D] tensors, once per layer
forward, and autograd calls its backward once per layer.

Two lowerings, chosen by where the tensors lie (or by ``backend``):

* the plain PyTorch versions — :func:`reference_flash_forward` (the
  TPU kernel's tiled online softmax over key blocks, returning O and the
  per-row logsumexp) and :func:`reference_flash_backward` (P recomputed
  from the logsumexp, then the P/dP/dS products). They run for CPU
  tensors, or on any device when asked for by name (``backend="plain"``),
  and are the oracle the CUDA kernels are held against on the card.
* the CUDA kernels of ``csrc/flash_attention.cu`` — the forward, dQ and
  dK/dV kernels of the FlashAttention-2 decomposition; the forward and
  dK/dV take their products on the tensor cores as three TF32 products
  each (3xTF32, fp32 accuracy) for head dims up to 128. For a CUDA
  tensor :func:`flash_attention` launches them or raises; it never
  falls back to the plain version.

The per-row logsumexp and ``delta = rowsum(dO * O)`` are [B, Sq, H] fp32,
indexed like the rows of q. ``delta`` stays plain PyTorch, as it was
plain XLA in the JAX package.

Causal attention masks ``q_pos >= k_pos`` (top-left), as the TPU kernel
does; it agrees with ``reference_attention``'s bottom-right mask only
when Sq == Sk, so causal attention with Sq != Sk raises here.

Each kernel launch adds one to its count in :data:`LAUNCHES`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 256
PLAIN_BLOCK_K = 64  # key rows per step of the plain forward's online softmax

# launches of each CUDA kernel in this process (plain integers; a caller
# resets them with reset_launch_counts() before the run it measures)
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_BACKENDS = ("auto", "plain")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"expected q, k, v as [B, S, H, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must match q "
            f"{tuple(q.shape)} in batch, heads and head_dim"
        )
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal attention needs Sq == Sk (got {q.shape[1]} and {k.shape[1]}): the "
            "flash kernels mask q_pos >= k_pos from the top left, which agrees with "
            "the bottom-right mask of reference_attention only for square scores"
        )


def _causal_mask(sq: int, sk: int, k0: int, device) -> torch.Tensor:
    """[sq, sk] True where query row i may see key k0+j (top-left)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(k0, k0 + sk, device=device)[None, :]
    return qpos >= kpos


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def reference_flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax attention over key blocks of ``PLAIN_BLOCK_K`` rows, in
    fp32 (the TPU ``_fwd_kernel``'s arithmetic). q [B, Sq, H, D], k/v
    [B, Sk, H, D]. Returns (o [B, Sq, H, D] in q's dtype, lse [B, Sq, H]
    fp32)."""
    _check_shapes(q, k, v, causal)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qs = q.float().permute(0, 2, 1, 3) * scale  # [B, H, Sq, D]
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, PLAIN_BLOCK_K):
        kb = kf[:, :, k0:k0 + PLAIN_BLOCK_K]
        vb = vf[:, :, k0:k0 + PLAIN_BLOCK_K]
        s = qs @ kb.transpose(-1, -2)  # [B, H, Sq, bk]
        if causal:
            valid = _causal_mask(sq, kb.shape[2], k0, q.device)
            s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        if causal:
            p = torch.where(valid, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ vb
        m = m_new
    l = l.clamp_min(1e-30)
    o = (acc / l).permute(0, 2, 1, 3).to(q.dtype)
    lse = (m + torch.log(l))[..., 0].permute(0, 2, 1).contiguous()
    return o, lse


def flash_delta(dout: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O), [B, Sq, H] fp32 (computed outside the
    kernels, as in the JAX package)."""
    return (dout.float() * o.float()).sum(dim=-1)


def _plain_probs(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """The backward kernels' shared recomputation, [B, H, Sq, *]: the
    pre-scaled q, k, v and dO (head-major), P = exp(S - lse) and dS =
    P (dP - delta)."""
    _check_shapes(q, k, v, causal)
    qs = q.float().permute(0, 2, 1, 3) * scale
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    do = dout.float().permute(0, 2, 1, 3)
    p = torch.exp(qs @ kf.transpose(-1, -2) - lse.permute(0, 2, 1)[..., None])
    if causal:
        p = torch.where(_causal_mask(q.shape[1], k.shape[1], 0, q.device), p, 0.0)
    ds = p * (do @ vf.transpose(-1, -2) - delta.permute(0, 2, 1)[..., None])
    return qs, kf, do, p, ds


def _bshd(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3).to(like.dtype)


def reference_flash_backward_dq(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Plain version of the dQ kernel: dQ = scale * dS K."""
    _, kf, _, _, ds = _plain_probs(q, k, v, dout, lse, delta, causal, scale)
    return _bshd((ds @ kf) * scale, q)


def reference_flash_backward_dkv(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Plain version of the dK/dV kernel: dV = P^T dO, dK = dS^T (scale
    Q) (q enters pre-scaled)."""
    qs, _, do, p, ds = _plain_probs(q, k, v, dout, lse, delta, causal, scale)
    return _bshd(ds.transpose(-1, -2) @ qs, k), _bshd(p.transpose(-1, -2) @ do, v)


def reference_flash_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The TPU backward kernels' arithmetic in plain PyTorch: P =
    exp(S - lse) recomputed, dV = P^T dO, dP = dO V^T, dS = P (dP -
    delta), dQ = scale dS K, dK = dS^T (scale Q). Returns (dq, dk, dv) in
    the dtypes of q, k, v."""
    qs, kf, do, p, ds = _plain_probs(q, k, v, dout, lse, delta, causal, scale)
    return (_bshd((ds @ kf) * scale, q), _bshd(ds.transpose(-1, -2) @ qs, k),
            _bshd(p.transpose(-1, -2) @ do, v))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _check_kernel_inputs(causal: bool, *tensors: torch.Tensor) -> None:
    """What the CUDA kernels assume, checked before a pointer is passed:
    one CUDA device, contiguous fp32, B and H within the grid, D <= 256."""
    q, k, v = tensors[:3]
    _check_shapes(q, k, v, causal)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"flash attention kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash attention kernels need contiguous tensors")
    b, sq, h, d = q.shape
    if not (1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"head_dim {d} outside the kernels' 1..{MAX_HEAD_DIM}")
    if min(sq, k.shape[1]) < 1 or not (1 <= b <= 65535) or not (1 <= h <= 65535):
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(k.shape)} outside the kernels' grid")


def _raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward_kernel(q, k, v, causal: bool, scale: float):
    """Launch the forward kernel: returns (o [B,Sq,H,D], lse [B,Sq,H])."""
    from ._build import load_library

    _check_kernel_inputs(causal, q, k, v)
    lib = load_library()
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    rc = lib.ff_flash_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, sq, k.shape[1], h, d, float(scale), int(causal), _stream(q),
    )
    _raise_on_error(rc, "ff_flash_fwd_f32")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_backward_dq_kernel(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Launch the dQ kernel (gridded over query tiles): returns dq."""
    from ._build import load_library

    _check_kernel_inputs(causal, q, k, v, dout, lse, delta)
    lib = load_library()
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    rc = lib.ff_flash_bwd_dq_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, sq, k.shape[1], h, d, float(scale),
        int(causal), _stream(q),
    )
    _raise_on_error(rc, "ff_flash_bwd_dq_f32")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_backward_dkv_kernel(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Launch the dK/dV kernel (gridded over key tiles): returns (dk, dv)."""
    from ._build import load_library

    _check_kernel_inputs(causal, q, k, v, dout, lse, delta)
    lib = load_library()
    b, sq, h, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = lib.ff_flash_bwd_dkv_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], h, d,
        float(scale), int(causal), _stream(q),
    )
    _raise_on_error(rc, "ff_flash_bwd_dkv_f32")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class FlashAttention(torch.autograd.Function):
    """O = attention(q, k, v) with the flash backward: saves q, k, v, O
    and the logsumexp, and recomputes P in the backward (the JAX
    package's ``custom_vjp``). ``use_kernel`` picks the CUDA kernels over
    the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, use_kernel: bool):
        fwd = flash_forward_kernel if use_kernel else reference_flash_forward
        o, lse = fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.use_kernel = causal, scale, use_kernel
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_delta(dout, o)
        if ctx.use_kernel:
            dq = flash_backward_dq_kernel(q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
            dk, dv = flash_backward_dkv_kernel(q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
        else:
            dq, dk, dv = reference_flash_backward(
                q, k, v, dout, lse, delta, ctx.causal, ctx.scale
            )
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Flash attention over [B, S, H, D] tensors (differentiable).

    ``backend="auto"``: CUDA tensors launch the CUDA kernels (and raise on
    shapes or types they do not take), CPU tensors take the plain
    versions. ``backend="plain"`` asks for the plain versions on any
    device."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if backend == "plain" or q.device.type == "cpu":
        use_kernel = False
    elif q.device.type == "cuda":
        use_kernel = True
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    else:
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return FlashAttention.apply(q, k, v, bool(causal), float(scale), use_kernel)
