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
  dK/dV kernels of the FlashAttention-2 decomposition. For a CUDA tensor
  :func:`flash_attention` launches them or raises; it never falls back
  to the plain version. Each kernel has up to three bodies, chosen by
  the library per call (:func:`kernel_body`):

  - ``"wgmma"``: the bf16 and fp16 forward, dQ and dK/dV where the
    tensors suit TMA copies — 32 < D <= 128, D a multiple of 8 and the
    base of every tensor the kernel reads or writes 16-byte aligned:
    warpgroup bf16 or fp16 ``wgmma`` products fed by TMA, the computed
    operand (P, dS) in two halves of the type (fp16's dS scaled by a
    power of two a row first, to stay in fp16's range);
  - ``"mma_sync"``: every other call at D <= 128 — the fp32 forms
    (3xTF32 ``mma.sync``), and bf16 or fp16 calls with D <= 32,
    D % 8 != 0 or a misaligned view (one TF32 product for two 2-byte
    operands, two for a computed one);
  - ``"cuda_cores"``: D > 128.

The per-row logsumexp and ``delta = rowsum(dO * O)`` are [B, Sq, H] fp32,
indexed like the rows of q. ``delta`` stays plain PyTorch, as it was
plain XLA in the JAX package.

Causal attention masks ``q_pos >= k_pos`` (top-left), as the TPU kernel
does; it agrees with ``reference_attention``'s bottom-right mask only
when Sq == Sk, so causal attention with Sq != Sk raises here.

Types, as the TPU kernels: float32, bfloat16 or float16 q, k, v (and dO)
in, the arithmetic in float32, o, dq, dk and dv out in the inputs'
dtype, the logsumexp and delta in float32. Each kernel has a float32, a
bfloat16 and a float16 form (``ff_flash_*_f32`` / ``_bf16`` / ``_f16``);
another dtype raises.

Head dims: q and k share one (Dk), v may have its own (Dv); o and dv take
Dv. The kernels take one head dim, up to :data:`MAX_HEAD_DIM`: for
Dv != Dk :func:`flash_attention` zero-pads the narrower of (q, k) or v to
the wider, which adds exact zeros to every product, and slices the
outputs back (the scale stays Dk's).

Each kernel launch runs on the device of its tensors (whatever the
current device is) and adds one to its count in :data:`LAUNCHES`, and
to its body's in :data:`LAUNCHES_BY_BODY` and its head count's in
:data:`LAUNCHES_BY_HEADS`. The count is kept on the
Python side, where the wrapper launches: a CUDA graph of a train step
(``runtime/step_graph.py``) replays its launches without the wrapper, so
a capture records them (:func:`capturing`) and each replay adds them
back (:func:`count_replay`). The record is process-wide, not per thread:
autograd launches the backward kernels from its own thread.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
MAX_HEAD_DIM = 512  # the CUDA-core kernels' widest instance (16 columns of 32)
PLAIN_BLOCK_K = 64  # key rows per step of the plain forward's online softmax

# launches of each CUDA kernel in this process (plain integers; a caller
# resets them with reset_launch_counts() before the run it measures)
LAUNCHES: Dict[str, int] = {
    f"{kernel}{form}": 0
    for form in ("", "_bf16", "_f16") for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
}
# the kernels' forms by input dtype, in ff_flash_body's order (0, 1, 2):
# (suffix of the C function, of the count)
_FORMS = {torch.float32: ("f32", ""), torch.bfloat16: ("bf16", "_bf16"),
          torch.float16: ("f16", "_f16")}
# the bodies behind each kernel, as ff_flash_body numbers them
BODIES = ("mma_sync", "wgmma", "cuda_cores")
# launches by the body that took them, keyed "<LAUNCHES key> <body>"
LAUNCHES_BY_BODY: Dict[str, int] = {f"{name} {body}": 0 for name in LAUNCHES for body in BODIES}
# launches by the head count of their q, keyed "<LAUNCHES key> H=<heads>"
# (a tensor-parallel rank launches on its share of the heads)
LAUNCHES_BY_HEADS: Dict[str, int] = {}
_KINDS = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}

_BACKENDS = ("auto", "plain")


# the launches of the capture under way (capturing()), or None
_CAPTURE: Optional[Dict[str, int]] = None


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_BODY):
        for name in counts:
            counts[name] = 0
    LAUNCHES_BY_HEADS.clear()


@contextlib.contextmanager
def capturing():
    """Around a CUDA graph capture: the launches recorded into the graph
    go into the dict yielded (the capture's launches, for
    :func:`count_replay`) and not into the counts."""
    global _CAPTURE
    prev, rec = _CAPTURE, {}
    _CAPTURE = rec
    try:
        yield rec
    finally:
        _CAPTURE = prev


def count_replay(captured: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``captured``."""
    for name, n in captured.items():
        if name in LAUNCHES or name in LAUNCHES_BY_BODY:
            (LAUNCHES if name in LAUNCHES else LAUNCHES_BY_BODY)[name] += n
        else:
            LAUNCHES_BY_HEADS[name] = LAUNCHES_BY_HEADS.get(name, 0) + n


def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"expected q, k, v as [B, S, H, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if (k.shape != q.shape[:1] + k.shape[1:2] + q.shape[2:]
            or v.shape[:3] != k.shape[:3]):
        raise ValueError(
            f"k {tuple(k.shape)} must match q {tuple(q.shape)} in batch, heads and "
            f"head_dim, and v {tuple(v.shape)} k in batch, length and heads"
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
    fp32 (the TPU ``_fwd_kernel``'s arithmetic). q [B, Sq, H, Dk], k
    [B, Sk, H, Dk], v [B, Sk, H, Dv]. Returns (o [B, Sq, H, Dv] in q's
    dtype, lse [B, Sq, H] fp32)."""
    _check_shapes(q, k, v, causal)
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    qs = q.float().permute(0, 2, 1, 3) * scale  # [B, H, Sq, D]
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, v.shape[-1]), dtype=torch.float32, device=q.device)
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


def _check_kernel_inputs(causal: bool, *tensors: torch.Tensor) -> Tuple[str, str]:
    """What the CUDA kernels assume, checked before a pointer is passed:
    one CUDA device, contiguous tensors, q, k, v (and dO) all float32, all
    bfloat16 or all float16 with one head dim, lse and delta float32, B
    and H within the grid, D <= MAX_HEAD_DIM. Returns the form: (C
    suffix, count suffix)."""
    q, k, v = tensors[:3]
    _check_shapes(q, k, v, causal)
    if v.shape[-1] != q.shape[-1]:
        raise ValueError(f"the kernels take one head dim, got q {q.shape[-1]} and "
                         f"v {v.shape[-1]} (flash_attention pads them)")
    if q.dtype not in _FORMS:
        raise TypeError(
            f"flash attention kernels take float32, bfloat16 or float16, got {q.dtype}")
    for i, t in enumerate(tensors):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        want = q.dtype if i < 4 else torch.float32  # q, k, v, dO; then lse, delta
        if t.dtype != want:
            raise TypeError(f"flash attention kernels take {want} here, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash attention kernels need contiguous tensors")
    b, sq, h, d = q.shape
    if not (1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"head_dim {d} outside the kernels' 1..{MAX_HEAD_DIM}")
    if min(sq, k.shape[1]) < 1 or not (1 <= b <= 65535) or not (1 <= h <= 65535):
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(k.shape)} outside the kernels' grid")
    return _FORMS[q.dtype]


def _raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def kernel_body(kernel: str, q, k, v, dout=None, out0=None, out1=None) -> str:
    """The body (:data:`BODIES`) the CUDA library runs ``kernel``
    (``"flash_fwd"``, ``"flash_bwd_dq"`` or ``"flash_bwd_dkv"``) on for
    these tensors, as the library itself decides it: ``out0`` is o, dq or
    dk, ``out1`` dv."""
    from ._build import load_library

    ptr = [t.data_ptr() if t is not None else None for t in (q, k, v, dout, out0, out1)]
    got = load_library().ff_flash_body(list(_FORMS).index(q.dtype), _KINDS[kernel], *ptr,
                                       q.shape[-1])
    return BODIES[got]


def _count(kernel: str, count: str, *tensors) -> None:
    names = (kernel + count, f"{kernel}{count} {kernel_body(kernel, *tensors)}",
             f"{kernel}{count} H={tensors[0].shape[2]}")
    rec = _CAPTURE
    if rec is not None and torch.cuda.is_current_stream_capturing():
        # recorded into a graph, not run: counted at each replay
        for name in names:
            rec[name] = rec.get(name, 0) + 1
        return
    LAUNCHES[names[0]] += 1
    LAUNCHES_BY_BODY[names[1]] += 1
    LAUNCHES_BY_HEADS[names[2]] = LAUNCHES_BY_HEADS.get(names[2], 0) + 1


def flash_forward_kernel(q, k, v, causal: bool, scale: float):
    """Launch the forward kernel: returns (o [B,Sq,H,D], lse [B,Sq,H])."""
    from ._build import load_library

    fn, count = _check_kernel_inputs(causal, q, k, v)
    lib = load_library()
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"ff_flash_fwd_{fn}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, sq, k.shape[1], h, d, float(scale), int(causal), _stream(q),
        )
    _raise_on_error(rc, f"ff_flash_fwd_{fn}")
    _count("flash_fwd", count, q, k, v, None, o)
    return o, lse


def flash_backward_dq_kernel(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Launch the dQ kernel (gridded over query tiles): returns dq."""
    from ._build import load_library

    fn, count = _check_kernel_inputs(causal, q, k, v, dout, lse, delta)
    lib = load_library()
    b, sq, h, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"ff_flash_bwd_dq_{fn}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, sq, k.shape[1], h, d, float(scale),
            int(causal), _stream(q),
        )
    _raise_on_error(rc, f"ff_flash_bwd_dq_{fn}")
    _count("flash_bwd_dq", count, q, k, v, dout, dq)
    return dq


def flash_backward_dkv_kernel(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Launch the dK/dV kernel (gridded over key tiles): returns (dk, dv)."""
    from ._build import load_library

    fn, count = _check_kernel_inputs(causal, q, k, v, dout, lse, delta)
    lib = load_library()
    b, sq, h, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"ff_flash_bwd_dkv_{fn}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], h, d,
            float(scale), int(causal), _stream(q),
        )
    _raise_on_error(rc, f"ff_flash_bwd_dkv_{fn}")
    _count("flash_bwd_dkv", count, q, k, v, dout, dk, dv)
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
    """Flash attention over [B, S, H, D] tensors (differentiable); v may
    have its own head dim, which the output takes.

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
        dk, dv = q.shape[-1], v.shape[-1]
        if dk != dv:
            # one head dim for the kernels: zero columns add exact zeros to
            # every product; autograd pads dO and slices the gradients
            _check_shapes(q, k, v, causal)
            d = max(dk, dv)
            q, k, v = (F.pad(t, (0, d - t.shape[-1])).contiguous() for t in (q, k, v))
            o = FlashAttention.apply(q, k, v, bool(causal), float(scale), True)
            return o[..., :dv]
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    else:
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return FlashAttention.apply(q, k, v, bool(causal), float(scale), use_kernel)
