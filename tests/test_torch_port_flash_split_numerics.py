"""The bf16 flash bodies' split products, their arithmetic emulated in numpy.

The wgmma bodies of ``flexflow_tpu_torch/ops/kernels/csrc/flash_attention.cu``
take a product with a computed fp32 operand (the forward's P V, dQ's
dS K, dK/dV's P^T dO and dS^T Q) as two bf16 products: the operand x is split into
hi = bf16(x) and lo = bf16(x - hi), each multiplied exactly by the bf16
input and added to an fp32 accumulator in steps of 16 (one ``wgmma``
m64n64k16 each, lo first). x = hi + lo + e with |e| <= 2^-16 |x|, so the
sum keeps the JAX kernels' function: fp32 products of fp32 P or dS with
the bf16 inputs (``flexflow_tpu/ops/kernels/flash_attention.py:102-141``,
``:184-212``, ``:215-250``). Rounding P or dS once to bf16 (one product, as SDPA's bf16
kernels do) errs by up to 2^-8 a term: another function.

Here that arithmetic runs at the training shape's row lengths (S = 128
keys and queries, D = 64, bf16 inputs of unit variance as
``chip_smoke.py`` makes them, 6 heads) and is held against the port's
plain versions (``reference_flash_forward``,
``reference_flash_backward_dq``, ``reference_flash_backward_dkv``, which
the kernels are held against on the card) at
``chip_smoke.py::check_bf16``'s gate: one bf16 ulp of the plain value +
1e-3. Measured (the margins the asserts leave): the split reaches at
most 0.66 of the gate, and its fp32 sums err by at most
2^-18.2 of the sum of the terms' magnitudes against a bound of 2^-16; it
changes under 0.5% of the rounded outputs (values within ~2^-18 of a
rounding boundary). One bf16 product reaches 1.03x the gate in O, 1.6x
in dV, 2.3x in dK and 1.4x in dQ, errs by 2^-8.9 .. 2^-9.6 of the
magnitudes, and changes ~43% of the rounded outputs.

    python -m pytest tests/test_torch_port_flash_split_numerics.py
"""
import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops.kernels import flash_attention as fa

pytestmark = pytest.mark.torch_port

BF16_ATOL = 1e-3  # chip_smoke.py's bf16 gate: 1 ulp of the plain value + this
S, D, HEADS = 128, 64, 6  # the training shape's sequence and head dim
SPLIT_BOUND = 2.0 ** -16  # |e| <= 2^-16 |x| a term, against the terms' magnitudes


def bf16(x: np.ndarray) -> np.ndarray:
    """Round to bf16 (nearest, ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def gate_share(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| as a share of check_bf16's gate."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return float((np.abs(got - want) / (ulp + BF16_ATOL)).max())


def wgmma_chain(parts, b: np.ndarray) -> np.ndarray:
    """sum(parts) @ b as the body's chain computes it: per 16-deep step,
    each part's exact products added to the fp32 accumulator in turn."""
    acc = np.zeros((parts[0].shape[0], b.shape[1]), np.float32)
    for k0 in range(0, b.shape[0], 16):
        for a in parts:
            step = a[:, k0:k0 + 16].astype(np.float64) @ b[k0:k0 + 16].astype(np.float64)
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def split(x: np.ndarray):
    hi = bf16(x)
    return [bf16(x - hi), hi]  # lo first, as the kernels order them


def _heads():
    """Per head: the plain versions' bf16 outputs (o, dk, dv, dq) and
    the fp32 operands the kernels compute (P / l, P^T, dS^T, dS) with the
    bf16 inputs they multiply."""
    rs = np.random.RandomState(0)
    scale = D ** -0.5
    for _ in range(HEADS):
        q, k, v, do = (bf16(rs.randn(S, D)) for _ in range(4))
        tq, tk, tv, tdo = (torch.from_numpy(x)[None, :, None, :].to(torch.bfloat16)
                           for x in (q, k, v, do))
        po, plse = fa.reference_flash_forward(tq, tk, tv, False, scale)
        delta = fa.flash_delta(tdo, po)
        pdk, pdv = fa.reference_flash_backward_dkv(tq, tk, tv, tdo, plse, delta, False, scale)
        pdq = fa.reference_flash_backward_dq(tq, tk, tv, tdo, plse, delta, False, scale)
        lse = plse[0, :, 0].numpy()[:, None]
        s = (q @ k.T).astype(np.float32) * np.float32(scale)
        p = np.exp(s - lse).astype(np.float32)  # rows sum to 1: P / l of the forward
        ds = (p * (do @ v.T - delta[0, :, 0].numpy()[:, None])).astype(np.float32)
        plain = {name: t[0, :, 0].float().numpy() for name, t in
                 (("o", po), ("dk", pdk), ("dv", pdv), ("dq", pdq))}
        # (fp32 operand, bf16 operand, output multiplier) of each product
        products = {"o": (p, v, 1.0), "dv": (p.T.copy(), do, 1.0),
                    "dk": (ds.T.copy(), q, np.float32(scale)),
                    "dq": (ds, k, np.float32(scale))}
        yield plain, products


def _errors(split_operand: bool):
    """Per output: the largest share of the gate, of the terms' magnitude,
    and the share of rounded outputs that differ from the plain version's."""
    out = {name: [0.0, 0.0, 0.0] for name in ("o", "dv", "dk", "dq")}
    for plain, products in _heads():
        for name, (a, b, mul) in products.items():
            parts = split(a) if split_operand else [bf16(a)]
            acc = wgmma_chain(parts, b) * mul
            exact = (a.astype(np.float64) @ b.astype(np.float64)) * mul
            mag = (np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)) * mul
            got = bf16(acc)
            rec = out[name]
            rec[0] = max(rec[0], gate_share(got, plain[name]))
            rec[1] = max(rec[1], float((np.abs(acc - exact) / mag).max()))
            rec[2] = max(rec[2], float((got != plain[name]).mean()))
    return out


def test_two_bf16_halves_stay_within_the_bf16_gate():
    """P and dS as hi + lo: every output within check_bf16's gate of the
    plain version, and the fp32 sums within 2^-16 of the terms'
    magnitudes (the split's own error)."""
    for name, (gate, rel, changed) in _errors(split_operand=True).items():
        print(f"split {name}: {gate:.3f} of the gate, 2^{np.log2(rel):.2f} of the magnitudes, "
              f"{changed:.4f} of the rounded outputs changed")
        assert gate <= 1.0, name
        assert rel <= SPLIT_BOUND, name
        assert changed < 0.01, name


def test_one_bf16_product_is_another_function():
    """P and dS rounded once to bf16: the fp32 sums err by ~2^-9 of the
    terms' magnitudes (far past the split's 2^-16), ~43% of the rounded
    outputs change, and dK, dV and dQ leave check_bf16's gate."""
    errs = _errors(split_operand=False)
    for name, (gate, rel, changed) in errs.items():
        print(f"single {name}: {gate:.3f} of the gate, 2^{np.log2(rel):.2f} of the magnitudes, "
              f"{changed:.4f} of the rounded outputs changed")
        assert rel > 2.0 ** -11, name
        assert changed > 0.2, name
    assert errs["dv"][0] > 1.0 and errs["dk"][0] > 1.0 and errs["dq"][0] > 1.0
