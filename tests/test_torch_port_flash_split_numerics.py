"""The bf16 and fp16 flash bodies' split products, their arithmetic emulated in numpy.

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
``chip_smoke.py::check_half``'s gate: one bf16 ulp of the plain value +
1e-3. Measured (the margins the asserts leave): the split reaches at
most 0.66 of the gate, and its fp32 sums err by at most
2^-18.2 of the sum of the terms' magnitudes against a bound of 2^-16; it
changes under 0.5% of the rounded outputs (values within ~2^-18 of a
rounding boundary). One bf16 product reaches 1.03x the gate in O, 1.6x
in dV, 2.3x in dK and 1.4x in dQ, errs by 2^-8.9 .. 2^-9.6 of the
magnitudes, and changes ~43% of the rounded outputs.

The fp16 bodies split the same operands into two fp16 halves, but fp16
keeps fp32's precision only between 2^-14 and 65504. P lies in [0, 1]
and is split as it is: a P below 2^-14 (most of a row with one dominant
key) has subnormal halves spaced 2^-24, so x = hi + lo + e with |e| <=
2^-22 |x| above 2^-14 and |e| <= 2^-25 below it. dS can leave the range
at either end (|dS| past 65504 overflows hi; training's gradients, of
order 1e-6, are subnormal), so before its split each row of dS (dS^T:
each key's row) is multiplied by 2^e, e the running least over the
64-wide tiles so far of 14 - floor(log2 of the row's largest |dS|), and
the accumulator row by 2^(e_new - e_old) as e falls; the store
multiplies by 2^-e. The fp16 cases: the training shape, a dominant key
(q times 6: 83% of P below 2^-14), dS past 65504 (q and k times 0.01,
v and dO times 1000, every output finite in fp16) and gradients of
order 1e-6 (dO times 1e-6). Each output is held within
``chip_smoke.py::check_half``'s fp16 gate (one fp16 ulp of the plain
value, no finer than the smallest normal's, + 1e-3) and within the
chain's own bound of the exact sum: 2^-19 of the terms' magnitudes (16
fp32 roundings of 2^-24 at S = 128, and 2^-22 from the split) plus
2^-25 2^-e a term of the input's magnitudes (the subnormal halves); at
the range ends also within ``chip_smoke.py::check_fp16_range``'s gate,
one ulp + 1e-3 of the output's largest |value| (1e-3 itself would pass
outputs of order 1e-6 whatever they held). Without the scaling, dS past
65504 gives infinities, and dK and dQ from 1e-6 gradients err by ~2^-2.5
of their magnitudes (2^-23 scaled), 2 subnormal ulps: twice the range
gate.

    python -m pytest tests/test_torch_port_flash_split_numerics.py
"""
import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops.kernels import flash_attention as fa

pytestmark = pytest.mark.torch_port

BF16_ATOL = 1e-3  # chip_smoke.py's 2-byte gate: 1 ulp of the plain value + this
S, D, HEADS = 128, 64, 6  # the training shape's sequence and head dim
SPLIT_BOUND = 2.0 ** -16  # |e| <= 2^-16 |x| a term, against the terms' magnitudes


def bf16(x: np.ndarray) -> np.ndarray:
    """Round to bf16 (nearest, ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def f16(x: np.ndarray) -> np.ndarray:
    """Round to fp16 (nearest, ties to even; subnormals, infinity past
    65504), as float32."""
    with np.errstate(over="ignore"):
        return np.asarray(x, np.float32).astype(np.float16).astype(np.float32)


def gate_share(got: np.ndarray, want: np.ndarray, mantissa: int = 7, low: int = -126,
               atol: float = BF16_ATOL) -> float:
    """The largest |got - want| as a share of check_half's gate for a type
    of ``mantissa`` stored bits whose normals start at 2^low, with
    ``atol``."""
    ulp = np.exp2(np.maximum(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))), low) - mantissa)
    return float((np.abs(got - want) / (ulp + atol)).max())


def wgmma_chain(parts, b: np.ndarray, acc=None) -> np.ndarray:
    """sum(parts) @ b as the body's chain computes it: per 16-deep step,
    each part's exact products added to the fp32 accumulator (zeros, or
    ``acc``) in turn."""
    if acc is None:
        acc = np.zeros((parts[0].shape[0], b.shape[1]), np.float32)
    for k0 in range(0, b.shape[0], 16):
        for a in parts:
            step = a[:, k0:k0 + 16].astype(np.float64) @ b[k0:k0 + 16].astype(np.float64)
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def split(x: np.ndarray, rnd=bf16):
    hi = rnd(x)
    return [rnd(x - hi), hi]  # lo first, as the kernels order them


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
    """P and dS as hi + lo: every output within check_half's gate of the
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
    outputs change, and dK, dV and dQ leave check_half's gate."""
    errs = _errors(split_operand=False)
    for name, (gate, rel, changed) in errs.items():
        print(f"single {name}: {gate:.3f} of the gate, 2^{np.log2(rel):.2f} of the magnitudes, "
              f"{changed:.4f} of the rounded outputs changed")
        assert rel > 2.0 ** -11, name
        assert changed > 0.2, name
    assert errs["dv"][0] > 1.0 and errs["dk"][0] > 1.0 and errs["dq"][0] > 1.0


# ------------------------------------------------------------------ fp16
# (q, k, v, dO) multipliers of unit-variance inputs, per case
F16_CASES = {
    "training": (1, 1, 1, 1),
    "dominant_key": (6, 1, 1, 1),  # 83% of P below 2^-14: subnormal halves
    "dS_past_65504": (0.01, 0.01, 1000, 1000),  # |dS| to 2.8e5, outputs finite
    "gradients_1e-6": (1, 1, 1, 1e-6),  # |dS| below 2^-14, as training's are
}
F16_CHAIN = 2.0 ** -19  # the chain's bound, of the terms' magnitudes
# chip_smoke.py's gate of the range cases: one ulp + this share of the
# output's largest |value| (HALF_RANGE_SHARE)
F16_RANGE_SHARE = 1e-3
F16_SUBNORMAL = 2.0 ** -25  # a subnormal half's rounding, a term


def scaled_chain(x: np.ndarray, b: np.ndarray, tile: int = 64):
    """x @ b as the fp16 bodies take a dS (or dS^T) product: per row a
    running exponent e over tiles of ``tile`` columns (the least so far of
    14 - floor(log2 of the row's largest |x|), at most 60), the
    accumulator rescaled by 2^(e_new - e_old), the tile times 2^e split
    into two fp16 halves; the sum times 2^-e. Returns (sum, e)."""
    e = np.full((x.shape[0], 1), 60.0)
    acc = np.zeros((x.shape[0], b.shape[1]), np.float32)
    for t0 in range(0, x.shape[1], tile):
        xt = x[:, t0:t0 + tile]
        lg = np.floor(np.log2(np.maximum(np.abs(xt).max(axis=1, keepdims=True), 2.0 ** -127)))
        en = np.minimum(e, np.minimum(60.0, 14.0 - lg))
        acc = (acc * np.exp2(en - e)).astype(np.float32)
        e = en
        acc = wgmma_chain(split((xt * np.exp2(e)).astype(np.float32), f16), b[t0:t0 + tile], acc)
    return (acc * np.exp2(-e)).astype(np.float32), e


def _f16_heads(mul):
    """As _heads, fp16 inputs of unit variance times ``mul`` (q, k, v,
    dO), one head; also P's share below 2^-14 and dS's largest |x|."""
    rs = np.random.RandomState(0)
    scale = D ** -0.5
    q, k, v, do = (f16(rs.randn(S, D) * m) for m in mul)
    tq, tk, tv, tdo = (torch.from_numpy(x)[None, :, None, :].half() for x in (q, k, v, do))
    po, plse = fa.reference_flash_forward(tq, tk, tv, False, scale)
    delta = fa.flash_delta(tdo, po)
    pdk, pdv = fa.reference_flash_backward_dkv(tq, tk, tv, tdo, plse, delta, False, scale)
    pdq = fa.reference_flash_backward_dq(tq, tk, tv, tdo, plse, delta, False, scale)
    lse = plse[0, :, 0].numpy()[:, None]
    p = np.exp((q @ k.T).astype(np.float32) * np.float32(scale) - lse).astype(np.float32)
    ds = (p * (do @ v.T - delta[0, :, 0].numpy()[:, None])).astype(np.float32)
    plain = {name: t[0, :, 0].float().numpy() for name, t in
             (("o", po), ("dk", pdk), ("dv", pdv), ("dq", pdq))}
    products = {"o": (p, v, 1.0), "dv": (p.T.copy(), do, 1.0),
                "dk": (ds.T.copy(), q, np.float32(scale)), "dq": (ds, k, np.float32(scale))}
    return plain, products, float((p < 2.0 ** -14).mean()), float(np.abs(ds).max())


def _f16_errors(case: str, scaled: bool):
    """Per output: (share of the fp16 gate, largest error as a share of
    the chain's bound, largest error as a share of the terms'
    magnitudes, all finite, share of the range cases' gate)."""
    plain, products, _, _ = _f16_heads(F16_CASES[case])
    out = {}
    for name, (a, b, mul) in products.items():
        if name in ("dk", "dq") and scaled:  # dS and dS^T: scaled a row
            acc, e = scaled_chain(a, b)
        else:  # P, or dS split as it is (past 65504 its halves are infinite)
            with np.errstate(invalid="ignore"):
                acc = wgmma_chain(split(a, f16), b)
            e = np.zeros((a.shape[0], 1))
        acc = acc * mul
        exact = (a.astype(np.float64) @ b.astype(np.float64)) * mul
        mag = (np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)) * mul
        sub = F16_SUBNORMAL * np.exp2(-e) * np.abs(b).sum(axis=0)[None, :] * mul
        err = np.abs(acc - exact)
        finite = bool(np.isfinite(acc).all())
        range_atol = F16_RANGE_SHARE * float(np.abs(plain[name]).max())
        out[name] = (gate_share(f16(acc), plain[name], 10, -14) if finite else np.inf,
                     float((err / (F16_CHAIN * mag + sub)).max()) if finite else np.inf,
                     float((err / np.maximum(mag, 1e-300)).max()) if finite else np.inf, finite,
                     gate_share(f16(acc), plain[name], 10, -14, range_atol) if finite else np.inf)
    return out


def test_fp16_cases_are_the_range_ends_they_name():
    """The dominant-key case puts most of P below 2^-14; dS passes 65504
    in one case and stays below 2^-14 in the gradient case; every plain
    fp16 output is finite."""
    shares, largest = {}, {}
    for case, mul in F16_CASES.items():
        plain, _, shares[case], largest[case] = _f16_heads(mul)
        assert all(np.isfinite(x).all() for x in plain.values()), case
    assert shares["dominant_key"] > 0.8 and shares["training"] == 0.0
    assert largest["dS_past_65504"] > 65504
    assert largest["gradients_1e-6"] < 2.0 ** -14


@pytest.mark.parametrize("case", list(F16_CASES))
def test_two_fp16_halves_stay_within_the_fp16_gate(case):
    """P as hi + lo, dS scaled a row by a power of two then split: every
    output within check_half's fp16 gate of the plain version and within
    the chain's own bound of the exact sum; at the range ends also within
    the range cases' gate (one ulp + 1e-3 of the largest |value|)."""
    for name, (gate, bound, rel, finite, ranged) in _f16_errors(case, scaled=True).items():
        print(f"fp16 {case} {name}: {gate:.3f} of the gate, {ranged:.3f} of the range gate, "
              f"{bound:.3f} of the chain's bound, 2^{np.log2(max(rel, 1e-300)):.2f} of the "
              "magnitudes")
        assert finite and gate <= 1.0, (case, name)
        assert bound <= 1.0, (case, name)
        assert case == "training" or ranged <= 1.0, (case, name)


def test_unscaled_fp16_split_of_ds_fails_at_the_range_ends():
    """dS split as it is: past 65504 its halves overflow to infinity, and
    at 1e-6 (subnormal halves) dK and dQ err by more than 2^-11 of the
    terms' magnitudes, where the scaled split keeps 2^-19, and leave the
    range cases' gate (2 subnormal ulps) that the scaled split keeps."""
    over = _f16_errors("dS_past_65504", scaled=False)
    assert not over["dk"][3] and not over["dq"][3]
    tiny = _f16_errors("gradients_1e-6", scaled=False)
    scaled = _f16_errors("gradients_1e-6", scaled=True)
    for name in ("dk", "dq"):
        assert tiny[name][2] > 2.0 ** -11 and scaled[name][2] <= F16_CHAIN, name
        assert tiny[name][4] > 1.0 and scaled[name][4] <= 1.0, name
