"""The card's profiling tools of the port (``flexflow_tpu_torch/tools/
{_bench,mfu_profile,calib_debug}.py``) against the JAX package's
``bench.py`` and ``tools/mfu_profile.py`` on the CPU.

``train_flops_per_token`` equals ``bench.py``'s; the MFU's peak is the
card's own (an H100's dense bf16 989 TFLOP/s from ``chip_spec_for``),
and a CUDA device the port does not know raises instead of taking a
TPU's figure. ``mfu_profile`` groups a recorded kernel table (names as
torch.profiler reports them on the card) and keeps JAX's entry schema;
both tools run end to end with ``--device cpu`` (one layer, a short
sequence) and raise without a GPU otherwise.
"""
import json
import math

import pytest
import torch

import bench
from flexflow_tpu_torch.search.calibration import chip_spec_for
from flexflow_tpu_torch.tools import _bench, calib_debug, mfu_profile

pytestmark = pytest.mark.torch_port

# (name, device us) as torch.profiler reports a bf16 BERT-Base step's kernels
RECORDED = [
    ("void flash_fwd_wg_kernel<__nv_bfloat16, 64>(FlashParams)", 16.1),
    ("void flash_bwd_dq_wg_kernel<__nv_bfloat16, 64>(FlashParams)", 17.0),
    ("void flash_bwd_dkv_wg_kernel<__nv_bfloat16, 64>(FlashParams)", 25.0),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1", 88.5),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_TNT", 61.2),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_128x1>", 9.0),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<>>", 40.0),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>", 12.5),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16>", 30.0),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", 7.5),
    ("Memcpy DtoD (Device -> Device)", 3.0),
    ("Memset (Device)", 0.4),
    ("void flash_fwd_wg_kernel<__nv_bfloat16, 64>(FlashParams)", 16.3),
]


def test_train_flops_per_token_equals_bench():
    for args in ((110_000_000, 12, 128, 768), (335_000_000, 24, 128, 1024), (9536, 1, 8, 32)):
        assert _bench.train_flops_per_token(*args) == bench.train_flops_per_token(*args)


def test_the_peak_is_the_cards_own():
    kind = "NVIDIA H100 80GB HBM3"
    assert _bench.peak_flops_per_device(kind, "gpu") == chip_spec_for(kind).bf16_flops == 989e12
    assert _bench.peak_flops_per_device("cpu", "cpu") == bench.peak_flops_per_device("cpu", "cpu")
    for unknown in ("NVIDIA A100-SXM4-80GB", "Tesla V100", "TPU v5 lite"):
        with pytest.raises(ValueError, match="no peak FLOP/s"):
            _bench.peak_flops_per_device(unknown, "gpu")
    # the JAX bench's fallback is a TPU's: never the port's
    assert bench.peak_flops_per_device("NVIDIA A100-SXM4-80GB", "tpu") == 197e12


def test_mfu_profile_groups_a_recorded_kernel_table():
    br = mfu_profile.breakdown(RECORDED, top=5)
    total = sum(us for _, us in RECORDED)
    assert br["total_device_us"] == round(total, 1)
    want = {"flash": 16.1 + 17.0 + 25.0 + 16.3, "gemm": 88.5 + 61.2 + 9.0,
            "elementwise": 40.0 + 12.5, "other": 30.0 + 7.5, "copy": 3.4}
    assert {k: round(v, 1) for k, v in want.items()} == br["category_us"]
    assert math.isclose(sum(br["category_fractions"].values()), 1.0, abs_tol=1e-3)
    assert list(br["category_fractions"]) == ["gemm", "flash", "elementwise", "other", "copy"]
    # the top ops merge a kernel's launches and keep JAX's keys
    assert [o["op"][:24] for o in br["top_ops"][:2]] == ["sm90_xmma_gemm_bf16bf16_", "nvjet_hsh_128x256_64x4_2"]
    fwd = [o for o in br["top_ops"] if o["op"].startswith("void flash_fwd_wg")]
    assert fwd and fwd[0]["us"] == round(16.1 + 16.3, 1)
    assert all(set(o) == {"category", "op", "us", "frac"} for o in br["top_ops"])
    assert len(br["top_ops"]) == 5
    assert mfu_profile.breakdown([]) == {"error": "the profiler recorded no device time"}


def test_mfu_profile_runs_on_the_cpu_with_jax_schema(tmp_path, capsys):
    out = tmp_path / "MFU_PROFILE.json"
    for _ in range(2):
        assert mfu_profile.main(["--device", "cpu", "--layers", "1", "--seq", "8", "--batch", "4",
                                 "--iters", "2", "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    assert len(data["runs"]) == 2  # appended
    entry = data["runs"][-1]
    # JAX's entry keys (tools/mfu_profile.py), plus the peak and the launches
    assert {"ts", "backend", "device_kind", "config", "step_ms", "mfu", "prediction",
            "breakdown"} <= set(entry)
    assert entry["backend"] == "cpu" and entry["config"] == {
        "large": False, "batch": 4, "seq": 8, "searched": False, "layers": 1}
    assert entry["step_ms"] > 0 and entry["mfu"] > 0 and entry["peak_flops"] == 1e12
    pred = entry["prediction"]
    assert set(pred) == {"predicted_step_ms", "measured_step_ms", "rel_err", "pairs",
                         "provenance"} and pred["pairs"] >= 1 and pred["predicted_step_ms"] > 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"backend", "step_ms", "mfu", "prediction", "categories", "top3"}


def test_calib_debug_runs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "CALIB_DEBUG.json"
    assert calib_debug.main(["--device", "cpu", "--tiny", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["backend"] == "cpu" and res["device_kind"] == "cpu"
    steps = res["steps"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == steps
    assert len(steps["launch_jitter_us"]) == 10
    assert set(steps["matmul_loop_s"]) == set(steps["ln_loop_s"]) == {"8", "32", "128"}
    for k in ("launch_floor_us", "matmul_per_iter_us", "ln_per_iter_us",
              "framework_linear_us", "framework_ln_us"):
        assert steps[k] > 0, k
    # step E: both ops' errors read back from the truth ledger
    assert set(steps["prediction_error"]) == {"linear", "ln"}
    for e in steps["prediction_error"].values():
        assert e["key"].startswith("op:cpu:") and e["predicted_us"] > 0


def test_slope_separates_the_intercept():
    per, fixed = calib_debug._slope({8: (5 + 8 * 2) / 8, 32: (5 + 32 * 2) / 32,
                                     128: (5 + 128 * 2) / 128})
    assert math.isclose(per, 2.0) and math.isclose(fixed, 5.0)


@pytest.mark.parametrize("tool", ["mfu_profile", "calib_debug"])
def test_the_tools_raise_without_a_gpu(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the tools run on it")
    main = {"mfu_profile": mfu_profile.main, "calib_debug": calib_debug.main}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
