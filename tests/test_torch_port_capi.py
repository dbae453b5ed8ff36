"""The port's native host side against the JAX package on the CPU: the
model C API over ``flexflow_tpu_torch`` (``_native/src/model_capi.cc``,
built into the port's ``libffcore.so``) and its C driver, and the
DataLoader's native gather.

The C driver (``_native/src/c_model_driver.c``) is compiled once with
``gcc`` against the port's library and libpython and run on the CPU
through a fresh embedded interpreter that finds the package by
``PYTHONPATH`` alone: JAX's loop (the MLP_Unify shape, grad_accum_steps 2
from the JSON config, falling loss, softmax rows summing to 1:
``C_MODEL_OK``), then its multi-head attention leg; every loss equals the
same calls through the port's Python API here (rtol 1e-6: the same ops
on the same data). The DataLoader's batches equal the JAX package's
``SingleDataLoader`` gathers for float32, int64 and bfloat16 data over
two shuffled epochs, through the native gather and through the fallback
that ``FF_NATIVE_DISABLE=1`` selects.
"""
import json
import os
import shutil
import subprocess
import sys
import sysconfig

import ml_dtypes
import numpy as np
import pytest
import torch

import flexflow_tpu_torch._native as native
from flexflow_tpu.runtime import dataloader as jdl
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.types import ActiMode, LossType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.runtime import SGDOptimizer
from flexflow_tpu_torch.runtime import dataloader as tdl

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "flexflow_tpu_torch", "_native", "src")
MHA = {"width": 32, "heads": 4, "seq": 8, "batch": 4, "layers": 2, "steps": 3}


def _lcg(state, n):
    out = []
    for _ in range(n):
        state = (state * 1103515245 + 12345) & 0xFFFFFFFF
        out.append(state)
    return state, out


def _uniform(words):
    return [((w >> 16 & 0x7FFF) / 32768.0 - 0.5) * 2.0 for w in words]


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    cc = shutil.which(os.environ.get("CC", "gcc")) or shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler")
    assert "ffc_model_create_json" in open(native._LIB_PATH, "rb").read().decode("latin-1")
    exe = str(tmp_path_factory.mktemp("capi") / "c_model_driver")
    libdir = str(native._BUILD_DIR)
    pylib = sysconfig.get_config_var("LIBDIR")
    subprocess.run([cc, "-O1", os.path.join(SRC, "c_model_driver.c"),
                    "-I", os.path.join(REPO, "native", "include"),
                    "-I", sysconfig.get_path("include"), "-L", libdir, "-lffcore",
                    "-L", pylib, f"-lpython{sysconfig.get_config_var('LDVERSION')}",
                    f"-Wl,-rpath,{libdir}", f"-Wl,-rpath,{pylib}", "-o", exe],
                   check=True, capture_output=True, text=True, timeout=120)
    # a hermetic embedded interpreter: the checkout on PYTHONPATH alone
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([exe, "cpu", *(str(MHA[k]) for k in (
        "width", "heads", "seq", "batch", "layers", "steps"))],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, f"stdout:{proc.stdout}\nstderr:{proc.stderr[-3000:]}"
    return proc.stdout


def _losses(stdout, leg):
    return [float(line.split()[4]) for line in stdout.splitlines()
            if line.startswith(f"{leg} step ")]


def test_c_driver_runs_jax_loop_on_the_cpu(driver):
    assert "C_MODEL_OK" in driver and "C_MHA_OK" in driver
    mlp = _losses(driver, "mlp")
    assert len(mlp) == 5 and mlp[-1] < mlp[0]
    # the same MLP through the Python API: the JSON config's
    # grad_accum_steps, SGD 0.05, the C driver's batch
    m = FFModel(FFConfig(batch_size=16, workers_per_node=1, num_nodes=1, search_budget=0,
                         grad_accum_steps=2), device="cpu")
    x = m.create_tensor((16, 32), name="x")
    h = m.dense(x, 64, ActiMode.RELU, name="fc1")
    m.softmax(m.dense(h, 8, name="fc2"), name="sm")
    m.compile(optimizer=SGDOptimizer(lr=0.05),
              loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    state, words = _lcg(12345, 16 * 32)
    xb = np.asarray(_uniform(words)).reshape(16, 32).astype(np.float32)
    _, words = _lcg(state, 16)
    yb = (np.asarray(words) % 8).astype(np.int32)
    want = [float(m.executor.train_batch([xb], yb)["loss"]) for _ in range(5)]
    np.testing.assert_allclose(mlp, want, rtol=1e-6)


def test_c_driver_attention_leg_equals_the_python_api(driver):
    got = _losses(driver, "mha")
    b, s, w = MHA["batch"], MHA["seq"], MHA["width"]
    m = FFModel(FFConfig(batch_size=b), device="cpu")
    t = m.create_tensor((b, s, w), name="x")
    for _ in range(MHA["layers"]):
        t = m.multihead_attention(t, t, t, w, MHA["heads"])
    m.dense(t, w, ActiMode.NONE, name="head")
    m.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
    state, words = _lcg(777, b * s * w)
    x = np.asarray(_uniform(words)).reshape(b, s, w).astype(np.float32)
    _, words = _lcg(state, b * s * w)
    y = np.asarray(_uniform(words)).reshape(b, s, w).astype(np.float32)
    want = [float(m.executor.train_batch([x], y)["loss"]) for _ in range(MHA["steps"])]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < got[0]
    # the counts the driver printed through its interpreter: the CPU
    # takes the plain versions, which launch nothing
    line = next(l for l in driver.splitlines() if l.startswith("FLASH_LAUNCHES "))
    counts = json.loads(line.split(" ", 1)[1])
    assert set(counts) == {f"{k}{f}" for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                           for f in ("", "_bf16", "_f16")}
    assert not any(counts.values())


def test_create_json_routes_the_device_key(tmp_path):
    """``"device"`` goes to FFModel (default cuda, which raises without a
    card); every other key to FFConfig."""
    src = open(os.path.join(SRC, "model_capi.cc")).read()
    assert 'PyDict_GetItemString(kwargs, "device")' in src
    assert 'PyUnicode_FromString("cuda")' in src
    assert "flexflow_tpu." not in src.replace("flexflow_tpu_torch", "")
    assert "jax" not in src.lower().replace("the jax package", "")


# ------------------------------------------------------------ DataLoader
def _datasets():
    rs = np.random.RandomState(3)
    f32 = rs.randn(40, 3, 5).astype(np.float32)
    return {"float32": f32, "int64": rs.randint(-2**40, 2**40, (40, 7)).astype(np.int64),
            "bfloat16": f32.astype(ml_dtypes.bfloat16)}


@pytest.mark.parametrize("native_on", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "int64", "bfloat16"])
def test_loader_batches_equal_jax(dtype, native_on, monkeypatch):
    data = _datasets()[dtype]
    if not native_on:  # what FF_NATIVE_DISABLE=1 leaves both packages with
        monkeypatch.setattr(tdl, "_native_gather", False)
        monkeypatch.setattr(jdl, "_native_gather", False)
    native.reset_call_counts()
    jl = jdl.SingleDataLoader(data, 8, shuffle=True, seed=5)
    tl = tdl.SingleDataLoader(data, 8, shuffle=True, seed=5, device="cpu")
    n = 0
    for _ in range(2):
        order = jl._order()
        for b, got in enumerate(tl.batches()):
            want = jl._gather(order[b * 8:(b + 1) * 8])
            if dtype == "bfloat16":
                assert got.dtype == torch.bfloat16
                got = got.view(torch.int16).numpy().view(np.uint16)
                want = want.view(np.uint16)
            np.testing.assert_array_equal(got.numpy() if hasattr(got, "numpy") else got, want)
            n += 1
        jl.next_epoch()
        tl.next_epoch()
    assert n == 10
    # the port's gathers (JAX's answer through the same library function)
    calls = native.CALLS["batch_gather"]
    if native_on:
        assert calls >= n
    else:
        assert calls == 0


def test_native_disable_selects_index_select():
    code = ("from flexflow_tpu_torch.runtime import dataloader as d\n"
            "assert d._get_native_gather() is None\n"
            "import torch\n"
            "l = d.SingleDataLoader(torch.arange(12.).reshape(6, 2), 2, device='cpu')\n"
            "assert [b.tolist() for b in l.batches()][0] == [[0., 1.], [2., 3.]]\n")
    env = dict(os.environ, FF_NATIVE_DISABLE="1", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
