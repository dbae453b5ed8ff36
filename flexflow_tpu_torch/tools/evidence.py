"""Evidence runner on the card: idle calibration first, then the MFU
levers, then the device-trace profile.

The port's counterpart of the JAX package's ``tools/tpu_evidence.py``,
with its mechanics: every result is appended to the evidence file at
once, by an atomic replace (a kill mid-write never corrupts it); each
lever runs in a child process of its own (a fresh CUDA context); a child
past its timeout gets SIGINT, then SIGKILL after a grace window; a rerun
skips the levers the file already holds. Phases:

  A  calibrate the quiet card (``search/calibration.py::calibrate`` of
     the default suite, before anything else loads the card) into the
     user calibration cache (``calibration.cache_dir()``), never into
     the package;
  B  the levers, windowed bf16 (``tools/_bench.py::bench_one``): BERT-Base
     at batch 16, 32 and 64, BERT-Large at batch 16 and 32, and the
     searched strategy against data parallelism. The JAX runner's flash
     block sweep has no counterpart: the port's flash wrapper exposes no
     tile choice (each kernel's tiles are fixed per head dim), so the
     lever is recorded as not applicable, with that reason;
  C  ``mfu_profile --large`` (``MFU_PROFILE.json`` under
     ``torch_tools_out/``).

The JAX runner's ``bench.py`` and ``examples/serving_bench.py`` phases
run the JAX package; they have no counterpart until the port has a
benchmark of its own.

Usage:
    python -m flexflow_tpu_torch.tools.evidence [--skip-calibration] [--quick]
        [--device cpu] [--tiny] [--out PATH] [--child-timeout S]

``--quick`` runs the batch-32 BERT-Base lever alone (no calibration, no
sweep, no profile). ``--device cpu --tiny`` is a CPU
smoke run (a one-layer, 32-wide model). Results go to
``torch_tools_out/evidence.json``. Exit codes, the watcher's
(``evidence_watcher.sh``): 0 complete, 2 the probe found no card (nothing
recorded), 3 the card stopped answering after a child's timeout (what
was recorded stays).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

from ._bench import BERT_BASE, BERT_LARGE
from ._common import out_path

_CHILD = "_FF_TORCH_EVIDENCE_CHILD"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {"layers": 1, "hidden": 32, "heads": 2, "ff": 64}

EVIDENCE = None  # the evidence file (set by main)


def _load() -> dict:
    if EVIDENCE and os.path.exists(EVIDENCE):
        try:
            with open(EVIDENCE) as f:
                return json.load(f)
        except json.JSONDecodeError:
            pass
    return {"what": "on-chip evidence of the port (idle calibration + MFU levers)",
            "runs": []}


def _append(entry: dict) -> None:
    # atomic replace: a kill mid-write must never corrupt the file and
    # silently erase every previously recorded phase
    data = _load()
    data["runs"].append(entry)
    tmp = EVIDENCE + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(data, indent=1) + "\n")
    os.replace(tmp, EVIDENCE)
    print(f"recorded: {json.dumps(entry)[:200]}", file=sys.stderr)


def _env() -> dict:
    """This process's environment with the checkout on ``PYTHONPATH``
    (the children import the package from it)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_REPO, env.get("PYTHONPATH")) if p)
    return env


def _graceful_run(cmd, env=None, timeout=600.0, grace=60.0):
    """``subprocess.run`` with a SIGINT-first timeout: a child killed in
    the middle of a device operation gets ``grace`` seconds to unwind
    before SIGKILL. Returns (rc, stdout, stderr, timed out)."""
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
        return proc.returncode, out, err, False
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGINT)
        try:
            out, err = proc.communicate(timeout=grace)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        return proc.returncode, out or "", err or "", True


def _last_json(out: str):
    for line in reversed(out.strip().splitlines()):
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict):
            return obj
    return None


def _run_child(payload: dict, timeout: float):
    env = _env()
    env[_CHILD] = json.dumps(payload)
    rc, out, err, timed_out = _graceful_run(
        [sys.executable, "-m", "flexflow_tpu_torch.tools.evidence"], env=env, timeout=timeout)
    sys.stderr.write(err[-2000:])
    if timed_out:
        return None, f"timeout {timeout:g}s"
    obj = _last_json(out)
    if obj is not None and "error" not in obj:
        return obj, None
    return None, f"rc={rc}: {(err or out)[-400:]}"


# ---------------------------------------------------------------------------
# child: one measured configuration, fresh process
# ---------------------------------------------------------------------------


def child_main(payload: dict) -> int:
    import torch

    from ..core.device import resolve_device
    from ..ops.kernels import flash_attention as fa
    from . import _bench

    device =resolve_device(payload.get("device"))
    backend = "gpu" if device.type == "cuda" else "cpu"
    kind = torch.cuda.get_device_name(device) if backend == "gpu" else "cpu"
    peak = _bench.peak_flops_per_device(kind, backend)
    cfg = _bench.bert_config(payload, payload.get("seq", 128))
    batch = payload["batch"]
    model = _bench.build_bert(cfg, batch, payload.get("searched", False), device)
    n_params = _bench.param_count(model.executor)
    fa.reset_launch_counts()
    step = _bench.bench_one(model.executor, batch, cfg, payload.get("iters", 30))
    fpt = _bench.train_flops_per_token(n_params, cfg.num_layers, cfg.seq_length, cfg.hidden_size)
    print(json.dumps({
        "backend": backend, "device_kind": kind, "batch": batch, "seq": cfg.seq_length,
        "step_ms": round(step * 1e3, 3),
        "samples_per_s": round(batch / step, 1),
        "mfu": round(batch * cfg.seq_length / step * fpt / peak, 4),
        "params": n_params,
        "strategy_axes": dict(model.strategy.axis_sizes),
        "flash_launches": {k: v for k, v in fa.LAUNCHES.items() if v},
    }))
    return 0


# ---------------------------------------------------------------------------
# parent: orchestrate phases
# ---------------------------------------------------------------------------

_PROBE = """
import json, torch
if not torch.cuda.is_available():
    raise SystemExit("no CUDA device")
a = torch.randn(256, 256, device="cuda")
float((a @ a).sum())
print(json.dumps({"backend": "gpu", "kind": torch.cuda.get_device_name(0)}))
"""


def probe(device=None, timeout=150.0):
    """The card's name from a child that runs one matmul on it (None when
    it does not answer); ``device="cpu"`` probes nothing."""
    if device == "cpu":
        return {"backend": "cpu", "kind": "cpu"}
    rc, out, err, timed_out = _graceful_run([sys.executable, "-c", _PROBE],
                                            env=_env(), timeout=timeout)
    if timed_out or rc != 0:
        return None
    obj = _last_json(out)
    return obj if obj and obj.get("backend") == "gpu" else None


def calibrate_idle(kind: str):
    """Phase A: the quiet-card calibration, saved into the user cache."""
    code = f"""
import json
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.search.calibration import calibrate, chip_spec_for
machine = MachineSpec(num_nodes=1, devices_per_node=1, chip=chip_spec_for({kind!r}))
cal = calibrate(machine, device_kind={kind!r}, save=False)
path = cal.save()
print(json.dumps({{"entries": len(cal.entries), "derates": cal.derates,
                  "failed": cal.failed, "path": str(path)}}))
"""
    rc, out, err, timed_out = _graceful_run([sys.executable, "-c", code],
                                            env=_env(), timeout=1800)
    sys.stderr.write(err[-2000:])
    if timed_out:
        return None, "calibration timeout"
    obj = _last_json(out)
    if obj is not None and "entries" in obj:
        return obj, None
    return None, f"rc={rc}: {(err or '')[-400:]}"


def main(argv=None) -> int:
    global EVIDENCE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-calibration", action="store_true")
    ap.add_argument("--quick", action="store_true", help="the batch-32 BERT-Base lever alone")
    ap.add_argument("--device", default=None, help="cpu for a smoke run (default: the card)")
    ap.add_argument("--tiny", action="store_true", help="a one-layer 32-wide model")
    ap.add_argument("--out", default=None, help="default: torch_tools_out/evidence.json")
    ap.add_argument("--child-timeout", type=float, default=1200.0)
    ap.add_argument("--iters", type=int, default=None, help="steps a timed window")
    args = ap.parse_args(argv)
    EVIDENCE = args.out or out_path("evidence.json")

    info = probe(args.device)
    if info is None:
        print("evidence: no CUDA device answered the probe; nothing recorded", file=sys.stderr)
        return 2
    print(f"device up: {info}", file=sys.stderr)

    prior = _load()["runs"]
    done = {r.get("config") for r in prior
            if r.get("phase") in ("lever", "flash_block_sweep")
            and ("step_ms" in r or "not_applicable" in r)}
    if any(r.get("phase") == "calibration_idle" and r.get("entries") for r in prior):
        args.skip_calibration = True
    if args.quick:
        args.skip_calibration = True  # the lever alone

    if not args.skip_calibration:
        t0 = time.time()
        cal, err = calibrate_idle(info["kind"])
        if cal is not None:
            _append({"phase": "calibration_idle", "seconds": round(time.time() - t0, 1),
                     **{k: cal.get(k) for k in ("entries", "derates", "failed", "path")}})
        else:
            _append({"phase": "calibration_idle", "error": err})

    base, large = (TINY, TINY) if args.tiny else (BERT_BASE, BERT_LARGE)
    configs = [
        ("bert_base_b16_dp", {**base, "batch": 16}),
        ("bert_base_b32_dp", {**base, "batch": 32}),
        ("bert_base_b64_dp", {**base, "batch": 64}),
        ("bert_large_b16_dp", {**large, "batch": 16, "iters": 12}),
        ("bert_large_b32_dp", {**large, "batch": 32, "iters": 12}),
        ("bert_base_b32_searched", {**base, "batch": 32, "searched": True}),
        ("bert_large_b16_searched", {**large, "batch": 16, "iters": 12, "searched": True}),
    ]
    if args.quick:
        configs = [c for c in configs if c[0] == "bert_base_b32_dp"]
    for name, payload in configs:
        if name in done:
            continue
        payload = dict(payload, device=args.device)
        if args.iters:
            payload["iters"] = args.iters
        if args.tiny:
            payload["seq"] = 8
        obj, err = _run_child(payload, timeout=args.child_timeout)
        _append({"phase": "lever", "config": name, **(obj or {"error": err})})
        if obj is None and "timeout" in (err or ""):
            # a killed child may have left the card unusable: re-probe
            # before spending more configs
            if probe(args.device, timeout=120) is None:
                _append({"phase": "abort", "reason": "card unresponsive after child timeout"})
                return 3
    if not args.quick and "flash_block_sweep" not in done:
        _append({"phase": "flash_block_sweep", "config": "flash_block_sweep",
                 "not_applicable": True,
                 "reason": "the port's flash wrapper exposes no tile choice: each kernel's "
                           "tiles are fixed per head dim in csrc/flash_attention.cu"})

    done_phases = {r.get("phase") for r in prior if r.get("rc") == 0}
    if not args.quick and "mfu_profile_large" not in done_phases:
        cmd = [sys.executable, "-m", "flexflow_tpu_torch.tools.mfu_profile", "--large",
               "--batch", "16", "--iters", "8"]
        if args.device:
            cmd += ["--device", args.device]
        if args.tiny:
            cmd += ["--layers", "1", "--seq", "8"]
        rc, out, err, timed_out = _graceful_run(cmd, env=_env(), timeout=1500)
        if timed_out:
            _append({"phase": "mfu_profile_large", "error": "timeout"})
        else:
            line = out.strip().splitlines()[-1] if out.strip() else ""
            entry = {"phase": "mfu_profile_large", "rc": rc, "stdout": line[:2000]}
            if rc != 0:
                entry["error"] = (err or "")[-400:]
            _append(entry)
    print(f"evidence complete: {EVIDENCE}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    if os.environ.get(_CHILD):
        sys.exit(child_main(json.loads(os.environ[_CHILD])))
    sys.exit(main())
