"""Compare one kernel source's SASS between two checkouts, function by function.

    python3 -m flexflow_tpu_torch.tools.sass_compare PARENT_DIR [--source flash_attention.cu]

Builds ``ops/kernels/csrc/<source>`` of this checkout and of the checkout
at PARENT_DIR with nvcc (the flags of ``ops/kernels/_build.py``, both at
once), disassembles both with cuobjdump and compares every function the
parent's library holds, keyed by its name past the source's
anonymous-namespace hash: instruction for instruction and encoding for
encoding. cuobjdump pads every line to the widest line in its file and
numbers branch labels across the whole module, so a kernel added to the
source changes both in functions it leaves alone; whitespace is collapsed
and labels are renumbered within each function before comparing. Prints,
by form (fp32, bf16, other), how many of the parent's functions are
identical, and the first difference of each that is not; exits 1 if any
differs or is missing. Needs nvcc and cuobjdump, not a GPU.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path


def _sass(so: Path, cuobjdump: str) -> dict:
    """{function name past the namespace hash: its normalized lines}."""
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    funcs, name, labels = {}, None, {}
    for line in text.splitlines():
        m = re.search(r"Function : \S*?_cu_[0-9a-f]{8}(\S+)", line)
        if m:
            name, labels = m.group(1), {}
            funcs[name] = []
            continue
        s = line.strip()
        if name is None or not s or s.startswith(("Function", "...")):
            continue
        s = re.sub(r"^/\*[0-9a-f]{4,}\*/", "", s)  # the address
        s = re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(m.group(0), f".L{len(labels)}"), s)
        funcs[name].append(" ".join(s.split()))
    return funcs


def main(argv=None) -> int:
    from flexflow_tpu_torch.ops.kernels import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="root of the checkout to compare against")
    ap.add_argument("--source", default="flash_attention.cu", help="the .cu file under csrc/")
    args = ap.parse_args(argv)
    nvcc = _build.find_nvcc()
    if nvcc is None:
        print("sass_compare: nvcc not found", file=sys.stderr)
        return 2
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    out = _build.BUILD_DIR / "sass_compare"
    out.mkdir(parents=True, exist_ok=True)
    sources = {"parent": args.parent / "flexflow_tpu_torch/ops/kernels/csrc" / args.source,
               "this": _build.CSRC_DIR / args.source}
    procs = {side: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(out / f"{side}.so"),
                                     str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for side, src in sources.items()}
    for side, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(f"sass_compare: nvcc failed on {sources[side]}\n{err[-4000:]}", file=sys.stderr)
            return 2
    parent, this = (_sass(out / f"{side}.so", cuobjdump) for side in ("parent", "this"))
    differ = 0
    for form, pick in (("fp32", lambda k: "EfE" in k),
                       ("bf16", lambda k: "13__nv_bfloat16" in k),
                       ("other", lambda k: "EfE" not in k and "13__nv_bfloat16" not in k)):
        names = [k for k in parent if pick(k)]
        same = [k for k in names if this.get(k) == parent[k]]
        print(f"{args.source}, {form}: {len(same)} of the parent's {len(names)} functions "
              f"identical ({len(this)} functions in this checkout's library)")
        for k in sorted(set(names) - set(same)):
            differ += 1
            mine = this.get(k)
            first = None if mine is None else next(
                ((i, a, b) for i, (a, b) in enumerate(zip(parent[k], mine)) if a != b),
                ("length", len(parent[k]), len(mine)))
            print(f"  {k[:80]}: " + ("missing" if mine is None else f"first difference {first}"))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
