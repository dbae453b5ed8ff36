"""The port's perfwatch (``python -m flexflow_tpu_torch.tools.perfwatch``)
against the JAX package's ``tools/perfwatch.py`` on the same histories:
the same report lines, verdicts and exit codes for a passing trajectory,
a regression, a noisy metric whose spread widens its floor, a failed
latest run excluded from the baseline, too little history, malformed
lines and no file at all."""
import json
import sys

import pytest

from flexflow_tpu_torch.tools import perfwatch as tperfwatch
from tools import perfwatch as jperfwatch

pytestmark = pytest.mark.torch_port


def _line(i, metrics, mode="baseline", backend="cpu", ok=True):
    return json.dumps({"ts": f"2026-01-01T00:00:{i:02d}", "git_sha": f"c{i}",
                       "backend": backend, "mode": mode, "ok": ok, "metrics": metrics})


def _runs(values, key="decode_tokens_per_s", **kw):
    return [_line(i, {key: v, "ttft_p50_s": 0.01}, **kw) for i, v in enumerate(values)]


HISTORIES = {
    "pass": _runs([100.0, 102.0, 98.0, 101.0, 99.0]),
    "regress": _runs([100.0, 101.0, 99.0, 100.0, 70.0]),
    "improve": _runs([100.0, 101.0, 99.0, 100.0, 150.0]),
    # a metric whose history spreads wide: 3x MAD widens the 12% floor
    "noisy": _runs([100.0, 60.0, 140.0, 80.0, 120.0, 75.0]),
    "failed_latest_and_baseline": (
        _runs([100.0, 101.0, 99.0]) + [_line(8, {"decode_tokens_per_s": 10.0}, ok=False)]
        + [_line(9, {"decode_tokens_per_s": 97.0})]),
    "too_little": _runs([100.0, 50.0]),
    "abs_floor": _runs([0.01, 0.012, 0.011, 0.05], key="tracing_overhead", mode="trace_overhead"),
    "two_groups": _runs([100.0, 101.0, 99.0, 100.0]) + _runs([5.0, 5.1, 4.9, 2.0], backend="gpu"),
    "malformed": _runs([100.0, 101.0, 99.0, 100.0]) + ["{not json", "", '{"metrics": 3}'],
}


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_same_verdicts_and_exit_codes(tmp_path, capsys, name):
    path = tmp_path / "history.jsonl"
    path.write_text("\n".join(HISTORIES[name]) + "\n")
    for argv in (["--history", str(path)],
                 ["--history", str(path), "--baseline-n", "2", "--min-prior", "2"]):
        # the JAX tool parses sys.argv
        old, sys.argv = sys.argv, ["perfwatch"] + argv
        try:
            jrc = jperfwatch.main()
            jcap = capsys.readouterr()
        finally:
            sys.argv = old
        trc, tout, terr = _run(tperfwatch.main, argv, capsys)
        assert (trc, tout, terr) == (jrc, jcap.out, jcap.err)
    if name == "regress":
        assert trc == 1 and "REGRESSED" in tout


def test_missing_history_passes(tmp_path, capsys):
    missing = str(tmp_path / "none.jsonl")
    assert tperfwatch.main(["--history", missing]) == 0
    assert "no readable history" in capsys.readouterr().out
    assert tperfwatch.METRICS == jperfwatch.METRICS
