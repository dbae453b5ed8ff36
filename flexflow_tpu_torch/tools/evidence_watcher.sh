#!/bin/bash
# Rerun the port's evidence runner until it completes.
#   bash flexflow_tpu_torch/tools/evidence_watcher.sh [evidence.py arguments]
# The runner's exit codes: 0 complete (stop); 2 the probe found no card
# (nothing recorded: retry); 3 the card stopped answering after a child's
# timeout (what was recorded stays: retry, the rerun skips it). Any other
# code is not an outage: stop. The watcher exits with the runner's last
# code. FF_EVIDENCE_ATTEMPTS (default 90) and FF_EVIDENCE_SLEEP seconds
# between attempts (default 300) bound the retries; the log goes to
# torch_tools_out/evidence.log in the checkout.
cd "$(dirname "$0")/../.." || exit 1
mkdir -p torch_tools_out
log=torch_tools_out/evidence.log
attempts=${FF_EVIDENCE_ATTEMPTS:-90}
pause=${FF_EVIDENCE_SLEEP:-300}
rc=2
for i in $(seq 1 "$attempts"); do
  echo "=== watcher attempt $i $(date -u +%H:%M:%S) ===" >> "$log"
  python3 -m flexflow_tpu_torch.tools.evidence "$@" >> "$log" 2>&1
  rc=$?
  echo "=== runner rc=$rc ===" >> "$log"
  if [ $rc -eq 0 ]; then break; fi
  if [ $rc -ne 2 ] && [ $rc -ne 3 ]; then
    echo "=== unexpected rc=$rc: not an outage, stopping ===" >> "$log"
    break
  fi
  if [ "$i" -lt "$attempts" ]; then sleep "$pause"; fi
done
exit $rc
