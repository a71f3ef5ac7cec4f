#!/bin/sh
# Pre-snapshot gate: a green fast tier must not be mistaken for the
# full one. This ritual runs `./run_tests.sh --full` and records the tally,
# the HEAD it ran at, and whether the tree was dirty to
# docs/TESTS_r${ROUND}.json -- commit that artifact WITH the snapshot so
# the snapshot provably follows a green full-tier run.
#
#   make gate            (or: sh scripts/gate.sh)
#   ROUND=06 make gate   for a later round
set -u
cd "$(dirname "$0")/.."
ROUND=${ROUND:-05}
LOG=$(mktemp)
# No pipe here: in POSIX sh a pipeline's status is the LAST command's
# (tee's), which would record a red run as green -- the exact failure
# this gate exists to prevent. Write to the log, then show the tail.
./run_tests.sh --full > "$LOG" 2>&1
status=$?
tail -n 20 "$LOG"
python - "$LOG" "$status" "docs/TESTS_r${ROUND}.json" <<'EOF'
import datetime
import json
import re
import subprocess
import sys

log = open(sys.argv[1]).read()
status = int(sys.argv[2])
out = sys.argv[3]
counts = re.findall(
    r"(\d+) (passed|failed|error(?:s)?|skipped|deselected|xfailed|xpassed|"
    r"warning(?:s)?)", log)
tally = {}
for v, k in counts[-10:]:
    tally[k.rstrip("s") if k.startswith(("error", "warning")) else k] = int(v)
tail = [l for l in log.strip().splitlines()
        if re.search(r"\d+ (passed|failed|error)", l)]
run = lambda *a: subprocess.run(a, capture_output=True, text=True).stdout
rec = {
    "ritual": "./run_tests.sh --full (scripts/gate.sh)",
    "tally": tally,
    "exit_status": status,
    "green": status == 0,
    "head_commit_at_run": run("git", "rev-parse", "HEAD").strip(),
    "tree_dirty_at_run": run("git", "status", "--porcelain").strip() != "",
    "timestamp": datetime.datetime.now().isoformat(timespec="seconds"),
    "summary_line": tail[-1].strip() if tail else "",
}
json.dump(rec, open(out, "w"), indent=2)
open(out, "a").write("\n")
print(json.dumps(rec))
EOF
exit $status
