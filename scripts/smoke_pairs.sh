#!/usr/bin/env bash
# Paired chip_smoke.py runs of two trees in one call, in the order
# parent, change, change, parent, over the named phases:
#
#     git archive PARENT | tar -x -C build/parent      # a gitignored dir
#     scripts/smoke_pairs.sh build/parent golden,sweep build/pairs
#
# A fourth argument names the parent's phases when they differ (a phase
# the change adds):
#
#     scripts/smoke_pairs.sh build/parent mesh,shard,train build/pairs mesh,train
#
# Each run's standard output goes to OUT/{p1,c1,c2,p2}.log; the script
# prints the card's name and power limit, then each run's exit code, wall
# seconds and total line.  Compare the logs' phase seconds side by side,
# and their launch counts with scripts/smoke_counts.py.
set -u
parent=$1 only=$2 out=$3 parent_only=${4:-$2}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for r in p1 c1 c2 p2; do
  case $r in p*) d=$parent o=$parent_only ;; *) d=. o=$only ;; esac
  t=$(date +%s)
  (cd "$d" && python3 chip_smoke.py --only "$o") > "$out/$r.log" 2>&1
  rc=$?
  echo "$r rc=$rc wall=$(( $(date +%s) - t )) s"
  grep '"phase": "total"' "$out/$r.log"
done
