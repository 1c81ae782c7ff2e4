#!/bin/bash
# Whole smoke runs of two unpacked trees in turn, on one card, in one
# command, so their command times compare on one host:
#
#   git archive PARENT | tar -x -C results/parent
#   git archive "$(git write-tree)" | tar -x -C results/change
#   bash scripts/chip_ab.sh LOG_DIR results/parent results/change
#
# Each tree's `python3 chip_smoke.py` runs in its own directory, its
# output to LOG_DIR/<name>.log, each line led by the seconds since the
# run began and a tab (a phase's seconds: the gap between its line and
# the line before it); prints each exit code and wall seconds.
set -u
log_dir=$1
shift
mkdir -p "$log_dir"
for dir in "$@"; do
    name=$(basename "$dir")
    t0=$(date +%s.%N)
    (cd "$dir" && python3 chip_smoke.py) 2>&1 | python3 -c '
import sys, time
t0 = time.perf_counter()
for line in iter(sys.stdin.readline, ""):
    sys.stdout.write(f"{time.perf_counter() - t0:.1f}\t{line}")
    sys.stdout.flush()' > "$log_dir/$name.log"
    rc=${PIPESTATUS[0]}
    t1=$(date +%s.%N)
    echo "$name rc $rc wall $(python3 -c 'import sys; print(float(sys.argv[2]) - float(sys.argv[1]))' "$t0" "$t1") s"
    tail -n 1 "$log_dir/$name.log"
done
