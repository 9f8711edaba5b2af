#!/usr/bin/env bash
# Compare this tree with another (its parent) on one GPU, in turns:
# chip_smoke.py in the other tree, this one, this one, the other, each log
# in output/ab/<n>_<parent|change>.log, then scripts/vit_stack_bits.py
# on both trees (the digests that must not move).  Prints each run's exit
# code, its wall seconds and its [time] lines.
#
#   git archive <parent> | tar -x -C output/parent
#   bash scripts/ab_chip_smoke.sh output/parent
set -uo pipefail
cd "$(dirname "$0")/.."
other=${1:?usage: ab_chip_smoke.sh OTHER_TREE}
mkdir -p output/ab
rc=0
n=0
for tree in "$other" . . "$other"; do
  n=$((n + 1))
  name=$([ "$tree" = . ] && echo change || echo parent)
  log="output/ab/${n}_${name}.log"
  t0=$(date +%s%N)
  (cd "$tree" && python3 chip_smoke.py) > "$log" 2>&1
  run=$?
  ms=$((($(date +%s%N) - t0) / 1000000))
  echo "[ab] run $n ($name): exit $run in $((ms / 1000)).$(printf %03d $((ms % 1000))) s"
  [ "$run" -eq 0 ] || rc=1
  grep -E '^\[time\] (mhsa|noess|vit_stack |vit_stack_bwd |essential|eval|train|bilinear|bench_cross_torch)' \
    "$log" | cut -c1-240
done
for tree in "$other" .; do
  echo "[ab] bits of $tree"
  python3 scripts/vit_stack_bits.py --tree "$tree" || rc=1
done
exit $rc
