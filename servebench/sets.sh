#!/bin/sh
# Runs of one cell on the chip: sets.sh OUTDIR CELL SET SECONDS TRACE SEED...
# saves each run's standard output as OUTDIR/<cell>.<set>.<seed>.json (its last
# line is the result) and its standard error as .err beside it.
out=$1; cell=$2; set=$3; seconds=$4; trace=$5; shift 5
mkdir -p "$out"
for seed in "$@"; do
  python3 servebench/run.py --workload "$cell" --seed "$seed" --seconds "$seconds" \
    --trace "$trace" > "$out/$cell.$set.$seed.out" 2> "$out/$cell.$set.$seed.err"
  echo "$cell $set $seed rc=$?"
  tail -n 1 "$out/$cell.$set.$seed.out" > "$out/$cell.$set.$seed.json"
  grep '^\[run\]' "$out/$cell.$set.$seed.out" | cut -c1-400
done
