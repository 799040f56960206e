#!/bin/bash
# Parent against change on one card: each named benchmark cell run from
# both trees in turns (parent, change, change, parent; the two sides of a
# pair share a seed). Run from the change's root, with the parent unpacked
# into a directory of the repo that .gitignore lists:
#
#   mkdir -p _archive/parent && git archive <parent> | tar -x -C _archive/parent
#   bash scripts/pair_benchmark.sh _archive/parent int8_batch64 bf16_batch64
#
# SEEDS (default "2718281828 3141592653") holds one seed a pair. Prints the
# card, then one line a run: side, cell, seed, correct and each metric's
# value. Each run's result line goes to $OUT/pair_benchmark.jsonl, its
# stderr to $OUT/pair_benchmark_<side>_<cell>.err (OUT defaults to
# pair_benchmark_out/ under the current directory).
set -u
parent=$1
shift
out=${OUT:-$PWD/pair_benchmark_out}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # side tree cell seed
  local line
  line=$(cd "$2" && python3 benchmark/run.py --workload "$3" --seed "$4" --seconds 10 --trace 0 \
         2>>"$out/pair_benchmark_$1_$3.err" | tail -1)
  echo "$1 $3 seed=$4 $line" >>"$out/pair_benchmark.jsonl"
  echo "$1 $3 seed=$4 $(echo "$line" | python3 -c 'import json, sys
d = json.loads(sys.stdin.read())
print(d["correct"], {k: v["value"] for k, v in d["metrics"].items()})' 2>&1)"
}
for cell in "$@"; do
  i=0
  for seed in ${SEEDS:-2718281828 3141592653}; do
    if [ $((i % 2)) -eq 0 ]; then
      run parent "$parent" "$cell" "$seed"; run change . "$cell" "$seed"
    else
      run change . "$cell" "$seed"; run parent "$parent" "$cell" "$seed"
    fi
    i=$((i + 1))
  done
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
