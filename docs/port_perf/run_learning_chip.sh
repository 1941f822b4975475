#!/bin/sh
# The three full-width learning runs of docs/port_perf/learning_chip_run.txt
# on one NVIDIA H100, through the port's own drivers, from the repository's
# root:
#
#   OUT=<dir> sh docs/port_perf/run_learning_chip.sh
#
# (a) the CD-like main corpus (seed 1, bias 0.5, ood 0.35, signal 1.0), (b)
# the disjoint stress corpus (seed 0, bias 0.25, ood 0.6, signal 0.5), (c)
# three training seeds a model on (a)'s corpus and vocabulary. 24 epochs at
# cfgs/charades_cd_i3d.yml's width each. Each run's log and learning.json
# land in $OUT (required); the corpora (2.5 GB each) and run directories
# in a temporary directory, removed at the end.
set -e
OUT=${OUT:?set OUT to the directory for the logs and learning.json files}
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)' | tee -a "$OUT/card.txt"

run() {
    name=$1
    shift
    t0=$(date +%s)
    python3 -m shufflingvideosfortsg_torch.run_learning --out "$WORK/$name" "$@" \
        > "$OUT/$name.log" 2>&1
    echo "$name: $(( $(date +%s) - t0 )) s wall" | tee -a "$OUT/card.txt"
    cp "$WORK/$name/learning.json" "$OUT/$name.json"
}

run a --seed 1
run b --seed 0 --bias-frac 0.25 --ood-frac 0.6 --signal 0.5
mkdir -p "$WORK/c"
ln -s "$WORK/a/corpus" "$WORK/c/corpus"
run c --seed 1 --multi-seed 3 --words-dir "$WORK/a/data/Charades/words"
