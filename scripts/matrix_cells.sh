#!/bin/bash
# Run result-matrix cells of the PyTorch port one after another on the card,
# each through scripts/matrix_cell_progress.py, and keep what each left:
#
#   bash scripts/matrix_cells.sh OUT_DIR "hopper cadm" "hopper vanilla 1"
#
# Each argument is "family model [seed]" (seed 0 by default). OUT_DIR gets
# the card's name and power limit, each cell's progress log, a copy of its
# results/torch/raw/<cell>.* files, and the card's clock, power draw and
# utilization every 30 s (nvidia-smi) while the cells run. Exits non-zero
# if any cell's run did.
out=$1
shift
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$out/card.txt"
nvidia-smi --query-gpu=timestamp,clocks.sm,power.draw,utilization.gpu \
    --format=csv -l 30 > "$out/smi_$(date +%s).csv" 2>&1 &
smi=$!
trap 'kill $smi' EXIT
rc=0
for c in "$@"; do
    set -- $c
    cell=$1__$2__s${3:-0}
    echo "=== $cell start $(date +%s)"
    python scripts/matrix_cell_progress.py --families "$1" --models "$2" \
        --seeds "${3:-0}" > "$out/$cell.log" 2>&1 || rc=$?
    tail -n 5 "$out/$cell.log"
    cp results/torch/raw/"$cell".* "$out"/ 2>/dev/null
    echo "=== $cell end $(date +%s) rc=$rc"
done
exit $rc
