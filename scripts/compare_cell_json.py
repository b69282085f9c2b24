"""Compare two result-matrix cell JSONs (``results/torch/raw/<cell>.json``)
digit for digit: each top-level key, and every number of the history rows.

    python scripts/compare_cell_json.py A.json B.json
"""
import json
import math
import sys


def same(x, y) -> bool:
    return x == y or (isinstance(x, float) and isinstance(y, float)
                      and math.isnan(x) and math.isnan(y))


def main(argv) -> int:
    a, b = (json.load(open(p)) for p in argv[:2])
    for k in sorted(set(a) | set(b)):
        if k != "history":
            print(k, "equal" if a.get(k) == b.get(k) else "differs")
    n = diff = 0
    for ra, rb in zip(a["history"], b["history"]):
        for k in ra:
            n += 1
            if not same(ra[k], rb.get(k)):
                diff += 1
                if diff <= 5:
                    print(f"itr {ra['itr']} {k}: {ra[k]!r} vs {rb.get(k)!r}")
    print(f"history: {len(a['history'])} / {len(b['history'])} rows, {n} "
          f"numbers, {diff} differ")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
