"""Summarize an advmix_demo.sh run: read the sweep CSVs written by
`advmix_tpu_torch/tools/test_corruption.py:write_final_csv` and print
clean / mPC / rPC per arm plus the rPC and mPC deltas.

The port's copy of `scripts/demo_summary.py`, with the same output, byte
for byte. write_final_csv names columns by dataset family ("clean_mAP" /
"mean_corrupted_mAP" for COCO and synthetic, "clean_mean" /
"mean_corrupted_mean" for MPII) regardless of the evaluator's metric
label, and a summary reading the wrong key would print zeros: `read_arm`
raises instead.

Usage: python -m advmix_tpu_torch.scripts.demo_summary <workdir>
"""

import csv
import glob
import sys


def read_arm(work, tag):
    """(clean, mPC, rPC) of `<work>/results_<tag>.csv`."""
    path = sorted(glob.glob(f"{work}/results_{tag}.csv"))[-1]
    with open(path) as f:
        r = list(csv.DictReader(f))[-1]

    def col(prefix):
        for k in (f"{prefix}_mAP", f"{prefix}_mean", f"{prefix}_PCK"):
            if k in r:
                return float(r[k])
        raise KeyError(f"no {prefix}_* column in {path}: {list(r)}")

    clean = col("clean")
    mpc = col("mean_corrupted")
    return clean, mpc, (mpc / clean if clean else 0.0)


def main(work):
    print("\n=== AdvMix robustness demo summary ===")
    rows = {}
    tags = ["standard", "advmix"]
    # the equal-budget control: a standard arm trained as many epochs in
    # all as standard-then-advmix, so that the advmix deltas are not the
    # extra fine-tune epochs
    if glob.glob(f"{work}/results_standard400.csv"):
        tags.insert(1, "standard400")
    for tag in tags:
        clean, mpc, rpc = read_arm(work, tag)
        rows[tag] = (clean, mpc, rpc)
        print(f"{tag:12s} clean={clean:.4f}  mPC={mpc:.4f}  rPC={rpc:.4f}")
    control = "standard400" if "standard400" in rows else "standard"
    d = rows["advmix"][2] - rows[control][2]
    print(f"rPC delta (advmix - {control}): {d:+.4f}")
    dm = rows["advmix"][1] - rows[control][1]
    print(f"mPC delta (advmix - {control}): {dm:+.4f}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1])
