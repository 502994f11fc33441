"""Tabulates the held-out metrics of training runs from their
``train_log.csv`` (written by the port's ``Trainer.fit``,
``python -m cerberusnet_torch.cli``).

    python3 -m cerberusnet_torch.heldout_table runs/torch_cerberus_evidence/train_log.csv [...]

For each log: the five held-out metrics at every evaluated epoch, then the
median ms per step (an epoch's ``epoch_seconds`` over its steps: loading,
the step and its launches, evaluation excluded) and the training minutes
(the sum of ``epoch_seconds``).
"""

import csv
import statistics
import sys

METRICS = (("miou", "seg mIoU", 1), ("flow_epe", "flow EPE (px)", 1),
           ("flow_fl_all", "flow Fl-all (%)", 100),
           ("disp_mae", "disp MAE (px)", 1),
           ("disp_d1_all", "disp D1-all (%)", 100))


def table(path: str) -> str:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    evals = [r for r in rows if r.get("miou")]
    lines = [f"{path}", "",
             "| val metric | " + " | ".join(f"epoch {r['epoch']}"
                                           for r in evals) + " |",
             "|---" * (len(evals) + 1) + "|"]
    for key, label, scale in METRICS:
        lines.append(f"| {label} | " + " | ".join(
            f"{float(r[key]) * scale:.4g}" for r in evals) + " |")
    ms, prev = [], 0
    for r in rows:
        step = int(r["step"])
        if step > prev:
            ms.append(float(r["epoch_seconds"]) * 1e3 / (step - prev))
        prev = step
    lines += ["", f"ms per step, median over {len(ms)} epochs: "
                  f"{statistics.median(ms):.1f} (min {min(ms):.1f}, max "
                  f"{max(ms):.1f}); training minutes: "
                  f"{sum(float(r['epoch_seconds']) for r in rows) / 60:.2f}"]
    return "\n".join(lines)


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    print("\n\n".join(table(p) for p in sys.argv[1:]))
