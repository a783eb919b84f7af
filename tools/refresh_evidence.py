"""Regenerate every committed accuracy-evidence artifact in one command.

Round-4's lesson (VERDICT r4 weak #2): eval JSONs committed in one commit
and code changed in the next leave the repo's evidence contradicting its
own test bounds.  This tool re-runs the evaluators and rewrites the
PARITY.md accuracy table from their outputs, so "refresh evidence" is one
command run in the same commit as any segmenter/pipeline change:

  python tools/refresh_evidence.py [n_per_cohort]

Produces / rewrites:
  * tools/eval_accuracy_results.json   (DEFAULT pipeline vs exact truth)
  * tools/eval_accuracy_sphere.json    (segmenter="sphere" A/B arm)
  * tools/eval_articular_results.json  (mask IoU + plane/NS vs parametric
                                        oracle, both segmenters)
  * PARITY.md accuracy table between the ACCURACY-TABLE markers

Each evaluator runs in its own subprocess, one after the other, on the
default backend; this parent process never initializes JAX, so only one
process holds the card at a time.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"

BEGIN = "<!-- ACCURACY-TABLE:BEGIN (generated by tools/refresh_evidence.py) -->"
END = "<!-- ACCURACY-TABLE:END -->"


def run(cmd):
    print(f"[refresh] $ {' '.join(cmd)}", flush=True)
    subprocess.run(cmd, check=True, cwd=ROOT)


def accuracy_table_md(n: int) -> str:
    acc = json.loads((TOOLS / "eval_accuracy_results.json").read_text())
    sph = json.loads((TOOLS / "eval_accuracy_sphere.json").read_text())
    art = json.loads((TOOLS / "eval_articular_results.json").read_text())

    lines = [
        BEGIN,
        "",
        "Ground-truth recovery of the clinical metrics on exact-truth "
        "synthetic cohorts",
        f"(n={n}/cohort, `tools/eval_accuracy.py`; DEFAULT config vs the "
        "`segmenter=\"sphere\"` A/B arm).",
        "Errors are (recovered − constructed truth); the frozen gate "
        "bounds live in `tests/test_accuracy_gate.py`.",
        "",
        "| cohort | segmenter | side acc | NS err mean / \\|max\\| (deg) | "
        "RV err mean / \\|max\\| (deg) | radius err mean / \\|max\\| (mm) |",
        "|---|---|---|---|---|---|",
    ]
    for cohort in ("healthy", "arthritic"):
        for label, data in (("default (unet)", acc), ("sphere", sph)):
            s = data[cohort]["summary"]
            lines.append(
                f"| {cohort} | {label} | {s['side_acc'] * 100:.0f}% "
                f"| {s['ns_err']['mean']:+.2f} / {s['ns_err']['abs_max']:.2f} "
                f"| {s['rv_err']['mean']:+.2f} / {s['rv_err']['abs_max']:.2f} "
                f"| {s['r_err']['mean']:+.2f} / {s['r_err']['abs_max']:.2f} |"
            )
    lines += [
        "",
        "Articular-mask quality vs the parametric oracle "
        "(`tools/eval_articular.py`, means):",
        "",
        "| cohort | n | unary IoU | sphere IoU | unet IoU | "
        "plane err sphere/unet (deg) | NS err sphere/unet (deg) |",
        "|---|---|---|---|---|---|---|",
    ]
    for name, s in art.items():
        lines.append(
            f"| {name} | {s['n']} | {s['iou_unary']:.3f} "
            f"| {s['iou_sphere']:.3f} | {s['iou_unet']:.3f} "
            f"| {s['plane_err_sphere_deg']:.2f} / {s['plane_err_unet_deg']:.2f} "
            f"| {s['ns_err_sphere_deg']:.2f} / {s['ns_err_unet_deg']:.2f} |"
        )
    lines += ["", END]
    return "\n".join(lines)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    run([sys.executable, "tools/eval_accuracy.py", str(n)])
    run([sys.executable, "tools/eval_accuracy.py", str(n), "sphere"])
    run([sys.executable, "tools/eval_articular.py", str(n)])

    table = accuracy_table_md(n)
    parity = (ROOT / "PARITY.md").read_text()
    block = re.compile(re.escape(BEGIN) + ".*?" + re.escape(END), re.S)
    if block.search(parity):
        parity = block.sub(table, parity)
    else:
        parity = parity.rstrip() + "\n\n## Accuracy table\n\n" + table + "\n"
    (ROOT / "PARITY.md").write_text(parity)
    print("[refresh] PARITY.md accuracy table rewritten")


if __name__ == "__main__":
    main()
