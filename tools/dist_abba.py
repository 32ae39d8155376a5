#!/usr/bin/env python3
"""Time the two-worker data-parallel step (chip_smoke.py's phase
dist_train) of two trees of the port on one NVIDIA card, in turns:
A B B A.

    python3 tools/dist_abba.py OTHER_TREE [--order ABBA] [--out FILE]

``OTHER_TREE`` is another checkout of the repository (for example the
parent commit unpacked by ``git archive`` into a git-ignored directory);
B is the tree this script lies in. Each turn runs that tree's own
``chip_smoke.py --phases dist_train`` from its root (each tree builds its
kernels into its own ``build/`` and asserts its own launch counts), and
keeps from its ``dist_train`` line, per worker: the median step, the
step split on the host clock (forward and backward, push, pull,
update), the wire bytes and the twobit launches of one step. Prints one
JSON line per turn and then the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
KEEP = ("median_step_ms", "step_ms", "split_step_ms", "tokens_per_s",
        "allreduce_int8_ms")


def _turn(side, tree):
    run = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", "dist_train"],
        capture_output=True, text=True, timeout=900, cwd=tree)
    lines = run.stdout.strip().splitlines()
    found = [json.loads(ln) for ln in lines if ln.startswith("{")
             and '"phase": "dist_train"' in ln]
    if not found or not any(ln.startswith("phases run:") for ln in lines):
        raise SystemExit(f"turn {side} in {tree} failed ({run.returncode})"
                         f":\n{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
    d = found[-1]
    workers = []
    for w in d["per_worker"]:
        counts = w["launches_per_step"]
        workers.append({
            **{k: w[k] for k in KEEP},
            "wire_bytes_per_step": w["wire_bytes_per_step"][0],
            "twobit_launches_per_step": {
                f: n for f, n in counts.items() if f.startswith("twobit")}})
    return {"side": side, "tree": tree,
            "tokens_per_s_total": d["tokens_per_s_total"],
            "workers": workers}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other", help="the other tree (A)")
    p.add_argument("--order", default="ABBA")
    p.add_argument("--out", help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    trees = {"A": str(Path(args.other).resolve()), "B": str(HERE)}
    lines = []
    for side in args.order:
        line = _turn(side, trees[side])
        lines.append(line)
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps({**line, "card": smi}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
