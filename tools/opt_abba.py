#!/usr/bin/env python3
"""Time the fused optimizer kernels (K1 SGD-momentum, K2 Adam) of two
trees of the port on one NVIDIA card, in turns: A B B A.

    python3 tools/opt_abba.py OTHER_TREE [--order ABBA] [--out FILE]

``OTHER_TREE`` is another checkout of the repository (for example the
parent commit unpacked by ``git archive`` into a git-ignored directory);
B is the tree this script lies in. Each turn is a fresh process that puts
its tree first on ``sys.path``, builds that tree's ``opt_step`` kernel
into that tree's ``build/``, and runs THIS tree's
``chip_smoke.opt_timing(plain=False)``, which uses only the families'
public wrappers: the same measurement (CUDA events ``ms``, profiler
kernel time ``device_ms``, host time per call ``host_us``, and the same
for ``torch.optim``'s fused steps) on both trees' kernels. Prints one
JSON line per turn and then the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

TURN = """
import importlib.util, json, sys
root, smoke = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("opt_abba_smoke", smoke)
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
if not m.mx.__file__.startswith(root):
    raise SystemExit(f"imported {m.mx.__file__}, not the tree at {root}")
m.build.build_all(["opt_step"])
print(json.dumps({"tree": root, **m.opt_timing(plain=False)}), flush=True)
"""


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other", help="the other tree (A)")
    p.add_argument("--order", default="ABBA")
    p.add_argument("--out", help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    trees = {"A": str(Path(args.other).resolve()), "B": str(HERE)}
    lines = []
    for side in args.order:
        run = subprocess.run(
            [sys.executable, "-c", TURN, trees[side],
             str(HERE / "chip_smoke.py")], capture_output=True, text=True,
            timeout=600, cwd=trees[side])
        if run.returncode != 0:
            raise SystemExit(f"turn {side} failed ({run.returncode}):\n"
                             f"{run.stdout[-4000:]}\n{run.stderr[-4000:]}")
        line = json.loads(run.stdout.strip().splitlines()[-1])
        line["side"] = side
        lines.append(line)
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps({**line, "card": smi}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
