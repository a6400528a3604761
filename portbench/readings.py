#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the card.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,... [--out FILE]

For each seed, one process-local set-up of the cell and one unit of the
system (the benchmark's own path), then, once the system's state is freed:
  sound      the cell's numbers as a run judges them;
  control    the plain reference put in the system's place and computed in
             bfloat16 (every inserted value and accumulator rounded to it),
             judged as the system is: the upper reading of acc_rel_err;
  unchanged  csp_score_loss of a unit that left its parameters as it found
             them: the upper reading of csp_score_loss, which the control,
             computing no refinement, has none of.
One JSON line per seed; with --out also appended to FILE. Not run by the
benchmark's runs."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(unit):
    import torch

    from portbench.reference import recon

    sound = unit.judge()
    params, _ = unit.result
    ctl = [recon.rounded(a, torch.bfloat16)
           for a in unit.reference_acc(params, round_to=torch.bfloat16,
                                       dtype=torch.float32)]
    control = unit.judge(acc=ctl)
    unchanged = unit.judge(params=unit.unchanged_params())
    return sound, control, {"csp_score_loss": unchanged["csp_score_loss"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.lib import registry

    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    cell = registry.Cell(args.workload)
    mod = cell.unit_module()
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        unit = mod.Unit(cell.config, cell.traffic, seed, dev)
        unit.run()
        torch.cuda.synchronize()
        unit.release()
        torch.cuda.empty_cache()
        sound, control, unchanged = readings(unit)
        line = json.dumps({"workload": cell.name, "seed": seed, "sound": sound,
                           "control": control, "unchanged": unchanged})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del unit
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
