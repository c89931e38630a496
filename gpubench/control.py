"""Answer a cell's operations with its configuration's control in the
program's place (gpubench/reference/control.py), at the cell's own sizes,
and print the numbers the check compares beside their limits. The check
has to find the control wrong: `correct` false.

    python3 -m gpubench.control --workload <cell> --seed <n> [--ops <k>]

--ops defaults to the cell's check sample, the number of outputs a run
compares in full. Needs the device the inputs are drawn on (CUDA); the
benchmark's own runs never run this.
"""
import argparse
import json
import sys

import torch

from gpubench import harness


def run_control(cell: harness.Cell, seed: int, ops: int, device) -> dict:
    traffic = cell.traffic
    module = harness.load_module(cell.root / "drivers" / f"{traffic['driver']}.py")
    driver = module.Driver(cell.config, traffic, seed, torch.device(device))
    driver.make_inputs()
    records, reservoir = [], harness.Reservoir(int(traffic["check_sample"]), seed)
    for i in range(ops):
        name, output, counts = driver.control_step(i)
        records.append(harness.Op(i, name, 0.0, 0.0, counts))
        reservoir.offer(i, output)
    checks = driver.check(records, reservoir.items)
    return {
        "workload": cell.name, "seed": seed, "ops": ops,
        "correct": all(v <= lim for v, lim in checks.values()),
        "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gpubench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--ops", type=int, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpubench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    ops = args.ops if args.ops is not None else int(cell.traffic["check_sample"])
    print(json.dumps(run_control(cell, args.seed, ops, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
