"""Run one cell of the benchmark once and print its result line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With --trace 0 the line carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics read from a
torch.profiler trace of a fixed number of the window's operations. The
numbers compared with the reference come last, on standard error and
under "checks" in the line. Exits non-zero, printing no result, without
as many CUDA devices as the cell asks for, or if JAX or wah_tpu was loaded.
"""
import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# caches of the libraries under the program, at fixed paths in the
# checkout (the program builds its kernels into wah_tpu_torch/_build/)
CACHES = {
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TRITON_CACHE_DIR": "triton",
    "CUDA_CACHE_PATH": "nv",
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gpubench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(CHECKOUT / ".gpubench_cache" / sub)

    import torch

    from gpubench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              started=_STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"gpubench: modules loaded that the port must not load: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
