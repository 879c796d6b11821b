"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` a ``breakdown``, and last the
compared numbers beside their limits under ``checks``); the last lines of
standard error are the same numbers. The run needs a CUDA card: without
one, or with fewer cards than the cell asks for, it exits 3 and prints no
result. It also exits without a result (4) if JAX, jaxlib, flax or the JAX
package was loaded in this process by the time the window closed.
"""

from __future__ import annotations

import os
import time


def _process_age_s():
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import cells, harness, modcheck

    chips = int(cells.cell(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=T_START)
    bad = modcheck.forbidden_modules(sys.modules)
    if bad:
        print("portbench: the run loaded " + ", ".join(bad)
              + " (JAX or the JAX package); no result", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
