"""The controls and the readings that the limits of ``correct`` are set
from: run a cell's timed window with something in the program's place and
print the numbers its comparison with the plain reference gives.

    python3 bench_port/control.py --workload slic720.stream \\
        --seeds 11 12 13 --seconds 5 [--program | --fault NAME ...]

Without ``--program`` or ``--fault`` the plain reference runs in the
program's place, weakened as the configuration's ``"control"`` says (LSC
in bfloat16, or equal distances given to the smallest cluster number
instead of the reference's visit order): the limits must fail it.  With
``--program`` the program itself runs, which gives the lower readings.
With ``--fault`` the program runs with each named fault of ``faults.py``
planted in turn, which the limits must fail too.  One JSON line a seed (and
fault).
"""

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))    # the program, which faults patch
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import faults  # noqa: E402
import harness  # noqa: E402
import loops  # noqa: E402
from reference import slic_ref  # noqa: E402


def control_options(cfg: dict) -> slic_ref.Options:
    c = dict(cfg["control"])
    if "lsc_dtype" in c:
        c["lsc_dtype"] = getattr(torch, c["lsc_dtype"])
    return slic_ref.Options(**c)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--fault", nargs="+", default=[],
                    choices=sorted(set(faults.SINGLE + faults.BATCH)))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, cfg, traffic = harness.cell(harness.load_spec(), args.workload)
    opts = control_options(cfg)
    make = None if args.program or args.fault else (
        lambda c, t, d: loops.ReferenceEntry(c, d, opts))
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    for seed in args.seeds:
        for fault in args.fault or [None]:
            undo = faults.plant(fault, traffic["loop"]) if fault else None
            try:
                result, _, numbers = harness.run_cell(
                    args.workload, seed, args.seconds, False, args.device,
                    make_entry=make, log=log)
            finally:
                if undo:
                    undo()
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "program": make is None, "fault": fault,
                "control": None if make is None else cfg["control"],
                "correct": result["correct"], "numbers": numbers,
                "attempted": result["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
