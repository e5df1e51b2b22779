"""The controls and the readings that the limits of ``correct`` are set
from: run a cell's timed window with something in the program's place and
print the numbers its comparison with the plain reference gives.

    python3 bench_port/control.py --workload slic720.stream \\
        --seeds 11 12 13 --seconds 5 [--program | --fault NAME ...]

Without ``--program`` or ``--fault`` the workload's driver
(``drivers/<loop>.py``) puts its ``control_entry`` in the program's place:
the plain reference, weakened as the configuration's ``"control"`` says.
The limits must fail it.  With ``--program`` the program itself runs,
which gives the lower readings.  With ``--fault`` the program runs with
each named fault planted in turn, which the limits must fail too; the
choices are the faults that the driver's ``faults(cfg)`` lists for the
workload's configuration.  One JSON line a seed (and fault).
"""

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))    # the program, which faults patch
sys.path.insert(0, str(HERE))

import harness  # noqa: E402


def main(argv=None) -> int:
    first = argparse.ArgumentParser(add_help=False)
    first.add_argument("--workload")
    known, _ = first.parse_known_args(argv)
    choices = None
    if known.workload is not None:
        _, cfg, traffic = harness.cell(harness.load_spec(), known.workload)
        drv = harness.driver(traffic["loop"])
        choices = drv.faults(cfg)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--fault", nargs="+", default=[], choices=choices)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    make = None if args.program or args.fault else drv.control_entry
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    for seed in args.seeds:
        for fault in args.fault or [None]:
            undo = drv.plant(fault) if fault else None
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
                "control": None if make is None else cfg.get("control"),
                "correct": result["correct"], "numbers": numbers,
                "attempted": result["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
