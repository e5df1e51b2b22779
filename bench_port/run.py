"""Run one cell of the benchmark of ``fast_slic_tpu_torch`` once.

    python3 bench_port/run.py --workload slic720.stream --seed 7 \\
        --seconds 20 --trace 0

From the root of a checkout, on a machine with an NVIDIA GPU.  The last
line of standard output is the result (JSON); the numbers compared with
the plain reference are also the last lines of standard error.  Exits 1
without a result when there is no GPU, too few of them, or when a module
of JAX or of the JAX package ``fast_slic_tpu`` was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
# one process with few threads: the host's cores are shared
os.environ.setdefault("OMP_NUM_THREADS", "1")
# every build and kernel cache inside the checkout, at a fixed path
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(HERE.parent / "build" / "bench_port" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness

    torch.set_num_threads(1)

    w = next((w for w in harness.load_spec()["workloads"]
              if w["name"] == args.workload), None)
    if w is None:
        print("no workload %r in BENCHMARK.json" % args.workload,
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print("needs %d CUDA device(s); torch.cuda.is_available() is %s"
              % (w["chips"], torch.cuda.is_available()), file=sys.stderr)
        return 1
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    result, checks, _ = harness.run_cell(args.workload, args.seed,
                                         args.seconds, bool(args.trace),
                                         "cuda", T0, log=log)
    bad = harness.forbidden_modules()
    if bad:
        log("loaded modules of JAX or the JAX package: %s" % ", ".join(bad))
        return 1
    for name, (value, limit) in checks.items():
        log("check %s: %r (limit %r)" % (name, value, limit))
    print(harness.result_line(result, checks), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
