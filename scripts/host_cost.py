#!/usr/bin/env python3
"""Host cost of one ``kernels.cca.lookup`` call at 720p and one
``kernels.fsegsum.float_segsum`` call at LSC's 720p shape (N = 307,200
pixels, 11 rows, K = 1600) on a CUDA GPU, split into the parts the wrapper
of that tree does: the tensor checks, the output allocation, the stream
handle, and the ctypes call with its argument conversion (and the stream
handle); beside them the whole call and the PyTorch call that computes the
same function (``table[ids]``; an unweighted ``index_add_``).

    python3 scripts/host_cost.py [--root DIR] [--reps 1000]

``--root`` names the checkout whose ``fast_slic_tpu_torch`` is timed (default:
the one holding this script), so that two versions can be timed in turns in
one run on one card.  Each part runs ``reps`` times under the host clock
after a synchronize, with no synchronize inside; where a call's device
time exceeds its host time, the host waits on the launch queue and the
whole call reads the device's rate.  Prints one JSON line of microseconds
per call, with the card's name.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def per_call_us(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def lookup_parts(torch, _lib, cca, dev):
    n = 720 * 1280
    gen = torch.Generator(device=dev).manual_seed(0)
    L = torch.randint(0, n, (n,), generator=gen, dtype=torch.int32,
                      device=dev)
    rank = torch.randint(0, n, (n,), generator=gen, dtype=torch.int32,
                         device=dev)
    out = torch.empty_like(L)
    L_long = L.long()

    if hasattr(_lib, "stream"):   # entry points resolved once, int pointers
        stream = _lib.stream
        fn = _lib.FUNCS["fstt_lookup"]

        def allocation():
            return torch.empty_like(L)

        def call():
            fn(L.data_ptr(), rank.data_ptr(), out.data_ptr(), n, n, stream())
    else:                         # getattr per call, c_void_p pointers
        def stream():
            return torch.cuda.current_stream().cuda_stream

        def allocation():
            return torch.empty(L.shape, dtype=torch.int32, device=dev)

        def call():
            getattr(_lib.library(), "fstt_lookup")(
                _lib.ptr(L), _lib.ptr(rank), _lib.ptr(out), n, n, stream())

    def checks():
        _lib.check(L, "ids", torch.int32, dev)
        _lib.check(rank, "table", torch.int32, dev)

    return {
        "checks": checks,
        "allocation": allocation,
        "stream": stream,
        "call": call,
        "lookup": lambda: cca.lookup(L, rank),
        "table[ids]": lambda: rank[L_long],
    }


def fsegsum_parts(torch, _lib, fsegsum, dev):
    N, K, V = 307200, 1600, 11
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, K, (N,), generator=gen, dtype=torch.int32,
                        device=dev)
    mask = (torch.rand(N, generator=gen, device=dev) < 0.9).to(torch.int32)
    vals = torch.rand((V, N), generator=gen, device=dev)
    ids_long = ids.long()
    parts = {
        "fsegsum": lambda: fsegsum.float_segsum(ids, mask, vals, K, 10),
        "index_add_": lambda: torch.zeros((V, K + 1), device=dev).index_add_(
            1, ids_long, vals),
    }
    if hasattr(fsegsum, "scratch_size"):   # one C call, scratch from Python
        bins = K + 1
        n_scratch = fsegsum.scratch_size(N, bins)
        buf = torch.empty(V * bins + n_scratch, dtype=torch.int32,
                          device=dev)
        fn = _lib.FUNCS["fstt_fsegsum"]

        def checks():
            fsegsum._check_args(ids, mask, vals, K, 10)
            _lib.check(ids, "ids", torch.int32, dev)
            _lib.check(mask, "mask", torch.int32, dev)
            _lib.check(vals, "vals", torch.float32, dev)

        parts["fsegsum checks"] = checks
        parts["fsegsum allocation"] = lambda: torch.empty(
            V * bins + n_scratch, dtype=torch.int32, device=dev)
        parts["fsegsum call"] = lambda: fn(
            ids.data_ptr(), mask.data_ptr(), vals.data_ptr(), buf.data_ptr(),
            buf.data_ptr() + 4 * V * bins, n_scratch, N, V, bins, 10,
            _lib.stream())
    return parts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=1000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("host_cost: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from fast_slic_tpu_torch.kernels import _lib, cca, fsegsum

    dev = torch.device("cuda", torch.cuda.current_device())
    _lib.library()
    parts = {**lookup_parts(torch, _lib, cca, dev),
             **fsegsum_parts(torch, _lib, fsegsum, dev)}
    us = {k: per_call_us(f, args.reps) for k, f in parts.items()}
    torch.cuda.synchronize()
    print(json.dumps({"root": os.path.abspath(args.root), "reps": args.reps,
                      "device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__, "us_per_call": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
