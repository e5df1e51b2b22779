"""PyTorch port: the candidate-list wrapper on the CPU.

``kernels.candidates.candidates`` takes its plain version (a sort of
(cell, visit key) pairs) for CPU tensors; it must equal the JAX package's
``build_candidates`` for one frame, stacked frames and a row shard's call
with ``key=``, OR its flag into a running one in place, and refuse a wrong
dtype, shape or device.  The CUDA kernel builds the same lists without a
sort: a cell's list is the subsequence, in four passes over the cluster
number (one a visit phase), of the clusters in its 3x3 neighbourhood.
:func:`_sort_free` is that algorithm in numpy, held here to the plain
version on the inputs that the kernel's tests on the card use in small
(``tests/test_torch_gpu.py`` holds the kernel to the plain version).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_slic_tpu import pipeline as jpipe
from fast_slic_tpu.config import StaticConfig as JaxConfig
from fast_slic_tpu_torch import pipeline as tpipe
from fast_slic_tpu_torch.config import StaticConfig
from fast_slic_tpu_torch.kernels import candidates as kc
from torch_threads import one_torch_thread  # noqa: F401


def _state(rng, B, K, H, W, lo=0.0, hi=None, active=0.85):
    hi = H - 1 if hi is None else hi
    y = rng.uniform(lo, hi, (B, K)).astype(np.float32)
    x = rng.uniform(0, W - 1, (B, K)).astype(np.float32)
    act = (rng.random((B, K)) < active).astype(np.int32)
    return y, x, act


def _sort_free(y, x, act, S, GH, GW, C, key=None):
    """The kernel's algorithm: a frame's cell row r keeps its band, the
    active clusters whose cell row lies in r-1..r+1, phase by phase in
    cluster order; each cell takes, in band order, those whose cell column
    lies in j-1..j+1."""
    B, K = y.shape
    T = 2 * S + 32
    cand = np.full((B, GH, GW, C), -1, np.int32)
    overflow = False
    for b in range(B):
        iy = np.trunc(y[b]).astype(np.int64)
        ix = np.trunc(x[b]).astype(np.int64)
        ci = np.clip(iy // S, 0, GH - 1)
        cj = np.clip(ix // S, 0, GW - 1)
        phase = (key[b] // K if key is not None
                 else 2 * ((iy // T) & 1) + ((ix // T) & 1))
        order = np.lexsort((np.arange(K), phase))    # phase-major, then k
        for r in range(GH):
            band = [k for k in order
                    if act[b, k] and abs(int(ci[k]) - r) <= 1]
            for j in range(GW):
                hits = [k for k in band if abs(int(cj[k]) - j) <= 1]
                cand[b, r, j, :min(len(hits), C)] = hits[:C]
                overflow |= len(hits) > C
    return cand, overflow


SORT_FREE_CASES = ["one_frame", "stacked_3", "shard_key", "none_active",
                   "one_active", "gh1", "gw1", "ragged", "k1"]


@pytest.mark.parametrize("C", [1, 4, 16])
@pytest.mark.parametrize("case", SORT_FREE_CASES)
def test_sort_free_order_matches_plain(case, C):
    rng = np.random.default_rng(SORT_FREE_CASES.index(case) * 7 + C)
    B, K, H, W, S = 1, 40, 70, 90, 11
    key = None
    if case == "stacked_3":
        B = 3
    if case == "gh1":
        H = 9
    if case == "gw1":
        W = 7
    if case == "ragged":
        W, S = 101, 13          # W not a multiple of S
    if case == "k1":
        K = 1
    y, x, act = _state(rng, B, K, H, W)
    if case == "shard_key":
        # a row shard's call: local y above and below its rows, keys of
        # the image's own coordinates (pipeline.visit_order_key)
        r0 = 140
        y, x, act = _state(rng, B, K, H, W, lo=-2.5 * S, hi=H + 2.5 * S)
        key = kc.visit_order_key(torch.from_numpy(y + r0),
                                 torch.from_numpy(x), S, K).numpy()
    if case == "none_active":
        act[:] = 0
    if case == "one_active":
        act[:] = 0
        act[0, K // 2] = 1
    GH, GW = -(-H // S), -(-W // S)
    got, ovf = kc.candidates(*map(torch.from_numpy, (y, x, act)), S, GH, GW,
                             C, None if key is None else torch.from_numpy(key))
    ref, ref_ovf = _sort_free(y, x, act, S, GH, GW, C, key)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert bool(ovf) == ref_ovf


@pytest.mark.parametrize("case", ["stacked_3", "shard_key"])
def test_wrapper_matches_jax(case):
    """Stacked frames (each the JAX package's single-frame build) and a row
    shard's call with ``key=``, through ``pipeline.build_candidates``."""
    rng = np.random.default_rng(5)
    H, W, K = 60, 80, 30
    cfg_t, cfg_j = StaticConfig(H=H, W=W, K=K), JaxConfig(H=H, W=W, K=K)
    if case == "stacked_3":
        y, x, act = _state(rng, 3, K, H, W)
        cand, ovf = tpipe.build_candidates_batched(
            *map(torch.from_numpy, (y, x, act)), cfg_t)
        for b in range(3):
            cj, oj = jpipe.build_candidates(jnp.asarray(y[b]),
                                            jnp.asarray(x[b]),
                                            jnp.asarray(act[b]), cfg_j)
            np.testing.assert_array_equal(cand[b].numpy(), np.asarray(cj))
        return
    S = cfg_t.S
    y, x, act = _state(rng, 1, K, H, W, lo=-2 * S, hi=H + 2 * S)
    key = jpipe.visit_order_key(jnp.asarray(y[0] + 40.0), jnp.asarray(x[0]),
                                cfg_j)
    cj, oj = jpipe.build_candidates(jnp.asarray(y[0]), jnp.asarray(x[0]),
                                    jnp.asarray(act[0]), cfg_j, key=key)
    cand, ovf = tpipe.build_candidates(
        *(torch.from_numpy(a[0]) for a in (y, x, act)), cfg_t,
        key=torch.from_numpy(np.asarray(key).astype(np.int64)))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(cj))
    assert bool(ovf) == bool(np.asarray(oj))


@pytest.mark.parametrize("running", [False, True])
def test_running_flag_is_or_ed_in_place(running):
    rng = np.random.default_rng(9)
    y, x, act = map(torch.from_numpy, _state(rng, 1, 40, 60, 80))
    flag = torch.tensor(running)
    for C, overflows in ((48, False), (2, True)):
        cand, got = kc.candidates(y, x, act, 10, 6, 8, C, overflow=flag)
        assert got is flag
        assert bool(flag) == (running or overflows)
        running = running or overflows


def test_wrapper_validates():
    rng = np.random.default_rng(3)
    y, x, act = map(torch.from_numpy, _state(rng, 2, 12, 30, 40))
    args = (10, 3, 4, 16)
    with pytest.raises(TypeError):
        kc.candidates(y.double(), x, act, *args)          # y dtype
    with pytest.raises(TypeError):
        kc.candidates(y, x, act.bool(), *args)            # is_active dtype
    with pytest.raises(TypeError):
        kc.candidates(y, x, act, *args, key=act)          # key dtype
    with pytest.raises(ValueError):
        kc.candidates(y, x[:, :-1], act, *args)           # shape
    with pytest.raises(ValueError):
        kc.candidates(y[0], x[0], act[0], *args)          # [K], not [B, K]
    with pytest.raises(ValueError):
        kc.candidates(y, x.to("meta"), act, *args)        # device
    with pytest.raises(ValueError):
        kc.candidates(y, x, act, *args,
                      overflow=torch.zeros(1, dtype=torch.bool))
