"""The frame maker: one seed repeats its frames exactly, two seeds
differ, and a stream's clip never jumps."""

import numpy as np

import frames


def test_clip_repeats_for_a_seed_and_differs_between_seeds():
    big = 2 ** 31 + 11
    a = frames.clip(36, 48, 3, 8, 2.0, big, 0, "cpu")
    b = frames.clip(36, 48, 3, 8, 2.0, big, 0, "cpu")
    c = frames.clip(36, 48, 3, 8, 2.0, big + 1, 0, "cpu")
    d = frames.clip(36, 48, 3, 8, 2.0, big, 1, "cpu")
    assert a.shape == (3, 36, 48, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert (a != c).any() and (a != d).any()


def test_stills_repeat_for_a_seed_and_differ_between_seeds():
    a = frames.stills(36, 48, 3, (0.6, 1.0), 24, 2.0, 5, "cpu")
    b = frames.stills(36, 48, 3, (0.6, 1.0), 24, 2.0, 5, "cpu")
    c = frames.stills(36, 48, 3, (0.6, 1.0), 24, 2.0, 6, "cpu")
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_ping_pong_turns_round_without_a_jump():
    seq = [frames.ping_pong(t, 5) for t in range(12)]
    assert seq == [0, 1, 2, 3, 4, 3, 2, 1, 0, 1, 2, 3]
    assert all(abs(x - y) == 1 for x, y in zip(seq, seq[1:]))
    assert frames.ping_pong(0, 5, 4) == 4


def test_resize_matches_the_numpy_formula():
    import torch
    img = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    got = frames.resize_bilinear(torch.from_numpy(img), 7, 5).numpy()
    h, w = 4, 6
    ys = np.clip((np.arange(7) + 0.5) * h / 7 - 0.5, 0, h - 1)
    xs = np.clip((np.arange(5) + 0.5) * w / 5 - 0.5, 0, w - 1)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    f = img.astype(np.float64)
    want = ((f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx) * (1 - wy)
            + (f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx) * wy)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_stills_pool_and_order_are_drawn_from_the_seed():
    import harness
    cfg = {"height": 24, "width": 32}
    traffic = {"loop": "stills", "pool": 6, "crop_scale": [0.6, 1.0],
               "brightness": 24, "noise_sigma": 2.0}
    Loop = harness.driver(traffic["loop"]).Loop
    runs = [Loop(cfg, traffic, s, "cpu", None) for s in (1, 1, 2)]
    seqs = [[r.images(t)[1][0] for t in range(6)] for r in runs]
    assert seqs[0] == seqs[1] and seqs[0] != seqs[2]
    assert sorted(seqs[0]) == sorted(seqs[2]) == list(range(6))
    np.testing.assert_array_equal(runs[0].pool, runs[1].pool)
    assert (runs[0].pool != runs[2].pool).any()
    np.testing.assert_array_equal(runs[0].images(7)[0], runs[1].images(7)[0])
