"""Frames the cells feed the program, made from ``--seed``.

The one natural image in the repository is fast-slic's fish picture
(``data/fish.npz``, 620x386).  A video clip is that image resized, panned
by a fixed number of pixels a frame, with Gaussian noise from the seed
(the frame maker of ``chip_smoke.py``); a stream plays its clip back and
forth, so the pan turns round and never jumps.  A still is a crop of the
image, scaled, maybe mirrored and shifted in brightness, resized to the
frame size, with noise.  Every seed gets the same sizes and pans; a
stream's noise differs from seed to seed, and the stills' crops, mirrors,
brightness and noise, and their order, are drawn from the seed.

Frames are made on the device with a ``torch.Generator`` in a few large
calls and come back to the host once: the program's callers hand it
numpy frames.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

FISH = pathlib.Path(__file__).resolve().parent / "data" / "fish.npz"


def fish() -> np.ndarray:
    """uint8 [386, 620, 3]."""
    with np.load(FISH) as f:
        return f["image"]


def resize_bilinear(img: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """float64 [H, W, C] of ``img`` [h, w, C], pixel centres aligned
    (``chip_smoke.py``'s ``resize_bilinear``, in torch)."""
    h, w = img.shape[:2]
    dev = img.device
    ys = ((torch.arange(H, device=dev, dtype=torch.float64) + 0.5) * h / H
          - 0.5).clamp(0, h - 1)
    xs = ((torch.arange(W, device=dev, dtype=torch.float64) + 0.5) * w / W
          - 0.5).clamp(0, w - 1)
    y0 = ys.floor().long()
    x0 = xs.floor().long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    f = img.to(torch.float64)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1009 + 7919 * stream) % (1 << 63))
    return g


def _noisy(base: torch.Tensor, sigma: float, g) -> torch.Tensor:
    noise = torch.randn(base.shape, generator=g, device=base.device,
                        dtype=torch.float64)
    return (base + sigma * noise).round().clamp(0, 255).to(torch.uint8)


def clip(H: int, W: int, n: int, pan: int, sigma: float, seed: int,
         stream: int, device) -> np.ndarray:
    """uint8 [n, H, W, 3]: the image resized to H x (W + pan (n - 1)),
    frame f its columns [pan f, pan f + W), plus noise."""
    img = torch.from_numpy(fish()).to(device)
    base = resize_bilinear(img, H, W + pan * (n - 1))
    g = _generator(seed, stream, device)
    frames = torch.stack([_noisy(base[:, pan * f:pan * f + W], sigma, g)
                          for f in range(n)])
    return frames.cpu().numpy()


def ping_pong(t: int, n: int, phase: int = 0) -> int:
    """The clip frame of call t when a clip of n frames plays back and
    forth, starting ``phase`` frames in."""
    if n == 1:
        return 0
    period = 2 * (n - 1)
    m = (t + phase) % period
    return m if m < n else period - m


def stills(H: int, W: int, count: int, scale, brightness: float,
           sigma: float, seed: int, device) -> np.ndarray:
    """uint8 [count, H, W, 3] independent images: each a crop of a share
    in ``scale`` of the image's sides at a random place, mirrored with
    probability 1/2, shifted in brightness by up to +-``brightness``,
    resized to H x W, plus noise."""
    img = torch.from_numpy(fish()).to(device)
    h, w = img.shape[:2]
    rng = np.random.default_rng([int(seed), 17])
    g = _generator(seed, 1 << 20, device)
    out = []
    for _ in range(count):
        s = rng.uniform(scale[0], scale[1])
        ch, cw = max(2, int(round(h * s))), max(2, int(round(w * s)))
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        crop = img[y0:y0 + ch, x0:x0 + cw]
        if rng.random() < 0.5:
            crop = crop.flip(1)
        base = resize_bilinear(crop, H, W) + rng.uniform(-brightness,
                                                         brightness)
        out.append(_noisy(base, sigma, g).cpu())
    return torch.stack(out).numpy()
