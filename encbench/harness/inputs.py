"""Inputs of a cell, made on its device from the seed.

A configuration's ``content`` names the generator and its parameters:

* ``photo-1f``: a pool of distinct photos with natural-image statistics:
  a luminance field and two smoother colour-difference fields, each with a
  1/f^alpha amplitude spectrum and random phases, normalised to zero mean
  and unit deviation, mixed into correlated R, G and B around mid-grey,
  with a little white sensor noise;
* ``ycck-planes``: BASELINE config 5's planes (x * 255 // w, y * 255 // h,
  (x + y) * 255 // (w + h), (x ^ y) % 160) with noise in [-20, 20), as
  ``benchmarks/config5_device.py``'s ``make_ycck`` makes them, the noise
  drawn on the device.

The same seed on the same device gives the same pixels.  The pool is
handed to the program as ordinary host numpy arrays, as a caller holds
them.
"""

from __future__ import annotations

import numpy as np
import torch


def _field(h, w, alpha, gen, device):
    fy = torch.fft.fftfreq(h, device=device)[:, None]
    fx = torch.fft.rfftfreq(w, device=device)[None, :]
    f = torch.sqrt(fx * fx + fy * fy)
    f[0, 0] = 1.0
    amp = f ** -alpha
    amp[0, 0] = 0.0
    phase = 2 * torch.pi * torch.rand((h, w // 2 + 1), generator=gen,
                                      device=device)
    field = torch.fft.irfft2(torch.polar(amp, phase), s=(h, w))
    return (field - field.mean()) / field.std()


def photo_1f(width, height, seed, device, *, pool, alpha, chroma_alpha,
             contrast, chroma, sensor_noise):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for _ in range(pool):
        lum = _field(height, width, alpha, gen, device)
        u = _field(height, width, chroma_alpha, gen, device) * chroma
        v = _field(height, width, chroma_alpha, gen, device) * chroma
        rgb = torch.stack([lum + 1.402 * v, lum - 0.344 * u - 0.714 * v,
                           lum + 1.772 * u], -1)
        noise = torch.randn(rgb.shape, generator=gen, device=device)
        px = 128.0 + contrast * rgb + sensor_noise * noise
        out.append(px.round().clamp(0, 255).to(torch.uint8).cpu().numpy())
    return out


def ycck_planes(width, height, seed, device, *, pool, noise):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    x = torch.arange(width, device=device, dtype=torch.int32)
    for _ in range(pool):
        rows = []
        for y0 in range(0, height, 1024):  # bounds the int16 temporaries
            y = torch.arange(y0, min(y0 + 1024, height), device=device,
                             dtype=torch.int32)[:, None]
            base = torch.stack(torch.broadcast_tensors(
                x * 255 // width, y * 255 // height,
                (x + y) * 255 // (width + height), (x ^ y) % 160), -1)
            base = base + torch.randint(-noise, noise, base.shape,
                                        generator=gen, device=device,
                                        dtype=torch.int32)
            rows.append(base.clamp(0, 255).to(torch.uint8))
        out.append(torch.cat(rows).cpu().numpy())
    return out


GENERATORS = {"photo-1f": photo_1f, "ycck-planes": ycck_planes}


def make(config: dict, seed: int, device) -> list:
    """The configuration's input pool: (H, W, C) uint8 host arrays."""
    content = dict(config["content"])
    kind = content.pop("kind")
    pool = GENERATORS[kind](config["width"], config["height"], int(seed),
                            torch.device(device), **content)
    for px in pool:
        if px.shape != (config["height"], config["width"], config["channels"]):
            raise ValueError(f"{kind} made {px.shape}")
    return [np.ascontiguousarray(px) for px in pool]
