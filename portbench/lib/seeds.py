"""Seeds of the benchmark's generators, derived from ``--seed``.

Every random draw comes from a generator seeded by ``mix(seed, ...)``: a
page from (seed, page), a frame from (seed, client, frame). So any one page
or frame can be made again alone, by the reference after the window, and
the same seed always gives the same arrays on the same device type.
"""

from __future__ import annotations

import torch

_MASK = (1 << 64) - 1


def mix(*parts: int) -> int:
    """A 63-bit seed from integers of any size and sign (splitmix64 steps)."""
    z = 0x9E3779B97F4A7C15
    for p in parts:
        z = (z + (int(p) & _MASK) + 0x9E3779B97F4A7C15) & _MASK
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        z ^= z >> 31
    return z >> 1


def generator(device: torch.device | str, *parts: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(*parts))
    return g


# Tags that keep the streams of one seed apart.
PAGE, ORDER, FRAME, NOISE, SAMPLE = 1, 2, 3, 4, 5
