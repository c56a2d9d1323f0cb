"""The benchmark's draw source: a frozen copy of the port's product
scheme (`TorchDraws` / `TorchStream`), handed to the program through
`RayTracer(draws=...)` and the train step's `draws` argument.

A host `torch.Generator` seeded from the run's seed draws one 63-bit
seed per sample; a sample draws its (n, 2) pixel jitter and each level's
(n, 3) Gaussians from a CUDA (or CPU) `torch.Generator` of its own,
seeded from the k-th number of a host generator seeded with the sample's
seed (k = 0 for the jitter, 1 + level for a level).  So the timed draws
cost what the product's cost, and the reference regenerates the same
numbers from the recorded sample seeds (`Stream(seed, device)`).
"""

from __future__ import annotations

import torch

SEED_LIMIT = 2 ** 63 - 1


def draw_seed(host: torch.Generator) -> int:
    return int(torch.randint(0, SEED_LIMIT, (1,), generator=host,
                             dtype=torch.int64))


class Stream:
    """One sample's draws (the port's `TorchStream` scheme)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self._host = torch.Generator()
        self._host.manual_seed(seed)
        self._seeds = []

    def _generator(self, k: int):
        while len(self._seeds) <= k:
            self._seeds.append(draw_seed(self._host))
        g = torch.Generator(device=self.device)
        g.manual_seed(self._seeds[k])
        return g

    def jitter(self, n: int):
        return torch.rand((n, 2), generator=self._generator(0),
                          device=self.device)

    def normal(self, level: int, n: int):
        return torch.randn((n, 3), generator=self._generator(1 + level),
                           device=self.device)


def sample_seeds(seed: int, count: int):
    """The seeds of the first `count` samples a `Draws(seed)` hands out."""
    host = torch.Generator()
    host.manual_seed(seed % SEED_LIMIT)
    return [draw_seed(host) for _ in range(count)]


class Draws:
    """The program's draw source (the port's `TorchDraws` scheme)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self._host = torch.Generator()
        self._host.manual_seed(seed % SEED_LIMIT)

    def next_sample(self, n: int):
        stream = Stream(draw_seed(self._host), self.device)
        return stream.jitter(n), stream
