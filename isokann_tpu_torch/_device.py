"""Device and random-generator policy shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another.  With no GPU and no explicit device this raises rather
    than carrying on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def make_generator(seed=None) -> torch.Generator:
    """A host (CPU) ``torch.Generator`` from an int seed; a generator
    passes through, ``None`` seeds from the OS."""
    if isinstance(seed, torch.Generator):
        return seed
    g = torch.Generator()
    if seed is None:
        g.seed()
    else:
        g.manual_seed(int(seed))
    return g


def draw_seed(gen: torch.Generator) -> int:
    """A 63-bit integer seed for a kernel's counter-based generator."""
    return int(torch.randint(0, 2**63 - 1, (1,), generator=gen,
                             dtype=torch.int64))
