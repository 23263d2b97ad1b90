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


def noise_generator(gen, device):
    """The generator of a recursion's per-step noise on ``device``:
    ``gen`` itself on the CPU, on the card a CUDA generator seeded by one
    draw of ``gen``; None (no noise) for ``gen=None``."""
    device = torch.device(device)
    if gen is None or device.type == "cpu":
        return gen
    g = torch.Generator(device=device)
    g.manual_seed(draw_seed(gen))
    return g


def as_tensor(x, dtype=torch.float32, device=None):
    """``x`` as a tensor of ``dtype``: a tensor stays on its device, other
    arrays go to ``device`` (the card unless the caller names another)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))
