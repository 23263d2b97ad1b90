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
    """A host (CPU) ``torch.Generator`` from an int seed; a generator (or a
    ``WalkerShard``) passes through, ``None`` seeds from the OS."""
    if isinstance(seed, (torch.Generator, WalkerShard)):
        return seed
    g = torch.Generator()
    if seed is None:
        g.seed()
    else:
        g.manual_seed(int(seed))
    return g


class WalkerShard:
    """A generator as one rank of a walker-sharded batch sees it: the
    rank owns rows [start, start + n) of a batch of ``total`` walkers.

    Every draw through ``randn`` draws the whole batch's normals from
    ``gen`` and keeps the rank's rows, so that each row gets the noise an
    unsharded run gives it and every rank's ``gen`` advances as the
    unsharded run's does (a rank draws ``total / n`` times the normals it
    keeps: a few per cent of a step's work).  Kernel A keys its Philox
    noise by the global walker, ``start`` + the row."""

    def __init__(self, gen, start: int, total: int):
        self.gen, self.start, self.total = gen, int(start), int(total)

    @property
    def device(self):
        return self.gen.device


def randn(gen, shape, dtype=torch.float32, device=None):
    """Standard normals of ``shape`` from ``gen`` (a ``torch.Generator``
    or a ``WalkerShard``), drawn on ``device`` (default: the generator's);
    for a ``WalkerShard`` the rank's rows of the whole batch's draw."""
    if isinstance(gen, WalkerShard):
        z = torch.randn((gen.total, *shape[1:]), generator=gen.gen,
                        dtype=dtype, device=device or gen.device)
        return z[gen.start:gen.start + shape[0]]
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device or gen.device)


def draw_seed(gen) -> int:
    """A 63-bit integer seed for a kernel's counter-based generator."""
    if isinstance(gen, WalkerShard):
        gen = gen.gen
    return int(torch.randint(0, 2**63 - 1, (1,), generator=gen,
                             dtype=torch.int64))


def noise_generator(gen, device):
    """The generator of a recursion's per-step noise on ``device``:
    ``gen`` itself on the CPU, on the card a CUDA generator seeded by one
    draw of ``gen`` (for a ``WalkerShard``, of its generator, keeping its
    rows); None (no noise) for ``gen=None``."""
    device = torch.device(device)
    if gen is None or device.type == "cpu":
        return gen
    g = torch.Generator(device=device)
    g.manual_seed(draw_seed(gen))
    if isinstance(gen, WalkerShard):
        return WalkerShard(g, gen.start, gen.total)
    return g


def as_tensor(x, dtype=torch.float32, device=None):
    """``x`` as a tensor of ``dtype``: a tensor stays on its device, other
    arrays go to ``device`` (the card unless the caller names another)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))
