"""Deep-ensemble chi uncertainty; counterpart of ``isokann_tpu/ensemble.py``.

``ChiEnsemble`` trains E chi replicas on an ``Iso``'s data, architecture,
optimiser recipe and (fused) target at once, and their disagreement is a
pointwise estimate of the model's epistemic uncertainty, which
``resample_uncertainty`` uses to place new burst start points.

Where the reference vmaps its fused whole-run program over a leading
member axis, the port keeps the members' parameters stacked, (E, ...), in
one module (``StackedMLP``): each layer is one ``torch.baddbmm`` over the
members, the input LayerNorm has no affine of its own and each member its
gamma and beta.  One optimiser built by ``iso.opt`` over the stacked
tensors equals E separate optimisers, since Adam and SGD with coupled
weight decay act element by element.  Per iteration, as the reference's
vmapped program:

- each member's fused target from its own Kchi, without gradient;
- when the capacity bucket exceeds ``minibatch``, each member's own
  permutation of the bucket (gathered before the step);
- each member's own masked mean loss; the backward pass of their sum,
  which gives each member exactly its own gradient (the parameters are
  disjoint), so a member that collapses leaves the others' gradients
  finite.

On the card each optimizer step is replayed from a CUDA graph
(``iso.GraphedSteps``), as ``Iso``'s is.  ``run`` raises ``DomainError``
only when every member's losses of the run are non-finite.

chi is defined up to the relabeling chi -> 1 - chi, so
``chi_members(aligned=True)`` flips members anticorrelated with the first
finite member (1-output models) before any statistic.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ._device import make_generator
from .iso import GraphedSteps, fused_target, host_to, pad_bursts
from .models import ACTIVATIONS, MLP
from .targets import DomainError


class StackedMLP(nn.Module):
    """E ``MLP``s of one spec as stacked parameters: ``weights[l]`` (E, in,
    out), ``biases[l]`` (E, 1, out), and with a LayerNorm ``gamma`` and
    ``beta`` (E, 1, features), in ``spec``'s dtype.  Inputs are shared
    (n, f) or per member (E, n, f); outputs (E, n, nout).  Member e is
    drawn as the e-th of E ``MLP``s built from ``gen`` in turn
    (Glorot-uniform weights, zero biases)."""

    def __init__(self, spec: MLP, n_members: int, gen=None, device=None):
        super().__init__()
        self.sizes = spec.sizes
        self.activation = spec.activation
        self.lastactivation = spec.lastactivation
        self.layernorm = spec.layernorm
        self.n_members = int(n_members)
        gen = make_generator(gen)
        members = [MLP(self.sizes, self.activation, self.lastactivation,
                       self.layernorm, gen=gen, device=device)
                   for _ in range(self.n_members)]
        self.weights = nn.ParameterList(
            torch.stack([m.layers[i].weight.detach().T for m in members])
            for i in range(len(self.sizes) - 1))
        self.biases = nn.ParameterList(
            torch.stack([m.layers[i].bias.detach()[None] for m in members])
            for i in range(len(self.sizes) - 1))
        if self.layernorm:
            self.gamma = nn.Parameter(torch.stack(
                [m.ln.weight.detach()[None] for m in members]))
            self.beta = nn.Parameter(torch.stack(
                [m.ln.bias.detach()[None] for m in members]))
        self.to(spec.layers[0].weight.dtype)

    def forward(self, x):
        act = ACTIVATIONS[self.activation]
        lastact = ACTIVATIONS[self.lastactivation]
        E = self.n_members
        if self.layernorm:
            x = nn.functional.layer_norm(x, (x.shape[-1],), eps=1e-5)
            x = x * self.gamma + self.beta
        elif x.dim() == 2:
            x = x.expand(E, *x.shape)
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = torch.baddbmm(b, x, w)
            x = lastact(x) if i == last else act(x)
        return x

class ChiEnsemble(GraphedSteps):
    """E chi replicas sharing an ``Iso``'s data, architecture, optimiser
    recipe and target, trained at once.

    >>> ens = ChiEnsemble(iso, n_members=8, gen=0)
    >>> ens.run(100)                    # every member, one step a batch
    >>> ens.chi_std(xs).max()           # where the ensemble disagrees
    """

    def __init__(self, iso, n_members=8, gen=None):
        if not getattr(iso.target, "fused", False):
            raise ValueError(
                "ChiEnsemble requires a fusable target transform "
                "(TransformShiftscale); host-target transforms train "
                "member-by-member — loop over Iso instances instead.")
        self.iso = iso
        self.n_members = int(n_members)
        self.gen = make_generator(gen)
        device = iso.data.features.device
        self.model = StackedMLP(iso.model, self.n_members, gen=self.gen,
                                device=device)
        self.optimizer = iso.opt(self.model.parameters())
        self.losses: list = []          # one (E,) row an iteration
        self._init_graph()

    # ---- training ---------------------------------------------------------

    def run(self, n=1, epochs=1):
        """n Koopman iterations x ``epochs`` epochs for every member; the
        losses reach the host once."""
        iso = self.iso
        xs, mask, n_true, cap, bs, nb = iso._padded()
        ys = pad_bursts(iso.data.propfeatures, cap)
        E, d = self.n_members, self.model.sizes[-1]
        transform = torch.func.vmap(
            lambda k: iso.target.fused_target(k, mask, n_true))

        def members(v):                 # (cap, nk, f) -> (E, cap, nk, d)
            return self.model(v.reshape(-1, v.shape[-1])).reshape(
                E, *v.shape[:-1], d)

        losses = []
        for _ in range(n):
            target, w = fused_target(members, transform, ys, mask, n_true)
            for _ in range(epochs):
                losses.append(self._epoch(xs, target, w, mask, n_true, cap,
                                          bs, nb))
        losses = torch.stack(losses).cpu().numpy()            # (n, E)
        if not np.any(np.all(np.isfinite(losses), axis=0)):
            raise DomainError(
                "every ensemble member collapsed under training — reduce "
                "the learning rate or increase regularization")
        self.losses.extend(losses.tolist())
        return self

    def _eager_step(self, x, y, w, m, norm):
        self.optimizer.zero_grad(set_to_none=True)
        loss = torch.sum(((self.model(x) - y) * w) ** 2 * m[..., None],
                         dim=(1, 2)) / norm
        loss.sum().backward()
        self.optimizer.step()
        return loss.detach()

    def _epoch(self, xs, target, w, mask, n_true, cap, bs, nb):
        """One epoch of every member; (E,) losses."""
        if nb == 1 and bs == cap:
            return self._step(xs, target, w, mask, n_true)
        scale = cap / n_true
        E = self.n_members
        perm = host_to(self._permutations(cap)[:, :nb * bs], xs.device)
        ls = []
        for idx in perm.reshape(E, nb, bs).unbind(1):          # (E, bs)
            y = torch.gather(target, 1,
                             idx[..., None].expand(E, bs, target.shape[-1]))
            ls.append(self._step(xs[idx], y, w, mask[idx] * scale, bs))
        return torch.stack(ls).sum(dim=0) * bs / cap

    def _permutations(self, cap):
        """Each member's own permutation of the ``cap`` rows, (E, cap),
        from the ensemble's generator."""
        return torch.argsort(
            torch.rand((self.n_members, cap), generator=self.gen), dim=1)

    @property
    def finite_members(self):
        """Boolean (E,) mask of the members whose losses stayed finite."""
        if not self.losses:
            return np.ones(self.n_members, bool)
        return np.all(np.isfinite(np.asarray(self.losses)), axis=0)

    # ---- evaluation -------------------------------------------------------

    @torch.no_grad()
    def chi_members(self, xs=None, aligned=True):
        """Each finite member's chi at raw coordinates (default: the data's
        start points), (E, n, d).  ``aligned`` flips the members
        anticorrelated with the first (1-output models)."""
        data = self.iso.data
        feats = data.features if xs is None else data.features_of(xs)
        chi = self.model(feats)
        chi = chi[torch.as_tensor(self.finite_members, device=chi.device)]
        if aligned and chi.shape[-1] == 1 and len(chi) > 1:
            c = chi[..., 0].double()
            c = c - c.mean(dim=1, keepdim=True)
            corr = (c @ c[0]) / (c.norm(dim=1) * c[0].norm())
            chi = torch.where((corr < 0)[:, None, None], 1.0 - chi, chi)
        return chi

    def chi_mean(self, xs=None):
        return self.chi_members(xs).mean(dim=0)

    def chi_std(self, xs=None):
        """Pointwise epistemic uncertainty: the members' standard
        deviation of aligned chi (ddof 0), (n, d)."""
        return self.chi_members(xs).std(dim=0, correction=0)


def resample_uncertainty(iso, ensemble, ny=1, explore=0.0, gen=None):
    """Add ``ny`` burst start points where the chi ensemble disagrees most:
    the top-``ny`` data start points by ``ensemble.chi_std``, of which
    ``round(explore * ny)`` are replaced by uniform draws without
    replacement from the rest (against mode-locking).  Returns ``iso``,
    grown through ``iso.addcoords``."""
    gen = make_generator(gen)
    std = ensemble.chi_std().max(dim=-1).values.cpu().numpy()   # (n,)
    ny = min(int(ny), len(std))
    n_explore = int(round(explore * ny))
    order = np.argsort(-std)
    picks = list(order[:ny - n_explore])
    if n_explore:
        pool = np.setdiff1d(np.arange(len(std)), picks)
        idx = torch.randperm(len(pool), generator=gen)[:n_explore]
        picks.extend(pool[idx.numpy()])
    coords = iso.data.coords
    iso.addcoords(coords[torch.as_tensor(np.asarray(picks, np.int64),
                                         device=coords.device)])
    return iso
