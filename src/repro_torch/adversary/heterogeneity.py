"""(G, B)-gradient-dissimilarity: controlling and measuring heterogeneity
(counterpart of ``repro.adversary.heterogeneity``).

The paper's guarantees hold under the (G, B)-gradient-dissimilarity model

    (1/h) sum_i ||grad f_i(x) - grad f(x)||^2  <=  G^2 + B^2 ||grad f(x)||^2

for all x, f the honest average loss. This module controls it (Dirichlet
label partitions: :func:`dirichlet_proportions`, :func:`partition_pool`,
:func:`dirichlet_mnist`; ``alpha -> inf`` is the i.i.d. split), summarises a
realised split (:func:`label_histograms`, :func:`label_skew`) and measures it
(:func:`gb_probe`: per-worker gradients at perturbed parameter points, then
the nonnegative least-squares fit of ``(G^2, B^2)``).

The numpy helpers are the reference's, so the same ``np.random.Generator``
gives the same partitions. :func:`gb_probe` takes its gradients with
``torch.func`` (``vmap`` over probe points of ``vmap`` over workers) and
its Gaussian offsets from a seeded ``torch.Generator`` (the reference draws
them from a threefry key; a test passes those as ``offsets``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.data.synthetic import SyntheticMNIST
from repro_torch.utils import tree as T


def dirichlet_proportions(rng: np.random.Generator, n_workers: int,
                          n_classes: int, alpha: float) -> np.ndarray:
    """Per-worker label proportions ``[n_workers, n_classes]`` drawn from
    Dirichlet(alpha) (large alpha -> uniform/homogeneous)."""
    return rng.dirichlet([alpha] * n_classes, size=n_workers)


def partition_pool(rng: np.random.Generator, labels: np.ndarray,
                   n_workers: int, alpha: float) -> List[np.ndarray]:
    """Dirichlet label partition of a pooled dataset (Hsu et al.): for each
    class, shuffle its indices and split them among the workers with
    Dirichlet(alpha) weights. One index array per worker; every pool index
    goes to exactly one worker."""
    labels = np.asarray(labels)
    out: List[list] = [[] for _ in range(n_workers)]
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        w = rng.dirichlet([alpha] * n_workers)
        cuts = (np.cumsum(w)[:-1] * len(idx)).astype(np.int64)
        for worker, part in enumerate(np.split(idx, cuts)):
            out[worker].extend(part.tolist())
    return [np.asarray(o, np.int64) for o in out]


def label_histograms(labels: np.ndarray, n_classes: int) -> np.ndarray:
    """Normalised per-worker label histograms ``[n_workers, n_classes]``
    from stacked worker labels ``[n_workers, m]``."""
    labels = np.asarray(labels)
    hists = np.stack([np.bincount(row, minlength=n_classes)
                      for row in labels]).astype(np.float64)
    return hists / np.maximum(hists.sum(axis=1, keepdims=True), 1.0)


def label_skew(hists: np.ndarray) -> float:
    """Mean total-variation distance between each worker's label histogram
    and the pooled mix: 0 for i.i.d. splits, -> (n-1)/n for single-class
    workers."""
    hists = np.asarray(hists, np.float64)
    pooled = hists.mean(axis=0)
    return float(0.5 * np.abs(hists - pooled).sum(axis=-1).mean())


def dirichlet_mnist(n_workers: int = 10, alpha: Optional[float] = None,
                    per_worker: int = 800, seed: int = 0,
                    **kwargs) -> SyntheticMNIST:
    """``SyntheticMNIST`` with a Dirichlet(alpha) label split (``None`` =
    i.i.d.); the realised proportions are ``ds.label_props``."""
    return SyntheticMNIST(
        n_workers=n_workers, per_worker=per_worker, seed=seed,
        alpha_het=(1e6 if alpha is None else alpha), **kwargs)


@dataclasses.dataclass(frozen=True)
class GBEstimate:
    """Empirical (G, B)-dissimilarity fit: ``dissimilarity[k] = (1/h) sum_i
    ||g_i - gbar||^2`` and ``grad_sq[k] = ||gbar||^2`` at probe point k;
    ``G``, ``B`` the nonnegative least-squares intercept and slope of the
    first on the second (``dissimilarity <= G^2 + B^2 grad_sq``)."""

    G: float
    B: float
    dissimilarity: np.ndarray
    grad_sq: np.ndarray


def gb_probe(loss_fn: Callable[[Any, Any], torch.Tensor], params0: Any,
             worker_batches: Any, *, f: int = 0, n_probes: int = 8,
             radius: float = 0.5, seed: int = 0,
             offsets: Any = None) -> GBEstimate:
    """Probe the (G, B)-dissimilarity of a worker split.

    Per-worker gradients of ``loss_fn`` at ``params0`` and at ``n_probes -
    1`` Gaussian perturbations of scale ``radius`` (``offsets``, ``[n_probes
    - 1, D]``, replaces the draw from ``torch.Generator`` seeded with
    ``seed``), the first ``f`` (Byzantine) workers dropped, then the fit of
    ``dissimilarity = G^2 + B^2 ||grad f||^2`` in float64 over the probe
    points. ``worker_batches`` is one round's batches, stacked on a leading
    worker axis; everything runs on ``params0``'s device."""
    if n_probes < 2:
        raise ValueError("gb_probe needs at least 2 probe points")
    spec = T.make_flat_spec(params0)
    flat0 = T.tree_ravel(params0, spec)
    if offsets is None:
        gen = torch.Generator(device=flat0.device).manual_seed(seed)
        offsets = radius * torch.randn((n_probes - 1, flat0.shape[0]),
                                       generator=gen, device=flat0.device,
                                       dtype=flat0.dtype)
    if not isinstance(offsets, torch.Tensor):
        offsets = torch.from_numpy(np.array(offsets, np.float32))
    offsets = offsets.to(flat0.device, flat0.dtype)
    if offsets.shape != (n_probes - 1, flat0.shape[0]):
        raise ValueError(f"offsets must be [{n_probes - 1}, "
                         f"{flat0.shape[0]}], got {tuple(offsets.shape)}")
    points = torch.cat([flat0[None], flat0[None] + offsets])
    batches = T.tree_map(lambda a: torch.as_tensor(a).to(flat0.device),
                         worker_batches)
    grad_fn = torch.func.vmap(torch.func.vmap(torch.func.grad(loss_fn),
                                              in_dims=(None, 0)),
                              in_dims=(0, None))
    grads = T.lanes_ravel(grad_fn(T.stacked_unravel(points, spec), batches),
                          spec)[:, f:]  # [points, h, D]
    gbar = grads.mean(dim=1)
    v = (grads - gbar[:, None]).square().sum(dim=-1).mean(dim=-1)
    s = gbar.square().sum(dim=-1)
    v = v.detach().cpu().numpy().astype(np.float64)
    s = s.detach().cpu().numpy().astype(np.float64)
    # least-squares slope and intercept, population normalisation in both
    var_s = float(np.mean(np.square(s - s.mean())))
    cov_sv = float(np.mean((s - s.mean()) * (v - v.mean())))
    b2 = max(0.0, cov_sv / var_s) if var_s > 1e-12 else 0.0
    g2 = max(0.0, float(v.mean() - b2 * s.mean()))
    return GBEstimate(G=float(np.sqrt(g2)), B=float(np.sqrt(b2)),
                      dissimilarity=v, grad_sq=s)
