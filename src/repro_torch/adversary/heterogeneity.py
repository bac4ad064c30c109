"""Heterogeneity control (counterpart of ``repro.adversary.heterogeneity``;
ported: :func:`dirichlet_mnist`)."""

from __future__ import annotations

from typing import Optional

from repro_torch.data.synthetic import SyntheticMNIST


def dirichlet_mnist(n_workers: int = 10, alpha: Optional[float] = None,
                    per_worker: int = 800, seed: int = 0,
                    **kwargs) -> SyntheticMNIST:
    """``SyntheticMNIST`` with a Dirichlet(alpha) label split (``None`` =
    i.i.d.); the realised proportions are ``ds.label_props``."""
    return SyntheticMNIST(
        n_workers=n_workers, per_worker=per_worker, seed=seed,
        alpha_het=(1e6 if alpha is None else alpha), **kwargs)
