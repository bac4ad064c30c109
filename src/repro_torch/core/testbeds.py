"""Built-in testbeds (counterpart of ``repro.core.sweep.quadratic_testbed``
and ``_mnist_testbed``)."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.adversary.heterogeneity import dirichlet_mnist
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.cnn import cnn_accuracy, cnn_init, cnn_loss


def quadratic_loss(params, batch) -> torch.Tensor:
    return 0.5 * torch.sum(torch.square(params["w"] - batch["target"]))


def quadratic_testbed(n_workers: int, d: int = 64, spread: float = 0.1,
                      seed: int = 0, targets: Optional[Any] = None,
                      device: DeviceLike = None):
    """Worker i holds target ``t_i`` and the local loss
    ``0.5 ||w - t_i||^2``, so the honest optimum (the mean of the honest
    targets) is known exactly.

    ``targets`` (``[n_workers, d]``) replaces the draw: the reference draws
    them with ``jax.random.normal``, which a parity test passes in. Without
    it they are ``N(0, 1) * spread + 1`` from a seeded ``torch.Generator``.

    Returns ``(loss_fn, params0, batch_fn, targets)`` on ``device``.
    """
    dev = resolve_device(device)
    if targets is None:
        gen = torch.Generator().manual_seed(int(seed))
        tg = torch.randn((n_workers, d), generator=gen) * spread + 1.0
    else:
        tg = torch.as_tensor(np.array(targets, np.float32))
        if tuple(tg.shape) != (n_workers, d):
            raise ValueError(f"targets of shape {tuple(tg.shape)}, expected "
                             f"{(n_workers, d)}")
    tg = tg.to(dev)
    params0 = {"w": torch.zeros(d, device=dev)}
    return quadratic_loss, params0, (lambda t: {"target": tg}), tg


def mnist_testbed(n_workers: int, per_worker: int = 800, batch: int = 60,
                  seed: int = 0, alpha_het: Optional[float] = None,
                  device: DeviceLike = None):
    """The paper's CNN on ``SyntheticMNIST``.

    Returns ``(loss_fn, params0, batch_fn, eval_fn, eval_batch)``; the
    batches are numpy (the simulator moves them to its device).
    """
    dev = resolve_device(device)
    ds = dirichlet_mnist(n_workers=n_workers, alpha=alpha_het,
                         per_worker=per_worker, seed=seed)
    eval_fn = lambda p, b: {"acc": cnn_accuracy(p, b)}  # noqa: E731
    return (cnn_loss, cnn_init(0, device=dev), ds.worker_batches(batch),
            eval_fn, ds.eval_batch)
