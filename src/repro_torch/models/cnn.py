"""The paper's Section-4 model (counterpart of ``repro.models.cnn``): a small
CNN (11,958 parameters) for 10-class 28x28 grayscale images.

Parameters keep the reference's layouts so the flat vector is identical:
convolution kernels in HWIO, dense weights as ``[din, dout]``, images as
NHWC. The layouts are converted at the convolution (OIHW, NCHW), and the
feature map is flattened in H, W, C order before ``fc1`` as JAX does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F


def cnn_init(seed: int = 0, n_classes: int = 10,
             device: Optional[torch.device] = None) -> Dict:
    """Random parameters from a seeded ``torch.Generator`` (not the
    reference's draws: parity tests carry the reference's parameters across
    with ``repro_torch.testing.from_jax_params``)."""
    gen = torch.Generator().manual_seed(int(seed))

    def conv(h, w, cin, cout):
        scale = 1.0 / math.sqrt(h * w * cin)
        return {"w": torch.randn((h, w, cin, cout), generator=gen) * scale,
                "b": torch.zeros((cout,))}

    def fc(din, dout):
        scale = 1.0 / math.sqrt(din)
        return {"w": torch.randn((din, dout), generator=gen) * scale,
                "b": torch.zeros((dout,))}

    params = {
        "conv1": conv(3, 3, 1, 8),
        "conv2": conv(3, 3, 8, 8),
        "fc1": fc(8 * 7 * 7, 28),
        "fc2": fc(28, n_classes),
    }
    dev = torch.device("cpu" if device is None else device)
    return {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}


def _conv2d(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME convolution of NCHW ``x`` with an HWIO kernel."""
    y = F.conv2d(x, p["w"].permute(3, 2, 0, 1), padding=1)
    return y + p["b"][:, None, None]


def cnn_apply(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """images: [B, 28, 28, 1] (NHWC) -> logits [B, 10]."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(torch.relu(_conv2d(params["conv1"], x)), 2)
    x = F.max_pool2d(torch.relu(_conv2d(params["conv2"], x)), 2)
    # back to NHWC before flattening: fc1.w's rows are in (H, W, C) order
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def cnn_loss(params: Dict, batch) -> torch.Tensor:
    """batch: {'images': [B,28,28,1], 'labels': [B]} -> mean CE loss."""
    logits = cnn_apply(params, batch["images"])
    ll = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(ll, batch["labels"][:, None].long(),
                                 dim=-1).mean()


def cnn_accuracy(params: Dict, batch) -> torch.Tensor:
    logits = cnn_apply(params, batch["images"])
    return (logits.argmax(-1) == batch["labels"]).float().mean()
