"""Checkpoints cross between the port and the reference
(``repro.checkpoint``): the same ``.npz`` keys in the same order, the
arrays bitwise, the step in ``.meta.json``, in both directions."""

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JC
from repro_torch import checkpoint as C
from repro_torch.utils.tree import tree_leaves


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"embed": rng.normal(size=(5, 3)).astype(np.float32),
            "layers": [{"w": rng.normal(size=(3, 3)).astype(np.float32),
                        "b": rng.normal(size=(3,)).astype(np.float32)},
                       {"w": rng.normal(size=(3, 3)).astype(np.float32),
                        "b": rng.normal(size=(3,)).astype(np.float32)}],
            "step_scale": np.arange(4, dtype=np.int32),
            "a_norm": (np.ones(3, np.float32), np.zeros(2, np.float32))}


def _torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def test_port_save_restores_in_the_reference(tmp_path):
    path = str(tmp_path / "ck" / "params")
    tree = _tree()
    assert C.save(path, {"params": _torch(tree)}, step=7,
                  metadata={"arch": "x"}) == path
    keys = list(np.load(path + ".npz").keys())
    assert keys == list(JC._flatten_with_paths({"params": tree}))
    back = JC.restore(path, {"params": tree})
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves({"params": tree})):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert np.asarray(a).dtype == b.dtype
    assert JC.latest_step(path) == C.latest_step(path) == 7


def test_reference_save_restores_in_the_port(tmp_path):
    path = str(tmp_path / "params.npz")
    tree = _tree(1)
    JC.save(path, {"params": tree}, step=3)
    like = {"params": _torch(_tree(2))}
    back = C.restore(path, like)
    assert back.keys() == like.keys()
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(
            {"params": tree})):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), b)
    assert isinstance(back["params"]["a_norm"], tuple)
    assert C.latest_step(path) == 3
    assert C.latest_step(str(tmp_path / "none")) is None


def test_restore_checks_shapes(tmp_path):
    path = str(tmp_path / "p")
    C.save(path, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        C.restore(path, {"w": torch.zeros(3, 2)})
    with pytest.raises(KeyError):
        C.restore(path, {"v": torch.zeros(2, 3)})
