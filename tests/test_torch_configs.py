"""The port's config registry against the reference's ``repro.configs``:
``get_arch`` on every id and alias (``mnist_cnn`` included), the paper
CNN's spec field for field, and ``list_archs``."""

import dataclasses

import pytest

from repro.configs import base as JB
from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro_torch.configs import (ARCH_IDS, PORTED_ARCHS, get_arch,
                                 list_archs)
from repro_torch.configs import base as B
from repro_torch.models.config import ModelConfig


def _fields(model):
    return {f: getattr(model, f) for f in ModelConfig.__dataclass_fields__}


@pytest.mark.parametrize(
    "arch_id", JB.ARCH_IDS + sorted(JB._ALIASES) + ["mnist_cnn"])
def test_get_arch_on_every_id_and_alias_is_the_references(arch_id):
    spec, jspec = get_arch(arch_id), jax_get_arch(arch_id)
    assert spec.name == jspec.name
    assert _fields(spec.model) == _fields(jspec.model)
    assert (spec.citation, spec.rosdhb_ratio) == \
        (jspec.citation, jspec.rosdhb_ratio)


def test_mnist_cnn_is_the_papers_cnn_and_stays_out_of_the_pool():
    spec, jspec = get_arch("mnist_cnn"), jax_get_arch("mnist_cnn")
    jfields = {f.name for f in dataclasses.fields(jspec)} - {"fsdp"}
    assert {f.name for f in dataclasses.fields(spec)} == jfields
    assert {f: getattr(spec, f) for f in jfields if f != "model"} == \
        {f: getattr(jspec, f) for f in jfields if f != "model"}
    assert spec.model == ModelConfig(
        name="mnist_cnn", family="dense", n_layers=0, d_model=0, n_heads=0,
        n_kv_heads=0, d_ff=0, vocab_size=10)
    assert "mnist_cnn" not in ARCH_IDS and "mnist_cnn" not in PORTED_ARCHS
    assert "mnist_cnn" not in list_archs()


def test_list_archs_and_aliases_are_the_references():
    assert list_archs() == jax_list_archs() == ARCH_IDS
    assert B._ALIASES == JB._ALIASES
    got = list_archs()
    got.append("x")  # a fresh list each call, as the reference's
    assert list_archs() == ARCH_IDS


@pytest.mark.parametrize("arch_id", ["mnist-cnn-x", "gpt2", "mnist"])
def test_unknown_arch_raises_as_the_reference(arch_id):
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch(arch_id)
    with pytest.raises(KeyError, match="unknown arch"):
        jax_get_arch(arch_id)
