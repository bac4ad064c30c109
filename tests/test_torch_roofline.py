"""``repro_torch.launch.roofline`` against ``repro.launch.roofline``: the
parameter and model FLOP counts of every architecture at every input
shape, the ``Roofline`` terms and ``aggregation_roofline`` on each of the
reference's hardware specs, and ``detect_hardware``."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_arch as jget_arch
from repro.configs import model_for_shape as jmodel_for_shape
from repro.launch import roofline as JR
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_arch
from repro_torch.configs import model_for_shape
from repro_torch.launch import roofline as R

REF_SPECS = ["tpu-v5e", "tpu-v4", "tpu-v5p", "tpu-v6e", "cpu"]


def test_archs_and_specs_are_the_references():
    assert list(ARCH_IDS) == list(J_ARCH_IDS)
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for name in REF_SPECS:
        assert dataclasses.asdict(R.KNOWN_HARDWARE[name]) == \
            dataclasses.asdict(JR.KNOWN_HARDWARE[name])
    h = R.KNOWN_HARDWARE["h100"]
    assert (h.peak_flops, h.hbm_bw, h.ici_bw) == (989e12, 3.35e12, 25e9)
    assert R.H100_F32_FLOPS == 67e12


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_count_params_and_model_flops_are_the_references(arch):
    for shape in J_SHAPES:
        cfg = model_for_shape(get_arch(arch), INPUT_SHAPES[shape])
        jcfg = jmodel_for_shape(jget_arch(arch), J_SHAPES[shape])
        for active in (False, True):
            assert R.count_params(cfg, active_only=active) == \
                JR.count_params(jcfg, active_only=active)
        assert R.model_flops(cfg, INPUT_SHAPES[shape]) == \
            JR.model_flops(jcfg, J_SHAPES[shape])
        assert R.model_flops(cfg, INPUT_SHAPES[shape], 12345) == \
            JR.model_flops(jcfg, J_SHAPES[shape], 12345)


@pytest.mark.parametrize("name", REF_SPECS)
def test_roofline_and_aggregation_roofline_are_the_references(name):
    rng = np.random.default_rng(len(name))
    spec, jspec = R.KNOWN_HARDWARE[name], JR.KNOWN_HARDWARE[name]
    for _ in range(3):
        f, b, w, m = (float(v) for v in rng.uniform(1e9, 1e15, 4))
        chips = int(rng.integers(1, 512))
        got = R.Roofline(f, b, w, m, n_chips=chips, spec=spec).as_dict()
        want = JR.Roofline(f, b, w, m, n_chips=chips, spec=jspec).as_dict()
        assert got == want
    assert R.Roofline(0.0, 1.0, 0.0, 1.0, spec=spec).useful_flops_fraction \
        is None
    for batch, n, d, nbytes, chips in [(84, 13, 64, 4, 1),
                                       (12, 13, 33_450, 4, 1),
                                       (8, 13, 1_048_576, 2, 4),
                                       (1, 8, 416_179_200, 4, 1)]:
        kw = dict(batch=batch, n=n, d=d, dtype_bytes=nbytes, n_chips=chips)
        assert R.aggregation_roofline(spec=spec, **kw).as_dict() == \
            JR.aggregation_roofline(spec=jspec, **kw).as_dict()


def test_defaults_are_one_h100():
    rl = R.aggregation_roofline(batch=1, n=8, d=416_179_200)
    assert rl.spec is R.H100 and rl.n_chips == 1
    # the CWTM bound of PERF.md's kernel table at the LLM path: bytes
    assert rl.bottleneck == "memory"
    assert rl.hbm_bytes_per_chip == (8 + 1) * 416_179_200 * 4
    assert R.Roofline(1.0, 1.0, 0.0, 1.0).collective_s == 0.0


def test_detect_hardware(monkeypatch):
    assert R.detect_hardware("h100") is R.H100
    assert R.detect_hardware("tpu-v4").name == "tpu-v4"
    with pytest.raises(ValueError, match="unknown hardware 'a100'"):
        R.detect_hardware("a100")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.detect_hardware().name == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert R.detect_hardware() is R.H100
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA RTX 6000 Ada Generation")
    assert R.detect_hardware() is R.H100


# PERF.md's kernel table: (work, operations' rate, bound ms as printed)
D_LLM, KB_LLM = 416_179_200, 40_642
PAIRS_4096 = 4096 * 4097 // 2
TABLE_BOUNDS = [
    (R.pairdist_work(1, 13, 11958, 4), "f32", "0.000186"),
    (R.pairdist_work(36, 13, 11958, 4), "f32", "0.006689"),
    (R.sorted_weight_work(1, 8, D_LLM, 4), "f32", "4.4724"),
    (R.sorted_weight_work(1, 13, 1_048_576, 4), "f32", "0.01753"),
    (R.compress_work(8, KB_LLM, 512, 4, KB_LLM), "f32", "0.39759"),
    (R.compress_work(8, KB_LLM, 512, 2, KB_LLM), "f32", "0.19882"),
    (R.compress_work(8, KB_LLM, 512, 1, KB_LLM), "f32", "0.09943"),
    (R.decompress_work(8, D_LLM, KB_LLM, 512, 4, KB_LLM, D_LLM // 512),
     "f32", "4.17523"),
    (R.decompress_work(8, D_LLM, KB_LLM, 512, 1, KB_LLM, D_LLM // 512),
     "f32", "1.04457"),
    (R.momentum_work(8, D_LLM, KB_LLM, 512, 4, 4, KB_LLM, False), "f32",
     "8.14970"),
    (R.momentum_work(8, D_LLM, KB_LLM, 512, 2, 2, KB_LLM, True), "f32",
     "8.05032"),
    (R.momentum_work(8, D_LLM, KB_LLM, 512, 1, 1, KB_LLM, True), "f32",
     "6.01291"),
    (R.flash_work(1, 4096, 4096, 32, 32, 80, PAIRS_4096)["flash_fwd"],
     "bf16", "0.08688"),
    (R.flash_work(1, 4096, 4096, 32, 32, 80, PAIRS_4096)["flash_bwd"],
     "bf16", "0.21719"),
    (R.flash_work(1, 4096, 4096, 8, 1, 256, PAIRS_4096)["flash_fwd"],
     "bf16", "0.06950"),
    (R.flash_work(1, 4096, 4096, 8, 1, 256, PAIRS_4096)["flash_bwd"],
     "bf16", "0.17375"),
]


@pytest.mark.parametrize("i", range(len(TABLE_BOUNDS)))
def test_kernel_work_gives_the_recorded_bounds(i):
    """Each kernel's work, at the H100's published peaks, is the bound
    PERF.md's kernel table records, to its printed digits: the
    counts moved into this module without changing a bound."""
    work, rate, want = TABLE_BOUNDS[i]
    ms, by = R.bound_ms(work, R.H100_F32_FLOPS if rate == "f32"
                        else R.H100.peak_flops)
    digits = len(want.replace(".", "").lstrip("0"))
    assert float(f"{ms:.{digits}g}") == float(want)
    assert by == ("operations" if rate == "bf16" else "bytes")


F32_FLASH_BOUNDS = [
    ((1, 4096, 4096, 32, 32, 80), "flash_fwd", "1.28239"),
    ((1, 4096, 4096, 32, 32, 80), "flash_bwd", "3.20598"),
    ((1, 4096, 4096, 8, 1, 256), "flash_fwd", "1.02591"),
    ((1, 4096, 4096, 8, 1, 256), "flash_bwd", "2.56479"),
]


@pytest.mark.parametrize("shape,name,want", F32_FLASH_BOUNDS)
def test_float32_flash_work_gives_the_recorded_bounds(shape, name, want):
    """The float32 flash kernels' work (``itemsize=4``) at the float32
    peak, bound by operations, is PERF.md's float32 rows' bound; their
    tensors count twice the bf16 kernels' bytes, the float32 lse the
    same."""
    work = R.flash_work(*shape, PAIRS_4096, itemsize=4)[name]
    ms, by = R.bound_ms(work, R.H100_F32_FLOPS)
    digits = len(want.replace(".", "").lstrip("0"))
    assert float(f"{ms:.{digits}g}") == float(want) and by == "operations"
    bf16 = R.flash_work(*shape, PAIRS_4096)[name]
    lse = shape[0] * shape[3] * shape[1] * 4
    assert work[1] == bf16[1] and work[0] - lse == 2 * (bf16[0] - lse)
