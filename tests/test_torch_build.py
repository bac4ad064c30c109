"""The CUDA kernels' bindings and the card's flash check, on the CPU.

A ctypes row that disagrees with its C entry (an argument too few, an int
where a pointer goes) crashes only on the card, so every ``extern "C"``
entry of ``src/repro_torch/csrc/*.cu`` is held against
``build.SIGNATURES`` here. ``chip_smoke.py`` holds the flash kernels against
their plain version tile by tile as well as by the largest entry; here that
tile measure is shown to fail a dropped tile at every shape it checks."""

import ctypes
import re
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _c_type(param: str):
    """The ctypes type a C parameter declaration takes."""
    decl = " ".join(param.split())
    if "*" in decl:
        return build.P
    if re.match(r"(const )?long long\b", decl):
        return build.LL
    if re.match(r"(const )?float\b", decl):
        return build.F
    if re.match(r"(const )?int\b", decl):
        return build.I
    raise AssertionError(f"no ctypes rule for the C parameter {param!r}")


def _entries(source: Path) -> dict:
    """``{entry: [C parameter declarations]}`` of the ``extern "C"``
    functions of a source."""
    text = re.sub(r"//[^\n]*", "", source.read_text())
    out = {}
    for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
        out[m[1]] = [p.strip() for p in m[2].split(",") if p.strip()]
    return out


SOURCES = sorted(build.CSRC.glob("*.cu"))


def test_every_source_has_signatures():
    assert {s.stem for s in SOURCES} == set(build.SIGNATURES)


@pytest.mark.parametrize("source", SOURCES, ids=lambda s: s.stem)
def test_ctypes_rows_match_the_c_entries(source):
    """Same entries, same number of arguments, and each argument of the
    ctypes kind its C type needs (a pointer, an int, a long long, a
    float)."""
    entries = _entries(source)
    rows = build.SIGNATURES[source.stem]
    assert entries, f"{source.name} has no extern \"C\" entry"
    assert set(entries) == set(rows)
    for name, params in entries.items():
        assert len(params) == len(rows[name]), name
        assert [_c_type(p) for p in params] == list(rows[name]), name


def test_the_parser_sees_a_mismatch():
    params = _entries(build.CSRC / "flash_attention.cu")["flash_fwd"]
    assert len(params) == 16 and _c_type(params[0]) is build.P
    assert _c_type(params[14]) is build.F  # the softmax scale
    assert _c_type("int q_offset") is build.I
    assert _c_type("long long d") is build.LL


def _struct_fields(source: Path, name: str) -> list:
    """``[(field, C type)]`` of ``struct name { ... };`` in a source."""
    text = re.sub(r"//[^\n]*", "", source.read_text())
    body = re.search(rf"struct\s+{name}\s*\{{([^}}]*)\}};", text)[1]
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"(.*?)\s*\b(\w+)(?:\[(\w+)\])?$",
                     " ".join(decl.split()))
        out.append((m[2], m[1] + (f"[{m[3]}]" if m[3] else "")))
    return out


def _ctypes_of(c_type: str):
    if "*" in c_type:
        return ctypes.c_void_p
    if c_type == "float[kMaxN]":
        return ctypes.c_float * 64
    return {"long long": ctypes.c_longlong, "int": ctypes.c_int,
            "float": ctypes.c_float}.get(c_type, c_type)


@pytest.mark.parametrize("source,struct,py", [
    ("pairdist", "PairdistPlan", "repro_torch.kernels.pairdist.pairdist"),
    ("sorted_weight", "SortedWeightPlan", "repro_torch.kernels.cwtm.cwtm")])
def test_plan_structs_match_the_c_structs(source, struct, py):
    """The ctypes plan a wrapper hands the C entry by pointer has the C
    struct's fields, in its order, of its types (a struct field of the
    source is matched by its ctypes class's name)."""
    import importlib
    cls = importlib.import_module(py).PlanStruct
    want = _struct_fields(build.CSRC / f"{source}.cu", struct)
    got = [(f, t) for f, t in cls._fields_]
    assert [f for f, _ in got] == [f for f, _ in want]
    for (field, t), (_, c_type) in zip(got, want):
        expect = _ctypes_of(c_type)
        if isinstance(expect, str):  # a struct: same name, same layout
            assert t.__name__ == expect, field
            inner = _struct_fields(build.CSRC / f"{source}.cu", expect)
            assert [f for f, _ in t._fields_] == [f for f, _ in inner]
            for (_, tt), (_, ct) in zip(t._fields_, inner):
                assert tt == _ctypes_of(ct), field
        else:
            assert t is expect, field
    if struct == "SortedWeightPlan":
        assert ctypes.sizeof(cls) == 24 + 4 * 64
    else:
        assert ctypes.sizeof(cls) == 8 * 3 + 4 * 8


def test_profile_kinds_name_the_real_kernels():
    """``chip_smoke.op_kind`` counts every ``__global__`` kernel of the
    port's sources as a port kernel, by the names the sources give them."""
    names = set()
    for source in SOURCES:
        text = re.sub(r"//[^\n]*", "", source.read_text())
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s+)?(\w+)\s*\(", text))
    assert names
    server = {n for n in names if "flash" not in n}
    assert server == set(chip_smoke.PORT_SERVER_KERNELS)
    for n in names:
        assert chip_smoke.op_kind(f"void (anonymous namespace)::{n}<16, "
                                  f"float>(float const*)").endswith("(port)")
    assert chip_smoke.op_kind("gram_partial_kernel") == "other elementwise"


# ----------------------------------------------------------------------- #
# the card's flash check
# ----------------------------------------------------------------------- #

FLASH_CASES = chip_smoke.FLASH_AWKWARD + [chip_smoke.FLASH_PATH]
TILE_TOLS = {"out": chip_smoke.FLASH_TILE_TOL_OUT,
             "dq": chip_smoke.FLASH_TILE_TOL_GRAD,
             "dk": chip_smoke.FLASH_TILE_TOL_GRAD,
             "dv": chip_smoke.FLASH_TILE_TOL_GRAD}


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_tile_check_fails_a_dropped_tile(case):
    """One 64-row x 128-key tile left out of one head's plain attention
    reads more than twice the tile bound on out, dq, dk and dv."""
    readings = chip_smoke.flash_fault_readings(torch, case, seed=7,
                                               device="cpu")
    assert set(readings) == set(TILE_TOLS)
    for name, reading in readings.items():
        assert reading > 2 * TILE_TOLS[name], (name, reading)


def test_tile_rel_err_reads_the_worst_block():
    gen = torch.Generator().manual_seed(0)
    want = torch.randn((2, 130, 3, 16), generator=gen)
    assert chip_smoke.tile_rel_err(torch, want.clone(), want) == 0.0
    got = want.clone()
    got[1, 128:, 2] *= 1.5  # the last, ragged block of one head
    assert chip_smoke.tile_rel_err(torch, got, want) == pytest.approx(0.5)
    # every tenth row of one block doubled: per head, the share of the
    # block's squares those rows hold, square-rooted; the worst head counts
    got = want.clone()
    got[0, 64:128:10] *= 2.0
    sq = want[0, 64:128].pow(2).sum(-1)  # [rows, heads]
    expect = max(float(sq[::10, h].sum() / sq[:, h].sum()) ** 0.5
                 for h in range(3))
    assert chip_smoke.tile_rel_err(torch, got, want) == pytest.approx(
        expect, rel=1e-5)
    zero = torch.zeros_like(want)
    assert chip_smoke.tile_rel_err(torch, zero, zero) == 0.0
    assert chip_smoke.tile_rel_err(torch, want, zero) == float("inf")
