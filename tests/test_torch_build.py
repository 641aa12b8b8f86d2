"""The kernel build module (``ops/_build.py``) on the CPU, where there is no
nvcc: per-source flags and the library digest, which must cover every
``csrc/*.cuh`` a source or a generated unit (K4, one per flow set) includes
so that an edited shared header rebuilds. Nothing here compiles: the
generated units' builds run a stand-in nvcc."""

import os
import shutil
import stat

import pytest

import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.ops import _build
from mpi_model_tpu_torch.ops import field_stencil as k4

SOURCES = ("fused_stencil", "composed_stencil", "fused_active",
           "pipeline_stencil")


def config4_unit():
    return k4.plan_field([mt.Diffusion(0.1, "a"), mt.Coupled(0.05, "a", "b"),
                          mt.Diffusion(0.2, "b")], ("a", "b"), (64, 64),
                         __import__("torch").float32, 1)


def test_per_source_flags():
    assert "--fmad=false" in _build.flags_for("fused_active")
    # K1/K2, K3's vpu form and K5 equal their plain versions bit for bit:
    # no FMA contraction either; nor K4's generated units
    for name in ("fused_stencil", "composed_stencil", "pipeline_stencil"):
        assert _build.flags_for(name) == _build.NVCC_FLAGS + (
            "--fmad=false",)
    assert _build.unit_flags() == _build.NVCC_FLAGS + ("--fmad=false",)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # K4 is a header its generated units include, not a source of its own
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(
        SOURCES)
    assert (_build.CSRC / "field_stencil.cuh").is_file()


#: the csrc headers each source includes, directly or through another
#: (K6 and K5 take the exact register walk, which takes the shared header)
HEADERS = {"fused_stencil": ["stencil_common.cuh"],
           "composed_stencil": ["stencil_common.cuh"],
           "fused_active": ["exact_walk.cuh", "stencil_common.cuh"],
           "pipeline_stencil": ["exact_walk.cuh", "stencil_common.cuh"]}


def test_every_source_includes_the_shared_header():
    for name in SOURCES:
        hdrs = _build.local_headers(_build.CSRC / f"{name}.cu")
        assert [h.name for h in hdrs] == HEADERS[name], name
    text = config4_unit().unit.text
    assert [h.name for h in _build._headers_of(text, "unit")] == [
        "field_stencil.cuh", "stencil_common.cuh"]


@pytest.mark.parametrize("edit", ["source", "header", "walk_header",
                                  "nothing"])
def test_digest_follows_source_and_header(tmp_path, monkeypatch, edit):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    text = config4_unit().unit.text

    def names():
        return {**{n: _build.digest_of(n) for n in SOURCES},
                "k4 unit": _build.unit_name(text)}

    before = names()
    if edit == "source":
        with open(csrc / "composed_stencil.cu", "a") as f:
            f.write("\n// edited\n")
    elif edit == "header":
        with open(csrc / "stencil_common.cuh", "a") as f:
            f.write("\n// edited\n")
    elif edit == "walk_header":
        with open(csrc / "exact_walk.cuh", "a") as f:
            f.write("\n// edited\n")
    after = names()
    changed = {n for n in before if before[n] != after[n]}
    assert changed == {"source": {"composed_stencil"},
                       "header": set(before),
                       "walk_header": {"fused_active", "pipeline_stencil"},
                       "nothing": set()}[edit]
    # distinct flags give distinct libraries even for one source text
    assert len(set(before.values())) == 5


def test_missing_local_header_is_refused(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "nowhere.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", csrc)
    with pytest.raises(RuntimeError, match="nowhere.cuh"):
        _build.digest_of("k")


def _stand_in_nvcc(tmp_path, monkeypatch, ok: bool):
    """An nvcc that writes the library it is asked for (or fails), and
    the build directory in tmp_path."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + (
        'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"; '
        'echo "ptxas info    : Used 96 registers"\n' if ok else
        'echo "error: stand-in" >&2; exit 2\n'))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "build_info", {})


def test_unit_build_is_cached_by_its_text(tmp_path, monkeypatch):
    _stand_in_nvcc(tmp_path, monkeypatch, ok=True)
    plan = config4_unit()
    name = _build.build_unit(plan.unit.text, plan.label)
    assert name == _build.unit_name(plan.unit.text)
    info = _build.build_info[name]
    assert info["cached"] is False and "96 registers" in info["ptxas"]
    assert (tmp_path / "_build" / f"lib{name}.so").is_file()
    # the text goes into the build directory, nowhere else
    assert (tmp_path / "_build" / f"{name}.cu").read_text() == plan.unit.text
    # a second process (a fresh record) finds the library: nothing rebuilt
    monkeypatch.setattr(_build, "build_info", {})
    assert _build.build_unit(plan.unit.text, plan.label) == name
    assert _build.build_info[name]["cached"] is True


def test_failed_unit_build_names_the_flow_set(tmp_path, monkeypatch):
    _stand_in_nvcc(tmp_path, monkeypatch, ok=False)
    plan = config4_unit()
    with pytest.raises(RuntimeError) as exc:
        _build.build_unit(plan.unit.text, plan.label)
    assert "Coupled(attr='a')" in str(exc.value)
    assert "stand-in" in str(exc.value)
    assert not list((tmp_path / "_build").glob("*.so"))
    assert os.environ["CUDA_HOME"] == str(tmp_path / "cuda")
