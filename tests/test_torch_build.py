"""The kernel build module (``ops/_build.py``) on the CPU, where there is no
nvcc: per-source flags and the library digest, which must cover every
``csrc/*.cuh`` a source includes so that an edited shared header rebuilds.
Nothing here compiles."""

import shutil

import pytest

from mpi_model_tpu_torch.ops import _build


def test_per_source_flags():
    assert "--fmad=false" in _build.flags_for("fused_active")
    # K1/K2, K3's vpu form, K4 and K5 equal their plain versions bit for
    # bit: no FMA contraction either
    for name in ("fused_stencil", "composed_stencil", "field_stencil",
                 "pipeline_stencil"):
        assert _build.flags_for(name) == _build.NVCC_FLAGS + (
            "--fmad=false",)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == [
        "composed_stencil", "field_stencil", "fused_active", "fused_stencil",
        "pipeline_stencil"]


def test_every_source_includes_the_shared_header():
    for name in ("fused_stencil", "composed_stencil", "fused_active",
                 "field_stencil", "pipeline_stencil"):
        hdrs = _build.local_headers(_build.CSRC / f"{name}.cu")
        assert [h.name for h in hdrs] == ["stencil_common.cuh"], name


@pytest.mark.parametrize("edit", ["source", "header", "nothing"])
def test_digest_follows_source_and_header(tmp_path, monkeypatch, edit):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.digest_of(n) for n in
              ("fused_stencil", "composed_stencil", "fused_active",
               "field_stencil", "pipeline_stencil")}
    if edit == "source":
        with open(csrc / "composed_stencil.cu", "a") as f:
            f.write("\n// edited\n")
    elif edit == "header":
        with open(csrc / "stencil_common.cuh", "a") as f:
            f.write("\n// edited\n")
    after = {n: _build.digest_of(n) for n in before}
    changed = {n for n in before if before[n] != after[n]}
    assert changed == {"source": {"composed_stencil"},
                       "header": set(before), "nothing": set()}[edit]
    # distinct flags give distinct libraries even for one source text
    assert len(set(before.values())) == 5


def test_missing_local_header_is_refused(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "nowhere.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", csrc)
    with pytest.raises(RuntimeError, match="nowhere.cuh"):
        _build.digest_of("k")
