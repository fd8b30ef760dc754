"""The build key of ``repro_torch.kernels._build``: a library is rebuilt when
its source, a file the source includes, or its flags change, and only then.

Needs no ``nvcc``: it hashes copies of ``csrc`` in a temporary directory.
"""
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    return copy


def _flip_one_byte(path, at=-2):
    data = bytearray(path.read_bytes())
    data[at] ^= 0x01
    path.write_bytes(bytes(data))


def test_flash_attention_includes_the_sm90_header():
    names = [p.name for p in _build.sources_of("flash_attention")]
    assert names == ["flash_attention.cu", "sm90.cuh"]
    assert [p.name for p in _build.sources_of("gf256_matmul")] == ["gf256_matmul.cu"]


def test_the_key_is_stable_and_matches_the_library_name(csrc):
    key = _build.build_key("flash_attention", csrc)
    assert key == _build.build_key("flash_attention", csrc)
    assert key == _build.build_key("flash_attention")  # the copy equals the package
    assert _build.library_path("flash_attention").name == f"flash_attention-{key}.so"


@pytest.mark.parametrize("changed", ["sm90.cuh", "flash_attention.cu"])
def test_a_changed_byte_of_the_source_or_an_include_changes_the_key(csrc, changed):
    before = _build.build_key("flash_attention", csrc)
    _flip_one_byte(csrc / changed)
    assert _build.build_key("flash_attention", csrc) != before


def test_an_unrelated_source_leaves_the_key(csrc):
    before = _build.build_key("flash_attention", csrc)
    _flip_one_byte(csrc / "gf256_matmul.cu")
    assert _build.build_key("flash_attention", csrc) == before


def test_includes_are_followed_transitively_and_once(csrc):
    (csrc / "inner.cuh").write_text("#pragma once\n#include \"sm90.cuh\"\n")
    (csrc / "outer.cu").write_text('#include "sm90.cuh"\n  #include "inner.cuh"\n'
                                   '#include <cuda.h>\n#include "cute/tensor.hpp"\n')
    names = [p.name for p in _build.sources_of("outer", csrc)]
    assert names == ["outer.cu", "sm90.cuh", "inner.cuh"]  # -I headers are the flags' part
    before = _build.build_key("outer", csrc)
    _flip_one_byte(csrc / "inner.cuh", at=3)
    assert _build.build_key("outer", csrc) != before


def test_extra_flags_of_a_source_change_its_key(csrc, monkeypatch):
    before = _build.build_key("flash_attention", csrc)
    other = _build.build_key("gf256_matmul", csrc)
    monkeypatch.setitem(_build.EXTRA_FLAGS, "flash_attention", ("-I/usr/local/cutlass/include",))
    assert _build.nvcc_flags("flash_attention")[-1] == "-I/usr/local/cutlass/include"
    assert _build.build_key("flash_attention", csrc) != before
    assert _build.build_key("gf256_matmul", csrc) == other


@pytest.mark.parametrize("name", ["flash_attention", "gf256_matmul", "cdc_gearhash"])
def test_ablation_edits_still_apply_to_the_sources(name):
    """The ablation scripts edit the kernel sources by text; each edit must
    still find its place and change the source."""
    from repro_torch.kernels import storage_ablate
    from repro_torch.kernels.flash_attention import ablate

    make = {"flash_attention": ablate.variants, "gf256_matmul": storage_ablate.gf_variants,
            "cdc_gearhash": storage_ablate.gear_variants}[name]
    src = (_build.CSRC / f"{name}.cu").read_text()
    variants = make(src)
    assert variants.pop("kernel") == src and variants
    assert all(text != src for text in variants.values())
