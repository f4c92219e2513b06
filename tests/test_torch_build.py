"""The kernels' build names each library by what it is built from: the
source, every header beside it and the flags.  No ``nvcc`` is needed: the
name is computed, nothing is compiled."""

import pytest

from repro_torch.kernels import build

SOURCES = ("flash_attention", "flash_attention_bwd", "chunk_combine", "lru_scan", "wkv_scan")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "shared.cuh"\nextern "C" int f() { return 0; }\n')
    (src / "b.cu").write_text('extern "C" int g() { return 1; }\n')
    (src / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.mark.parametrize("edit", ["header", "new header", "source", "flags"])
def test_library_name_changes_with_what_it_is_built_from(csrc, monkeypatch, edit):
    """An edited header (or a new one) renames every library, so none is
    reused stale; an edited source renames its own library only."""
    before = {n: build.library_path(n) for n in ("a", "b")}
    assert before == {n: build.library_path(n) for n in ("a", "b")}   # stable
    if edit == "header":
        (csrc / "shared.cuh").write_text("#pragma once\n// edited\n")
    elif edit == "new header":
        (csrc / "other.cuh").write_text("#pragma once\n")
    elif edit == "source":
        (csrc / "a.cu").write_text('extern "C" int f() { return 2; }\n')
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    after = {n: build.library_path(n) for n in ("a", "b")}
    assert after["a"] != before["a"]
    assert (after["b"] != before["b"]) == (edit != "source")
    assert all(p.parent == build.BUILD_DIR and p.name.startswith(f"lib{n}_")
               for n, p in after.items())


def test_every_kernel_source_includes_only_headers_of_csrc():
    """Each kernel source's quoted includes name headers in ``csrc/``, which
    the name hashes: the four that use tensor-core or cp.async helpers
    share ``hopper_mma.cuh``."""
    users = set()
    for name in SOURCES:
        text = (build.CSRC / f"{name}.cu").read_text()
        quoted = [ln.split('"')[1] for ln in text.splitlines()
                  if ln.startswith("#include \"")]
        assert all((build.CSRC / h).is_file() and h.endswith(".cuh") for h in quoted)
        if "hopper_mma.cuh" in quoted:
            users.add(name)
    assert users == {"flash_attention", "flash_attention_bwd", "wkv_scan", "lru_scan"}
