"""The kernel build cache: a library is reused only when its sources, its
compiler command and the compiler itself are unchanged.  Stand-in
compilers are shell scripts that print a version."""

import stat

import pytest

from dualsphysics_multilayer_tpu_torch.ops.cuda import build


def fake_compiler(path, version):
    path.write_text(f"#!/bin/sh\necho '{version}'\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


@pytest.fixture
def source(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("int k;\n")
    return str(src)


def test_build_key_is_stable(tmp_path, source):
    cc = fake_compiler(tmp_path / "cc", "cc 1.0")
    assert build.build_key([cc, "-O3"], [source]) == \
        build.build_key([cc, "-O3"], [source])


@pytest.mark.parametrize("change", ["path", "version", "flags", "source"])
def test_build_key_changes_with_its_inputs(tmp_path, source, change):
    cc = fake_compiler(tmp_path / "cc", "cc 1.0")
    before = build.build_key([cc, "-O3"], [source])
    if change == "path":
        cc = fake_compiler(tmp_path / "cc2", "cc 1.0")
    elif change == "version":
        fake_compiler(tmp_path / "cc", "cc 1.1")
    elif change == "source":
        with open(source, "a") as f:
            f.write("int j;\n")
    flags = "-O2" if change == "flags" else "-O3"
    assert build.build_key([cc, flags], [source]) != before


def test_build_key_raises_for_a_broken_compiler(tmp_path, source):
    cc = tmp_path / "cc"
    cc.write_text("#!/bin/sh\nexit 3\n")
    cc.chmod(cc.stat().st_mode | stat.S_IXUSR)
    with pytest.raises(RuntimeError, match="--version"):
        build.build_key([str(cc)], [source])
