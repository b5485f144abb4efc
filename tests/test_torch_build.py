"""The port's kernel build (src/repro_torch/kernels/build.py) without a CUDA
compiler: a stand-in ``nvcc`` records its arguments and writes its outputs,
so the split of K1's source into units compiled at once, and their link
into one library, are checked on the CPU. The kernels themselves are built
and held against their plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import json
import re
import stat
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

FAKE_NVCC = """#!{python}
import json, sys
args = sys.argv[1:]
with open({calls!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
if {fail!r} and {fail!r} in args:
    print("error: stand-in failure")
    sys.exit(2)
print("ptxas info    : Used 8 registers")
open(args[args.index("-o") + 1], "w").write("built")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """Returns a function that installs a stand-in nvcc failing on the
    argument ``fail`` (if given) and returns the file its calls go to."""
    def install(fail=None):
        bindir = tmp_path / "cuda" / "bin"
        bindir.mkdir(parents=True)
        calls = tmp_path / "calls.jsonl"
        nvcc = bindir / "nvcc"
        nvcc.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls), fail=fail))
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
        return calls
    return install


def _calls(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_split_units_instantiate_every_planes_hook_once():
    """Unit 0 holds the entry points; units 1 .. n-1 of K1's source each
    instantiate some (hi_bits, k) planes hooks, and together every one of
    hi_bits 4..8 x k 1..4 exactly once."""
    macro, n = build.PARTS["ams_matmul"]
    text = (build.CSRC / build.SOURCES["ams_matmul"]).read_text()
    assert f"#ifdef {macro}" in text
    owner = {}
    unit = None
    for line in text.splitlines():
        m = re.match(r"#(?:el)?if K1_UNIT == (\d+)$", line)
        if m:
            unit = int(m.group(1))
            continue
        if line.startswith("#endif"):
            unit = None
        for hb, ks in re.findall(r"K1_HOOKS\((\d), (\d)\)", line if unit is not None else ""):
            assert (int(hb), int(ks)) not in owner, f"({hb}, {ks}) in two units"
            owner[(int(hb), int(ks))] = unit
    assert set(owner) == {(hb, ks) for hb in range(4, 9) for ks in range(1, 5)}
    assert set(owner.values()) == set(range(1, n))


def test_build_all_compiles_units_at_once_and_links_them(fake_nvcc):
    calls_file = fake_nvcc()
    report = build.build_all()
    assert set(report) == set(build.SOURCES)
    for name in build.SOURCES:
        assert build.library_path(name).read_text() == "built"
        assert "Used 8 registers" in report[name]["log"]
    calls = _calls(calls_file)
    macro, n = build.PARTS["ams_matmul"]
    units = [c for c in calls if "-c" in c]
    assert sorted(next(a for a in c if a.startswith(f"-D{macro}=")) for c in units) == \
        [f"-D{macro}={i}" for i in range(n)]
    assert all(c[-1].endswith(build.SOURCES["ams_matmul"]) and "-shared" not in c
               for c in units)
    links = [c for c in calls if "-shared" in c and c[-1].endswith(".o")]
    assert len(links) == 1 and len([a for a in links[0] if a.endswith(".o")]) == n
    whole = [c for c in calls if "-shared" in c and c[-1].endswith(".cu")]
    assert sorted(c[-1].rsplit("/", 1)[1] for c in whole) == sorted(
        src for name, src in build.SOURCES.items() if name not in build.PARTS)
    # only the libraries and their logs are left
    left = sorted(p.suffix for p in build.BUILD_DIR.iterdir())
    assert left == sorted([".so", ".log"] * len(build.SOURCES))
    # built libraries are reused
    assert build.build_all() == {}
    assert len(_calls(calls_file)) == len(calls)


def test_build_all_raises_when_one_unit_fails(fake_nvcc):
    macro, _ = build.PARTS["ams_matmul"]
    fake_nvcc(fail=f"-D{macro}=3")
    with pytest.raises(RuntimeError, match="ams_matmul: nvcc exited 2"):
        build.build_all()
    assert not build.library_path("ams_matmul").exists()
    assert all(build.library_path(name).exists() for name in build.SOURCES
               if name not in build.PARTS)
    assert not [p for p in build.BUILD_DIR.iterdir() if p.suffix in (".o", ".out", ".tmp")]
