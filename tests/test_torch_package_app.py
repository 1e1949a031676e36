"""The port's csdr-package bundler: the cases of tests/test_package_app.py
on ``csdr_tpu_torch.apps.package_app``, and the CUDA sources read from
inside the zipapp.  The self-contained bundle (the interpreter, the
standard library and torch's site-packages, ~1 GB) is built once for the
module."""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from csdr_tpu_torch.apps.package_app import _RUNTIME_DEPS, build_bundle
from csdr_tpu_torch.ops.cuda import _build


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    return build_bundle(str(tmp_path_factory.mktemp("bundle") / "dist"))


@pytest.fixture(scope="module")
def contained(tmp_path_factory):
    return build_bundle(str(tmp_path_factory.mktemp("contained") / "dist"), self_contained=True,
                        runtime_deps=_RUNTIME_DEPS)


def test_build_bundle(bundle):
    pyz = os.path.join(bundle, "csdr.pyz")
    assert os.path.exists(pyz) and os.path.exists(os.path.join(bundle, "csdr"))
    with zipfile.ZipFile(pyz) as z:
        names = z.namelist()
    assert "__main__.py" in names
    assert any(n.startswith("csdr_tpu_torch/apps/soapy_sdr_cli") for n in names)
    assert {f"csdr_tpu_torch/csrc/{p.name}" for p in _build._csrc().iterdir()} <= set(names)
    assert not any(n.startswith("csdr_tpu/") for n in names)
    # the usage line, without running a flow
    r = subprocess.run([sys.executable, pyz, "unknown-prog"], capture_output=True, text=True,
                       timeout=60)
    assert "usage" in r.stdout


def test_bundle_dispatches_helidecode(bundle):
    """The zipapp's helidecode entry runs the port's app (its usage line)."""
    r = subprocess.run([sys.executable, os.path.join(bundle, "csdr.pyz"), "helidecode"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "usage: helidecode" in r.stdout


def test_package_main_writes_a_bundle(tmp_path, capsys):
    """``csdr-package-torch OUT`` writes the bundle and names its launcher."""
    from csdr_tpu_torch.apps.package_app import main

    assert main([str(tmp_path / "out")]) == 0
    assert f"launcher: {tmp_path / 'out'}/csdr" in capsys.readouterr().out
    assert os.access(tmp_path / "out" / "csdr", os.X_OK)


def test_bundle_native_lib_is_loadable(bundle, monkeypatch):
    """The launcher points CSDR_NATIVE_LIB at the bundled library (inside
    the zipapp the checkout's native/ does not exist), and load_lib honours
    it; it also points the kernels' build directory into the bundle."""
    launcher = open(os.path.join(bundle, "csdr")).read()
    assert 'CSDR_NATIVE_LIB="$HERE/lib/libcsdr_io.so"' in launcher
    assert f'{_build.BUILD_ENV}="$HERE/build"' in launcher
    so = os.path.join(bundle, "lib", "libcsdr_io.so")
    assert os.path.exists(so)   # g++ built it while bundling
    import csdr_tpu_torch.io.native as native

    monkeypatch.setenv("CSDR_NATIVE_LIB", so)
    monkeypatch.setattr(native, "_lib", None)
    assert native.load_lib()._name == so
    monkeypatch.setattr(native, "_lib", None)


def test_native_lib_env_missing_path_raises(monkeypatch):
    import csdr_tpu_torch.io.native as native

    monkeypatch.setenv("CSDR_NATIVE_LIB", "/nonexistent/libcsdr_io.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="nonexistent"):
        native.load_lib()
    monkeypatch.setattr(native, "_lib", None)


def test_kernel_sources_read_from_inside_the_zipapp(bundle):
    """Inside the .pyz the package's csrc is a zip member: source_ints reads
    K5's constants from it, the library's name hashes the same sources as
    the checkout's, and the build directory is the launcher's."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from csdr_tpu_torch.ops.cuda import _build as b; "
            "import csdr_tpu_torch.ops.cuda.fir_valid as fv; "
            "print(json.dumps([b.source_ints('fir_valid.cu', 'kFrame', 'kFrames', "
            "'kChunkSteps', 'kTapPad'), b.library_path().name, str(b.build_dir()), "
            "str(b._csrc())]))")
    env = dict(os.environ, **{_build.BUILD_ENV: os.path.join(bundle, "build")})
    r = subprocess.run([sys.executable, "-c", code, os.path.join(bundle, "csdr.pyz")], env=env,
                       capture_output=True, text=True, timeout=120, cwd=bundle)
    assert r.returncode == 0, r.stderr[-2000:]
    want = _build.source_ints("fir_valid.cu", "kFrame", "kFrames", "kChunkSteps", "kTapPad")
    ints, name, bdir, csrc = json.loads(r.stdout.strip().splitlines()[-1])
    assert tuple(ints) == want
    assert name == _build.library_path().name
    assert bdir == os.path.join(bundle, "build") and "csdr.pyz" in csrc
    # without the launcher's variable the zipapp has no writable build directory
    env.pop(_build.BUILD_ENV)
    r = subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                        "from csdr_tpu_torch.ops.cuda import _build as b; b.build_dir()",
                        os.path.join(bundle, "csdr.pyz")], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and _build.BUILD_ENV in r.stderr


def test_bundle_carries_a_built_kernel_library(tmp_path, monkeypatch):
    """A bundle made where the kernel library is built for the current
    sources carries it into its build directory (its target needs no
    nvcc); made where none is built, it leaves it to be built there."""
    fake = tmp_path / "built"
    monkeypatch.setenv(_build.BUILD_ENV, str(fake))
    fake.mkdir()
    lib = _build.library_path()
    lib.write_bytes(b"not a real library")
    out = build_bundle(str(tmp_path / "with"))
    assert (tmp_path / "with" / "build" / lib.name).read_bytes() == b"not a real library"
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv(_build.BUILD_ENV, str(empty))
    build_bundle(str(tmp_path / "without"))
    assert os.listdir(tmp_path / "without" / "build") == []
    assert out == str(tmp_path / "with")


def test_self_contained_bundle_runs_under_env_i(contained, tmp_path):
    """The self-contained bundle (interpreter, ldd closure, stdlib and the
    site-packages ``import torch`` needs) runs a cf32 → WAV flow under
    ``env -i`` with --device cpu: n·4 + 44 bytes."""
    assert os.path.exists(os.path.join(contained, "runtime", "bin", "python3"))
    assert os.path.isdir(os.path.join(contained, "runtime", "stdlib"))
    assert os.path.isdir(os.path.join(contained, "runtime", "site-packages", "torch"))
    n = 16384
    t = np.arange(n)
    msg = 0.5 * np.sin(2 * np.pi * 0.002 * t)
    cap = str(tmp_path / "cap.cf32")
    np.exp(1j * np.cumsum(2 * np.pi * 0.1 * msg)).astype(np.complex64).tofile(cap)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    r = subprocess.run(
        ["env", "-i"] + [f"{k}={v}" for k, v in env.items()] +
        [os.path.join(contained, "csdr"), "soapy-sdr", "--filename", cap, "-s", "64000",
         "-n", str(n), "-c", "1", "--demod", "DeNBFM 0.6 WAV", "-o", str(tmp_path / "audio"),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    wav = str(tmp_path / "audio.wav")
    assert os.path.getsize(wav) == n * 4 + 44
