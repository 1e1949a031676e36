"""csdr-package — the application bundler, for the PyTorch port.

Counterpart of ``csdr_tpu/apps/package_app.py`` (the reference's
cabal2appimage: walk the ldd closure of the built binaries, prune a
system-library exclude list, emit one deployable artifact).  It writes a
directory with:

* ``csdr.pyz``: a zipapp of ``csdr_tpu_torch`` whose ``__main__`` runs
  ``soapy-sdr`` or ``helidecode``;
* ``lib/``: the native file-I/O library (``io/native.py``) and its pruned
  ldd closure;
* ``build/``: where the CUDA kernels are built on first use, from the
  sources inside the zipapp (``ops/cuda/_build.py``); a bundle made where
  the kernel library is already built for the same sources carries it, and
  its target then needs no ``nvcc``;
* ``csdr``: a launcher that exports ``CSDR_NATIVE_LIB`` and
  ``CSDR_TPU_TORCH_BUILD_DIR`` and runs the zipapp;
* with ``--self-contained``, ``runtime/``: the interpreter with its ldd
  closure, the standard library and the site-packages ``import torch``
  needs, so the target needs only a compatible libc.

    python -m csdr_tpu_torch.apps.package_app [--self-contained] [OUT_DIR]
    OUT_DIR/csdr soapy-sdr --filename cap.cu8 -c 64 --demod "DeNBFM 0.6 F32" …
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import zipapp

__all__ = ["build_bundle", "bundle_runtime", "ldd_closure", "main"]

# system libraries never bundled (the reference keeps the same idea in its
# excludelist.txt)
_EXCLUDE = {
    "linux-vdso", "ld-linux", "libc.so", "libm.so", "libpthread", "libdl.so",
    "librt.so", "libgcc_s", "libstdc++",
}

_MAIN = """\
import sys

def main():
    prog = sys.argv[1] if len(sys.argv) > 1 else "soapy-sdr"
    args = sys.argv[2:]
    if prog in ("soapy-sdr", "soapy_sdr"):
        from csdr_tpu_torch.apps.soapy_sdr_cli import main as m
    elif prog == "helidecode":
        from csdr_tpu_torch.apps.helidecode import main as m
    else:
        print("usage: csdr.pyz [soapy-sdr|helidecode] <args...>")
        return 1
    return m(args)

if __name__ == "__main__":
    sys.exit(main())
"""

# what ``import torch`` and the package import (checked by running a bundle
# under ``env -i``); nvidia (the CUDA libraries of a CUDA build) and triton
# are bundled where the environment has them
_RUNTIME_DEPS = ("torch", "torchgen", "numpy", "scipy", "typing_extensions", "sympy", "mpmath",
                 "filelock", "fsspec", "jinja2", "markupsafe", "networkx", "nvidia", "triton")


def ldd_closure(binary: str) -> list[str]:
    """Transitive shared-library dependencies, minus the exclude list."""
    try:
        out = subprocess.run(["ldd", binary], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    libs = []
    for line in out.splitlines():
        m = re.search(r"=>\s*(\S+)\s*\(", line)
        if m and not any(os.path.basename(m.group(1)).startswith(e) for e in _EXCLUDE):
            libs.append(m.group(1))
    return libs


def _copy_libs(paths, libdir: str):
    for path in paths:
        try:
            shutil.copy2(path, libdir)
        except OSError:
            pass  # a library ldd names but cannot be read stays the host's


def bundle_runtime(out_dir: str, deps: tuple = _RUNTIME_DEPS) -> None:
    """Copy the running interpreter and its ldd closure, its standard
    library and the site-packages entries named by ``deps`` (matched on the
    entry's name before its first '-' or '.') into ``out_dir/runtime``."""
    import sysconfig

    rt = os.path.join(out_dir, "runtime")
    bindir, libdir = os.path.join(rt, "bin"), os.path.join(rt, "lib")
    os.makedirs(bindir, exist_ok=True)
    os.makedirs(libdir, exist_ok=True)
    py = os.path.realpath(sys.executable)
    shutil.copy2(py, os.path.join(bindir, "python3"))
    _copy_libs(ldd_closure(py), libdir)
    dst_std = os.path.join(rt, "stdlib")
    if not os.path.exists(dst_std):
        shutil.copytree(sysconfig.get_paths()["stdlib"], dst_std, symlinks=True,
                        ignore=shutil.ignore_patterns("__pycache__", "test", "idlelib",
                                                      "tkinter"),
                        dirs_exist_ok=True)
    dst_sp = os.path.join(rt, "site-packages")
    os.makedirs(dst_sp, exist_ok=True)
    for sp in sorted({p for p in sys.path if p.endswith("site-packages")}):
        if not os.path.isdir(sp):
            continue
        for entry in os.listdir(sp):
            if entry.split("-")[0].split(".")[0].lower() not in deps:
                continue
            src, dst = os.path.join(sp, entry), os.path.join(dst_sp, entry)
            if os.path.isdir(src):
                shutil.copytree(src, dst, symlinks=True,
                                ignore=shutil.ignore_patterns("__pycache__", "*.pyc"),
                                dirs_exist_ok=True)
            else:
                shutil.copy2(src, dst)


def _native_library() -> str | None:
    """The native I/O library, built here if need be; None where it cannot
    be built (no C++ compiler): the bundle then has none, and its
    ``native_cf32_source`` raises."""
    from ..io import native

    try:
        return str(native.build())
    except RuntimeError as e:
        print(f"csdr-package: no native library in the bundle: {e}", file=sys.stderr)
        return None


def build_bundle(out_dir: str, repo_root: str | None = None, self_contained: bool = False,
                 runtime_deps: tuple = _RUNTIME_DEPS) -> str:
    """Write the bundle into ``out_dir``; returns it.  The CUDA kernel
    library goes with it where it is already built for the package's
    sources (else the bundle builds it at its first CUDA launch).
    ``runtime_deps`` narrows the self-contained site-packages."""
    from ..ops.cuda import _build

    root = repo_root or os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    os.makedirs(out_dir, exist_ok=True)
    staging = os.path.join(out_dir, "_staging")
    if os.path.exists(staging):
        shutil.rmtree(staging)
    shutil.copytree(os.path.join(root, "csdr_tpu_torch"), os.path.join(staging, "csdr_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    with open(os.path.join(staging, "__main__.py"), "w") as f:
        f.write(_MAIN)
    zipapp.create_archive(staging, os.path.join(out_dir, "csdr.pyz"),
                          interpreter="/usr/bin/env python3")
    shutil.rmtree(staging)

    libdir = os.path.join(out_dir, "lib")
    os.makedirs(libdir, exist_ok=True)
    so = _native_library()
    if so is not None:
        shutil.copy2(so, os.path.join(libdir, "libcsdr_io.so"))
        _copy_libs(ldd_closure(so), libdir)
    builddir = os.path.join(out_dir, "build")
    os.makedirs(builddir, exist_ok=True)
    kernel_lib = _build.library_path()
    if kernel_lib.exists():
        shutil.copy2(kernel_lib, builddir)

    env = ('HERE="$(dirname "$(readlink -f "$0")")"\n'
           'export CSDR_NATIVE_LIB="$HERE/lib/libcsdr_io.so"\n'
           f'export {_build.BUILD_ENV}="$HERE/build"\n')
    if self_contained:
        bundle_runtime(out_dir, deps=runtime_deps)
        body = ('export LD_LIBRARY_PATH="$HERE/lib:$HERE/runtime/lib:$LD_LIBRARY_PATH"\n'
                'export PYTHONHOME="$HERE/runtime"\n'
                'export PYTHONPATH="$HERE/runtime/stdlib:$HERE/runtime/stdlib/lib-dynload:'
                '$HERE/runtime/site-packages"\n'
                'exec "$HERE/runtime/bin/python3" "$HERE/csdr.pyz" "$@"\n')
    else:
        body = ('export LD_LIBRARY_PATH="$HERE/lib:$LD_LIBRARY_PATH"\n'
                'exec python3 "$HERE/csdr.pyz" "$@"\n')
    launcher = os.path.join(out_dir, "csdr")
    with open(launcher, "w") as f:
        f.write("#!/bin/sh\n" + env + body)
    os.chmod(launcher, 0o755)
    return out_dir


def main(argv=None) -> int:
    args = list(argv) if argv is not None else sys.argv[1:]
    self_contained = "--self-contained" in args
    if self_contained:
        args.remove("--self-contained")
    out = args[0] if args else "dist"
    path = build_bundle(out, self_contained=self_contained)
    kind = "self-contained " if self_contained else ""
    print(f"{kind}bundle written to {path}/ (launcher: {path}/csdr)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
