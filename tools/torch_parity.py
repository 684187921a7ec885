"""Run the JAX package's own test files against the PyTorch port, on the CPU.

Usage (from the repo root):

    python3 tools/torch_parity.py [-n WORKERS] [--keep DIR] [--timeout S]
                                  [--numpy] [FILE_OR_TEST_ID ...]

Each ``tests/test_*.py`` that is not a ``test_torch_*`` file (or only the
named ones: ``test_misc.py`` or ``test_misc.py::test_timers``) is copied into
a temporary directory with ``ngsxfem_tpu`` rewritten to ``ngsxfem_tpu_torch``
and the ``examples`` imports to ``ngsxfem_tpu_torch.examples``.  With
``--numpy`` the copies also read ``import numpy as jnp`` where the tests say
``import jax.numpy as jnp``, and nothing else changes: the tests then hand
the port numpy arrays and numpy dtypes where they made jnp ones, which is
what a caller of the port passes (the JAX functions take numpy too).  A
conftest beside the copies

- sends the port's entry points that are called without a device to the CPU
  (``config.resolve_device(None)`` becomes ``torch.device("cpu")`` in every
  module of the port that imported it): the copies stand for a caller who
  asked for the CPU, as the port's own tests pass ``device="cpu"``;
- runs JAX on the CPU with x64 on and 8 virtual devices, as
  ``tests/conftest.py`` does, for the ``jnp`` values the tests make
  themselves;
- shares the machine's cores among the xdist workers' torch threads.

pytest then runs the copies with xdist, and the script prints one row per
file (collected, passed, failed, errors) and, for every test that failed or
errored, its id and the last frame of its traceback with the exception.  It
exits 0 when no test failed or errored, else 1.  It writes nothing into
``tests/`` or ``ngsxfem_tpu/``.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFTEST = '''\
"""Parity run: the JAX package's tests, rewritten to the PyTorch port."""
import importlib
import os
import pkgutil
import sys

sys.path.insert(0, {repo!r})
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(_WORKERS)))

import ngsxfem_tpu_torch  # noqa: E402
_config = importlib.import_module("ngsxfem_tpu_torch.config")

_resolve = _config.resolve_device


def _cpu_by_default(device=None):
    return _resolve(torch.device("cpu") if device is None else device)


for _info in pkgutil.walk_packages(ngsxfem_tpu_torch.__path__,
                                   "ngsxfem_tpu_torch."):
    importlib.import_module(_info.name)
for _name, _mod in list(sys.modules.items()):
    if (_name == "ngsxfem_tpu_torch" or _name.startswith("ngsxfem_tpu_torch.")) \\
            and getattr(_mod, "resolve_device", None) is _resolve:
        _mod.resolve_device = _cpu_by_default


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (and nvcc); skips without one")
'''

_PKG = re.compile(r"\bngsxfem_tpu\b")
_FROM_EX = re.compile(r"^(\s*)from examples(?=[.\s])", re.M)
_IMPORT_EX = re.compile(r"^(\s*)import examples\b", re.M)
_JNP = re.compile(r"^(\s*)import jax\.numpy as jnp\b", re.M)


def rewrite(src, numpy_mode=False):
    """The test source with the JAX package's imports sent to the port;
    with ``numpy_mode`` also ``import jax.numpy as jnp`` -> ``import numpy
    as jnp``."""
    src = _PKG.sub("ngsxfem_tpu_torch", src)
    src = _FROM_EX.sub(r"\1from ngsxfem_tpu_torch.examples", src)
    src = _IMPORT_EX.sub(r"\1import ngsxfem_tpu_torch.examples as examples",
                         src)
    return _JNP.sub(r"\1import numpy as jnp", src) if numpy_mode else src


def jax_test_files():
    return sorted(p for p in glob.glob(os.path.join(REPO, "tests", "test_*.py"))
                  if not os.path.basename(p).startswith("test_torch_"))


def _last_frame(text):
    """The last ``path:line: Exception`` frame of a pytest long traceback,
    with the first ``E`` line of the exception message."""
    lines = (text or "").splitlines()
    frame = next((ln.strip() for ln in reversed(lines)
                  if re.match(r"^\S.*:\d+: \w", ln)), "")
    # the E lines right before that frame
    msg = ""
    for ln in reversed(lines):
        if ln.startswith("E "):
            msg = ln[1:].strip()
        elif msg:
            break
    return frame, msg[:300]


def parse_junit(path):
    """{file: {"collected", "passed", "failed", "errors", "skipped",
    "bad": [(id, frame, message)]}} from a junit xml (xunit1)."""
    rows = {}
    root = ET.parse(path).getroot()
    for case in root.iter("testcase"):
        fname = case.get("file") or (case.get("classname") or "").split(".")[0] + ".py"
        fname = os.path.basename(fname)
        row = rows.setdefault(fname, dict(collected=0, passed=0, failed=0,
                                          errors=0, skipped=0, bad=[]))
        name = case.get("name") or ""
        cls = case.get("classname") or ""
        parts = cls.split(".")[1:]
        tid = "::".join([fname] + parts + [name]) if name else fname
        fail = case.find("failure")
        err = case.find("error")
        skip = case.find("skipped")
        if err is not None and fail is None:
            row["errors"] += 1
            if name:
                row["collected"] += 1
            text = (err.text or "") + "\n" + (err.get("message") or "")
            row["bad"].append((tid, "ERROR") + _last_frame(text))
            continue
        row["collected"] += 1
        if fail is not None:
            row["failed"] += 1
            text = (fail.text or "") + "\n" + (fail.get("message") or "")
            row["bad"].append((tid, "FAILED") + _last_frame(text))
        elif skip is not None:
            row["skipped"] += 1
        else:
            row["passed"] += 1
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("targets", nargs="*",
                    help="test files or ids of tests/ (default: all JAX files)")
    ap.add_argument("-n", "--workers", type=int, default=6)
    ap.add_argument("--keep", help="write the rewritten suite into this "
                    "directory (made if missing) and keep it")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds before the pytest run is stopped")
    ap.add_argument("--numpy", action="store_true",
                    help="rewrite 'import jax.numpy as jnp' to 'import numpy "
                    "as jnp' in the copies (the tests pass numpy values)")
    args = ap.parse_args(argv)

    files = jax_test_files()
    selected, ids = [], []
    if args.targets:
        by_name = {os.path.basename(p): p for p in files}
        for t in args.targets:
            base = os.path.basename(t.split("::")[0])
            if base not in by_name:
                ap.error(f"{t}: not a JAX test file of tests/")
            if by_name[base] not in selected:
                selected.append(by_name[base])
            ids.append(base + t[len(t.split("::")[0]):])
    else:
        selected = files
        ids = [os.path.basename(p) for p in files]

    work = args.keep or tempfile.mkdtemp(prefix="torch_parity_")
    os.makedirs(work, exist_ok=True)
    try:
        for p in selected:
            with open(p) as f:
                src = f.read()
            with open(os.path.join(work, os.path.basename(p)), "w") as f:
                f.write(rewrite(src, args.numpy))
        with open(os.path.join(work, "conftest.py"), "w") as f:
            f.write(CONFTEST.format(repo=REPO))
        junit = os.path.join(work, "junit.xml")
        cmd = [sys.executable, "-m", "pytest", *ids, "-q", "-p",
               "no:cacheprovider", "-p", "no:randomly", "--rootdir", work,
               "-o", "junit_family=xunit1", f"--junitxml={junit}",
               "--tb=long", "-W", "ignore::DeprecationWarning"]
        if args.workers > 0:
            cmd += ["-p", "xdist", "-n", str(args.workers), "--dist", "loadfile"]
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        try:
            rc = subprocess.run(cmd, cwd=work, env=env,
                                timeout=args.timeout).returncode
        except subprocess.TimeoutExpired:
            print(f"pytest stopped after {args.timeout:.0f} s", flush=True)
            rc = 124
        if not os.path.exists(junit):
            print(f"no junit xml (pytest rc {rc})")
            return 1
        rows = parse_junit(junit)
    finally:
        if not args.keep:
            shutil.rmtree(work, ignore_errors=True)

    names = [os.path.basename(p) for p in selected]
    width = max(len(n) for n in names + ["file"])
    print(f"\n{'file':<{width}} {'collected':>9} {'passed':>7} "
          f"{'failed':>7} {'errors':>7} {'skipped':>8}")
    tot = dict(collected=0, passed=0, failed=0, errors=0, skipped=0)
    for n in names:
        r = rows.get(n, dict(collected=0, passed=0, failed=0, errors=0,
                             skipped=0, bad=[]))
        for k in tot:
            tot[k] += r[k]
        print(f"{n:<{width}} {r['collected']:>9} {r['passed']:>7} "
              f"{r['failed']:>7} {r['errors']:>7} {r['skipped']:>8}")
    print(f"{'total':<{width}} {tot['collected']:>9} {tot['passed']:>7} "
          f"{tot['failed']:>7} {tot['errors']:>7} {tot['skipped']:>8}")
    bad = [b for n in names for b in rows.get(n, {}).get("bad", [])]
    if bad:
        print("\nfailures and errors:")
        for tid, kind, frame, msg in bad:
            print(f"{kind} {tid}\n    {frame}\n    {msg}")
    return 0 if not bad and rc == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
