"""The PyTorch port imports neither JAX nor the JAX package.

Runs in subprocesses: this test process has already imported jax
(tests/conftest.py), so ``sys.modules`` here says nothing about the port.
"""
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import ngsxfem_tpu_torch
import ngsxfem_tpu_torch.kernels.build
import ngsxfem_tpu_torch.solvers.dia_cg
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ngsxfem_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repository (and here, without
    a card) exits non-zero and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
