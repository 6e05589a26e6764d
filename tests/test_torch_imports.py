"""The port imports neither JAX nor anything of the JAX package.

Each check runs in a fresh interpreter, so what the test process itself
imported (the reference package, for the parity tests) cannot mask a leak.
"""
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LEAKS = textwrap.dedent("""
    import sys
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "jaxlib", "repro", "ml_dtypes")
                 or m.startswith(("jax.", "jaxlib.", "repro.")))
    assert not bad, bad
""")


def run(code: str) -> None:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_module_and_chip_smoke_import_no_jax():
    run(textwrap.dedent("""
        import importlib, pkgutil
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        assert len(names) >= 20, names
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert callable(chip_smoke.main)
    """) + LEAKS)


@pytest.mark.parametrize("module", [
    "repro_torch.core.format", "repro_torch.core.partition",
    "repro_torch.core.parallel_encode", "repro_torch.data.matrices",
    "repro_torch.obs", "repro_torch.convert"])
def test_host_layer_imports_no_torch(module):
    """Encode workers import the host layer only: it stays numpy-only."""
    run(f"import {module}\n" + LEAKS
        + "assert 'torch' not in sys.modules, 'torch'\n")


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke run exits nonzero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
