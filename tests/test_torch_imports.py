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
        assert {"repro_torch.train.optimizer", "repro_torch.train.checkpoint",
                "repro_torch.train.trainer",
                "repro_torch.launch.train"} <= set(names), names
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert callable(chip_smoke.main)
    """) + LEAKS)


@pytest.mark.parametrize("module", [
    "repro_torch.core.format", "repro_torch.core.partition",
    "repro_torch.core.parallel_encode", "repro_torch.data.matrices",
    "repro_torch.obs", "repro_torch.convert", "repro_torch.configs",
    "repro_torch.core.features", "repro_torch.core.autotune",
    "repro_torch.analysis", "repro_torch.obs.profile"])
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


def test_flash_variants_tool_imports_no_jax_and_needs_a_card():
    """``tools/flash_variants.py`` (kernel variants timed on the card)
    imports nothing of JAX, and its edits still apply to the source."""
    run(textwrap.dedent("""
        import sys
        sys.path.insert(0, "tools")
        import flash_variants as fv
        for edits in fv.VARIANTS.values():
            fv.variant_source(edits)
    """) + LEAKS)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "tools/flash_variants.py"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


@pytest.mark.parametrize("tool", ["spmv_variants", "spmm_variants"])
def test_stream_variant_tool_imports_no_jax_and_needs_a_card(tool):
    """``tools/spmv_variants.py`` and ``tools/spmm_variants.py`` (the
    stream kernels' plans and source variants timed on the card) import
    nothing of JAX, and their edits still apply to the source."""
    run(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, "tools")
        import {tool} as tool
        for edits, _ in tool.VARIANTS.values():
            tool.variant_source(edits)
    """) + LEAKS)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, f"tools/{tool}.py"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_variant_build_binds_a_tree_module_to_its_own_build():
    """``tools/variant_build.tree_module`` loads a tree's wrapper module
    beside the package, declares that tree's C entries on the library
    built from its source, and makes the module launch through it."""
    run(textwrap.dedent("""
        import sys, types
        sys.path.insert(0, "tools")
        import variant_build as vb
        from repro_torch.kernels import serpens_spmv as ks
        built = []
        lib = types.SimpleNamespace(**{
            name: types.SimpleNamespace() for name in (
                "serpens_spmv", "serpens_spmm", "serpens_spmv_fused")})

        def fake_build(stem, source, pattern):
            built.append((stem, "spmv_kernel" in source, pattern))
            return lib, ["report"]

        vb.nvcc_build = fake_build
        mod, report = vb.tree_module(".", "kernels.serpens_spmv",
                                     "serpens_spmv", "p")
        assert mod is not ks and mod._library() is lib, mod
        assert report == ["report"] and built == [
            ("tree_serpens_spmv", True, "p")], built
        assert lib.serpens_spmv.restype is not None
    """) + LEAKS)


def test_cuda_emulation_tool_imports_no_jax():
    """``tools/cuda_emulate.py`` (the backward kernel's source run on the
    CPU) imports nothing of JAX, and its edits still apply to the
    source."""
    run(textwrap.dedent("""
        import sys
        sys.path.insert(0, "tools")
        import cuda_emulate
        assert "emu_launch(" in cuda_emulate.emulated_source(
            "flash_attention_bwd")
    """) + LEAKS)
