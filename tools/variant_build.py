"""What the kernel-variant tools share: a kernel source with single edits
applied, one ``nvcc`` build of it with its ptxas report, and a module of an
earlier tree's port, bound to that tree's own build of its source.

Builds use the repository's nvcc flags (``kernels/build.py``) and go to
``build/variants/``; nothing here runs without ``nvcc`` or imports JAX.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import importlib.util
import os
import re
import subprocess
import sys

from repro_torch.kernels import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "variants")


def variant_source(source, edits) -> str:
    """The text of ``source`` with each ``(old, new)`` edit applied; each
    ``old`` must occur exactly once."""
    with open(source) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"variant edit not found once: {old!r}")
        src = src.replace(old, new)
    return src


def nvcc_build(stem: str, source: str, pattern: str, label=lambda hit: hit[0]):
    """nvcc of ``source`` into ``build/variants/<stem>.so``; returns (the
    loaded library, the ptxas lines of each entry function whose name
    matches ``pattern``, as ``label(match): registers, spills``, and one
    more for each whose wgmma ptxas serialised)."""
    os.makedirs(OUT, exist_ok=True)
    stem = re.sub(r"\W+", "_", stem)
    cu, so = os.path.join(OUT, stem + ".cu"), os.path.join(OUT, stem + ".so")
    with open(cu, "w") as f:
        f.write(source)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{stem}: nvcc failed\n{proc.stdout}{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    report = []
    for i, line in enumerate(lines):
        hit = re.search(pattern, line)
        if hit and "Performance Loss" in line:
            report.append(f"{label(hit)}: wgmma serialised by ptxas")
        if hit and "Compiling entry function" in line:
            report.append(f"{label(hit)}: " + " ".join(
                x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4]))
    return ctypes.CDLL(so), report


def build_all(jobs: dict) -> dict:
    """``{name: (fn, arg)}`` -> ``{name: fn(arg)}``, every nvcc at once."""
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futs = {name: pool.submit(fn, arg) for name, (fn, arg) in jobs.items()}
        return {name: f.result() for name, f in futs.items()}


def tree_module(tree: str, module: str, stem: str, pattern: str):
    """``repro_torch.<module>`` of the unpacked tree ``tree`` (a wrapper
    module whose ``_library()`` builds ``csrc/<stem>.cu`` and whose
    ``_declare(lib)`` sets its C entries' types), loaded beside this
    tree's package with its library replaced by that tree's own source
    built here.  Returns (the module, its ptxas report)."""
    path = os.path.join(tree, "src", "repro_torch", *module.split("."))
    spec = importlib.util.spec_from_file_location(
        f"tree_{stem}_{abs(hash(tree))}", path + ".py")
    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = os.path.join(os.path.dirname(path), "csrc", stem + ".cu")
    with open(src) as f:
        lib, report = nvcc_build("tree_" + stem, f.read(), pattern)
    mod._declare(lib)
    mod._library = lambda: lib
    return mod, report
