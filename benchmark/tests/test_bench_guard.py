"""Nothing of JAX in the measured process, nothing of the program in the
reference."""

import ast
import subprocess
import sys

import pytest

from harness import guard, manifest

SCRIPT = """
import sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""


def _top_modules(body: str) -> set:
    code = SCRIPT.format(bench=str(manifest.BENCH_DIR), root=str(manifest.ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    return set(out.stdout.split())


def test_guard_compares_top_level_names_whole():
    mods = {"classpp_public_torch": 1, "classpp_public_torch.classy": 1, "jaxtyping": 1,
            "numpy": 1}
    assert guard.loaded(modules=mods) == []
    mods.update({"jax.numpy": 1, "classpp_public_tpu.classy": 1, "flax": 1})
    assert guard.loaded(modules=mods) == ["classpp_public_tpu.classy", "flax", "jax.numpy"]


def test_harness_and_program_load_no_jax():
    """What run.py imports, and the program with every stage module of the
    cells, load neither JAX nor the JAX package."""
    body = ("import run\nfrom harness import session, reference, trace\n"
            "import classpp_public_torch\n"
            "from classpp_public_torch.models import background, thermodynamics, nonlinear, "
            "transfer, spectra, lensing, numbercounts, primordial\n"
            "from classpp_public_torch.models.perturbations import solve")
    tops = _top_modules(body)
    assert not tops & set(guard.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    body = ("import classref\n"
            "from classref.models import background, thermodynamics, nonlinear, transfer, "
            "spectra, lensing, numbercounts, primordial\n"
            "from classref.models.perturbations import solve")
    tops = _top_modules(body)
    assert "classpp_public_torch" not in tops and not tops & set(guard.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((manifest.BENCH_DIR / "classref").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(manifest.BENCH_DIR)))
def test_reference_sources_import_only_themselves(path):
    """Every import of the reference is relative, or of torch, numpy, scipy
    or the standard library."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue
            tops = {node.module.split(".")[0]}
        else:
            continue
        assert not tops & ({"classpp_public_torch"} | set(guard.FORBIDDEN)), (path, tops)
