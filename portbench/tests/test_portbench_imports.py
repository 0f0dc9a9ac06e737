"""Nothing the harness imports is JAX or the JAX package (compared by
whole top-level module name: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
PORT = "knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch"


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_the_harness_loads_no_jax_module():
    code = (
        "import sys, torch\n"
        "from pathlib import Path\n"
        "from portbench import run, control, system, kernel_trace, traffic, weights\n"
        "from portbench.reference import llava_onevision\n"
        "list(run.metric_modules())\n"
        "from portbench.tests.conftest import run_cell\n"
        "rc, result, err = run_cell('tiny-kd3', trace=1)\n"
        "assert rc == 0, err\n"
        "print(sorted({m.split('.', 1)[0] for m in sys.modules}))\n")
    tops = set(eval(_fresh(code).strip().splitlines()[-1]))
    assert PORT in tops  # the harness did drive the port
    assert not tops & run.JAX_NAMES, tops & run.JAX_NAMES


def test_the_guard_compares_whole_names():
    assert PORT.startswith("knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu")
    assert PORT not in run.JAX_NAMES


def test_the_reference_imports_nothing_of_the_port():
    """Beside torch and a few modules of the standard library, the
    reference imports only its own modules and the harness's loader."""
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [f"{node.module}.{a.name}" for a in node.names]
            for n in names:
                assert (n.split(".")[0] in {"torch", "math", "typing", "__future__", "pathlib"}
                        or n.startswith("portbench.reference.") or n == "portbench.loader"), (path.name, n)
    code = ("import sys\nfrom portbench.reference import llava_onevision, anyres, lm\n"
            "lm.of({'model_type': 'qwen2'})\n"
            f"assert not any(m.split('.')[0] == {PORT!r} for m in sys.modules)\nprint('ok')\n")
    assert _fresh(code).strip() == "ok"


def test_only_the_system_module_imports_the_port():
    for path in (ROOT / "portbench").rglob("*.py"):
        if path.name == "system.py" or "tests" in path.parts:
            continue
        assert PORT not in path.read_text(), path
