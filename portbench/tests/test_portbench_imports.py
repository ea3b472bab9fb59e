"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's), and nothing reads the harness that measured the JAX package.
The yardstick (reference, weights, judge, counts, trace reduction,
generator) and every model family, as loaded, import nothing of the port
either; the harness and the drivers know no family: they take sizes,
reference, judge and the port's model from the cell's."""

import ast
import glob
import os
import re
import subprocess
import sys

from portbench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "whisper_tpu"}
OLD_HARNESS = ("bench" + ".py", "benchmarks" + "/", "BENCH" + "_", "BASE" + "LINE.",
               "MULTI" + "CHIP_")
YARDSTICK = ("reference", "weights", "judge", "roofline", "tracing", "generate", "spec")
FAMILIES = sorted(os.path.basename(p)[:-3]
                  for p in glob.glob(os.path.join(ROOT, "portbench", "families", "*.py")))
GENERIC = ("harness.py", "spec.py", "control.py", "sweep.py", "drivers/*.py")
# an import of Whisper's weights or reference, a Whisper key, its sizes' type
WHISPER = re.compile(r"^\s*(from|import) .*\b(weights|reference)\b|d_model|encoder_layers"
                     r"|decoder_layers|\bDims\b", re.M)


def _sources():
    for folder, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(folder, f)


def test_no_import_of_jax_or_the_jax_package_by_name():
    for path in _sources():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     and node.level == 0 else [])
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, (path, names)


def test_no_read_of_the_old_harness():
    for path in _sources():
        text = open(path).read()
        assert not [s for s in OLD_HARNESS if s in text], path


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _modules_after("from portbench.tests import tiny\n"
                            "tiny.run('turbo-offline-b64', trace=1)")
    assert "whisper_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_the_yardstick_loads_nothing_of_the_port():
    assert "whisper" in FAMILIES
    loaded = _modules_after("".join(f"import portbench.{m}\n" for m in YARDSTICK) +
                            "".join(f"portbench.spec.family({f!r})\n" for f in FAMILIES))
    assert not loaded & (FORBIDDEN | {"whisper_tpu_torch"})


def test_the_harness_and_drivers_know_no_family():
    paths = sorted(p for g in GENERIC for p in glob.glob(os.path.join(ROOT, "portbench", g)))
    assert len(paths) >= 7
    for path in paths:
        assert not WHISPER.search(open(path).read()), path
