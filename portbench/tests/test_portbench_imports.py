"""What the benchmark loads: no module whose top-level name, compared whole,
is jax, jaxlib, flax or opv_tpu (the port's name begins with opv_tpu, so a
prefix test would be wrong), and a reference that loads nothing of the
program."""

import ast
import subprocess
import sys

from portbench.tests.small import ROOT

BANNED = {"jax", "jaxlib", "flax", "opv_tpu"}
PB = ROOT / "portbench"


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_run_loads_no_jax():
    top = _loaded("import portbench.run, portbench.cell, portbench.control\n"
                  "from portbench.run import reader\n"
                  "import json\n"
                  "b = json.load(open('BENCHMARK.json'))\n"
                  "[reader(m['name'])\n"
                  " for m in b['end_to_end'] + b['per_layer']]\n"
                  "import opv_tpu_torch.stream.wideband, "
                  "opv_tpu_torch.stream.locked, opv_tpu_torch.rx.channelizer")
    assert "opv_tpu_torch" in top
    assert not top & BANNED, top & BANNED


def test_whole_names_not_prefixes():
    # opv_tpu_torch is the program, not the JAX package
    assert "opv_tpu_torch".split(".")[0] not in BANNED


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import portbench.reference, portbench.generator, "
                  "portbench.peaks")
    assert not any(m.startswith("opv_tpu") for m in top), top


def test_no_source_under_portbench_imports_jax():
    for path in PB.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in BANNED, (path, n)
