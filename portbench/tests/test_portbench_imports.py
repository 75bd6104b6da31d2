"""What the harness, the configurations, the metrics and the reference
import: never `jax` or the JAX package (top-level names compared whole:
the port's own name begins with the JAX package's), and for the
reference nothing of the port."""
import json
import subprocess
import sys

from portbench import harness

PROBE = """
import importlib, json, sys
sys.path.insert(0, {root!r})
from portbench import harness
for m in {modules!r}:
    importlib.import_module(m)
for f in {files!r}:
    harness.load_module(harness.HERE / f)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


PACKAGE = ["portbench.run", "portbench.readings", "portbench.trace",
           "portbench.reference.compare", "portbench.reference.measure",
           "portbench.reference.moving", "portbench.reference.outputs",
           "portbench.reference.solver"]


def top_level(files, modules):
    code = PROBE.format(root=str(harness.ROOT), files=files, modules=modules)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_harness_configs_metrics_import_no_jax():
    files = sorted(str(p.relative_to(harness.HERE)) for p in
                   [*harness.HERE.glob("configs/*.py"), *harness.HERE.glob("metrics/*.py")])
    names = top_level(files, PACKAGE)
    assert "waterlily_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    files = sorted(str(p.relative_to(harness.HERE))
                   for p in harness.HERE.glob("configs/*_ref.py"))
    names = top_level(files, [m for m in PACKAGE if m.startswith("portbench.reference")])
    assert "torch" in names
    assert "waterlily_tpu_torch" not in names
    assert not names & set(harness.FORBIDDEN)
