"""Nothing the benchmark runs loads JAX or the JAX package: a dry import of
every harness module, driver and metric, and of the port's entry points that
the drivers call, in a fresh process."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CODE = r"""
import glob, importlib, os, sys
sys.path.insert(0, ROOT)
from benchmark.harness import registry, runner, training, data
for path in sorted(glob.glob(os.path.join(ROOT, "benchmark", "harness", "*.py"))
                   + glob.glob(os.path.join(ROOT, "benchmark", "drivers", "*.py"))):
    mod = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
    importlib.import_module(mod.replace(".__init__", ""))
for name in registry.reader_names():
    registry.metric(name)
training.launch_counters()
data.program_data()
data.reference_data()
import unidet3d_tpu_torch.train.loop, unidet3d_tpu_torch.data.loader
import unidet3d_tpu_torch.parallel.train_step
print(sorted({m.split(".")[0] for m in sys.modules} & set(runner.FORBIDDEN)))
"""


def test_no_jax_or_jax_package_is_loaded():
    proc = subprocess.run([sys.executable, "-c", CODE.replace("ROOT", repr(ROOT))], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[0] == "[]", proc.stdout


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import types

    from benchmark.harness import runner

    monkeypatch.setitem(sys.modules, "unidet3d_tpu_torch.fake", types.ModuleType("fake"))
    assert "unidet3d_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "unidet3d_tpu.fake", types.ModuleType("fake"))
    assert "unidet3d_tpu" in runner.forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n" % ROOT
            + "import importlib, pkgutil, benchmark.reference.refnet as r\n"
            + "for m in pkgutil.walk_packages(r.__path__, r.__name__ + '.'):\n"
            + "    importlib.import_module(m.name)\n"
            + "print(sorted({m.split('.')[0] for m in sys.modules} & "
            + "{'unidet3d_tpu_torch', 'unidet3d_tpu', 'jax'}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
