"""What the benchmark imports: every module the harness reaches (its
files, the metric readers and the program's modules they import) by
its top-level name, whole, with no ``jax``, ``jaxlib``, ``flax`` or
``dart_tpu``; and the reference, which also imports nothing of
``dart_tpu_torch``. Read from the sources with ``ast`` (imports inside
functions too), and checked again in a process that runs a cell."""

import ast
import glob
import os
import subprocess
import sys

import benchtoy

REPO = benchtoy.REPO
REFUSED = {"jax", "jaxlib", "flax", "dart_tpu"}


def module_file(name):
    base = os.path.join(REPO, *name.split("."))
    for p in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(p):
            return p
    return None


def module_name(path):
    rel = os.path.relpath(path, REPO)[:-3].split(os.sep)
    return ".".join(rel[:-1] if rel[-1] == "__init__" else rel)


def imported(path):
    """The modules a source file imports, as absolute names."""
    with open(path) as f:
        tree = ast.parse(f.read())
    me = module_name(path)
    pkg = me if path.endswith("__init__.py") else me.rpartition(".")[0]
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = pkg.split(".")
                base = ".".join(parts[:len(parts) - node.level + 1])
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            out.add(mod)
            out |= {f"{mod}.{a.name}" for a in node.names
                    if module_file(f"{mod}.{a.name}")}
    return out


def closure(paths):
    """Every module name reached from the files, following the repo's
    own modules."""
    seen, todo, names = set(), list(paths), set()
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for name in imported(p):
            names.add(name)
            parts = name.split(".")
            for k in range(1, len(parts) + 1):
                f = module_file(".".join(parts[:k]))
                if f:
                    todo.append(f)
    return {n.split(".")[0] for n in names}


def test_the_harness_imports_no_jax_and_no_jax_package():
    paths = [os.path.join(REPO, "benchmark", "run.py")]
    paths += glob.glob(os.path.join(REPO, "benchmark", "metrics", "*.py"))
    tops = closure(paths)
    assert "dart_tpu_torch" in tops and "torch" in tops
    assert not tops & REFUSED, tops & REFUSED


def test_the_reference_imports_nothing_of_the_program():
    tops = closure([os.path.join(REPO, "benchmark", "refcheck.py")])
    assert not tops & (REFUSED | {"dart_tpu_torch"}), tops
    assert tops <= {"numpy", "gzip", "re", "struct", "__future__"}, tops


def test_a_run_loads_no_refused_module(tmp_path):
    root = benchtoy.make_root(str(tmp_path))
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from benchmark import harness\n"
        "res = harness.run_cell(%r, 'toy_se_gz', 5, 0.2, False, 'cpu')\n"
        "assert res['correct'], res['checks']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.refused_modules())\n"
        % (REPO, os.path.dirname(__file__), root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    tops, refused = out.stdout.strip().splitlines()[-2:]
    assert "dart_tpu_torch" in tops
    assert refused == "[]"
