"""The port's copies of ``dart_tpu``'s host code kept in step: each copy
must equal its original once comments and docstrings are stripped
(Python compared as syntax trees, C++ line by line without comments and
blank lines). The files that differ by design are listed with a reason,
and every port file with an original at the same path must be in one of
the lists, so that a new copy is classified when it lands."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT, ORIG = ROOT / "dart_tpu_torch", ROOT / "dart_tpu"

IDENTICAL = [
    "index/__init__.py", "index/suffix_array.py", "io/__init__.py",
    "io/bam.py", "io/fastx_fast.py", "native/__init__.py",
    "native/layout.cpp", "ops/__init__.py", "pipeline/__init__.py",
    "pipeline/chaining.py", "pipeline/cigar.py", "pipeline/finalize.py",
    "pipeline/junctions.py", "pipeline/kmer.py", "pipeline/native_chunk.py",
    "pipeline/pairing.py", "pipeline/report.py", "pipeline/structs.py",
]
COMMENTS_ONLY = [
    "__init__.py", "config.py", "constants.py", "evaluation.py",
    "index/builder.py", "index/layout_cache.py", "index/loader.py",
    "index/packer.py", "io/fastx.py", "ops/nw_numpy.py",
    "parallel/__init__.py", "native/bamenc.cpp", "native/pack.cpp",
    "native/pipeline.cpp", "native/sais.cpp", "native/zoo.cpp",
]
BY_DESIGN = {
    "aligner.py": "the engine is FMIndexTorch on a device; no JAX engine "
                  "choice, compile cache or jax.profiler",
    "cli.py": "--device, the port's usage, torch.distributed flags",
    "native/build.py": "its own library name, libdart_torch_native, built "
                       "into dart_tpu_torch/_build",
    "pipeline/seeding.py": "no seed_drain path: the engine's kernels run "
                           "every lane to its end in one launch",
    "parallel/distributed.py": "torch.distributed over gloo in place of "
                               "jax.distributed",
    "parallel/mesh.py": "ShardedFMIndexTorch over a list of torch devices "
                        "in place of a jax.sharding.Mesh",
}


def strip_python(src: str) -> str:
    """The syntax tree of a Python source without its docstrings."""
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:]
    return ast.dump(tree)


def strip_cpp(src: str) -> list[str]:
    """A C++ source's lines without // and /* */ comments (string and
    character literals kept), each stripped, blank ones dropped."""
    out, i, n, quote = [], 0, len(src), None
    while i < n:
        c = src[i]
        if quote:
            out.append(c)
            if c == "\\":
                out.append(src[i + 1])
                i += 1
            elif c == quote:
                quote = None
        elif c in "\"'":
            quote = c
            out.append(c)
        elif src.startswith("//", i):
            i = src.find("\n", i)
            if i < 0:
                break
            continue
        elif src.startswith("/*", i):
            i = src.index("*/", i) + 2
            continue
        else:
            out.append(c)
        i += 1
    return [ln.strip() for ln in "".join(out).splitlines() if ln.strip()]


def stripped(path: pathlib.Path):
    src = path.read_text()
    return strip_python(src) if path.suffix == ".py" else strip_cpp(src)


@pytest.mark.parametrize("rel", IDENTICAL + COMMENTS_ONLY)
def test_copy_equals_its_original(rel):
    assert stripped(PORT / rel) == stripped(ORIG / rel), (
        f"dart_tpu_torch/{rel} has drifted from dart_tpu/{rel}: make the "
        "change in both packages")


def test_every_copy_is_classified():
    """Each port file with an original at the same path is listed once;
    the listed originals exist, and the files listed as differing by
    design do differ."""
    copies = {str(p.relative_to(PORT)) for p in PORT.rglob("*")
              if p.suffix in (".py", ".cpp")
              and (ORIG / p.relative_to(PORT)).exists()}
    listed = IDENTICAL + COMMENTS_ONLY + list(BY_DESIGN)
    assert len(listed) == len(set(listed))
    assert copies == set(listed)
    for rel in BY_DESIGN:
        assert stripped(PORT / rel) != stripped(ORIG / rel), rel


def test_stripping_sees_code_but_not_comments():
    """The comparison ignores comments and docstrings and nothing else."""
    a = 'def f(x):\n    """doc"""\n    return x + 1  # one\n'
    assert strip_python(a) == strip_python("def f(x):\n    return x + 1\n")
    assert strip_python(a) != strip_python("def f(x):\n    return x + 2\n")
    c = 'int f() { // c\n  /* d\n e */ return "//" [0]; }\n'
    assert strip_cpp(c) == ["int f() {", 'return "//" [0]; }']
