"""Nothing the harness or the reference imports is jax, jaxlib, flax or
quill_tpu, compared by whole top-level names; the reference imports
nothing of quill_tpu_torch."""

import ast
import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "quill_tpu"}


def loaded_after(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{ROOT!r}, {BENCH!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_package():
    tops = loaded_after(
        "import run, harness, registry, devtrace, msm_work, faults\n"
        "from registry import Registry\n"
        "r = Registry()\n"
        "[r.reader(m['name']) for m in r.manifest()['per_layer'] + "
        "r.manifest()['end_to_end']]\n"
        "import quill_tpu_torch.proof.hyperplonk, "
        "quill_tpu_torch.engine.device, quill_tpu_torch.pcs.kzg")
    assert not tops & FORBIDDEN
    assert "quill_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded_after(
        "from reference import verify, curve, blake3\n"
        "from registry import Registry\n"
        "st = Registry().circuit('fibonacci').Statement.from_seed(3, 7)\n"
        "v = verify.Verifier(st, 12345)")
    assert not tops & (FORBIDDEN | {"quill_tpu_torch", "torch"})


def test_no_source_names_a_jax_package():
    for dirpath, dirs, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in FORBIDDEN, (f, n)
            if os.path.basename(dirpath) == "reference":
                src = open(os.path.join(dirpath, f)).read()
                assert "quill_tpu" not in src, f


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import types

    import run

    monkeypatch.setitem(sys.modules, "quill_tpu_torch_extra",
                        types.ModuleType("quill_tpu_torch_extra"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "quill_tpu.fields",
                        types.ModuleType("quill_tpu.fields"))
    assert run.forbidden_modules() == ["quill_tpu"]
