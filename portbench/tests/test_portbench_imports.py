"""No module the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program either; top-level names are
compared whole, since the port's name starts with the JAX package's."""

import ast
import json
import subprocess
import sys

from portbench import harness

HARNESS_MODULES = ["portbench.harness", "portbench.trace", "portbench.roofline",
                   "portbench.control", "portbench.reference", "portbench.traffic.footage",
                   "portbench.drivers.stabilize_frame", "portbench.drivers.serve_files",
                   "portbench.drivers.sharded_chunk"]


def loaded_after(modules, extra=""):
    code = (f"import sys; sys.path.insert(0, {str(harness.ROOT)!r}); "
            + "".join(f"import {m}; " for m in modules) + extra
            + "import json; print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_forbidden_names_are_whole_names():
    assert "video_stabilization_tpu" in harness.FORBIDDEN_MODULES
    sys.modules.setdefault("video_stabilization_tpu_torchx_probe", sys)
    try:
        assert "video_stabilization_tpu_torchx_probe" not in harness.forbidden_loaded()
    finally:
        del sys.modules["video_stabilization_tpu_torchx_probe"]


def test_the_harness_and_the_port_load_no_jax():
    metrics = "".join(f"portbench.harness.load_metric({m['name']!r}); "
                      for m in harness.benchmark()["end_to_end"] + harness.benchmark()["per_layer"])
    names = loaded_after(HARNESS_MODULES + ["video_stabilization_tpu_torch.serve",
                                            "video_stabilization_tpu_torch.parallel"], metrics)
    assert not names & set(harness.FORBIDDEN_MODULES)
    assert "video_stabilization_tpu_torch" in names


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after(["portbench.reference", "portbench.reference.y4m",
                          "portbench.traffic.sim"])
    assert not names & (set(harness.FORBIDDEN_MODULES) | {"video_stabilization_tpu_torch"})


def test_the_reference_names_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                for n in names:
                    assert n.split(".")[0] in ("portbench", "torch", "numpy", "__future__",
                                               "dataclasses", "typing", "functools", "enum",
                                               "math"), (path, n)
