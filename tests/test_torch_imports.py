"""Package rules of the PyTorch port.

* No file under ``src/repro_torch/``, not the example twins
  ``examples/*_torch.py`` and not ``chip_smoke.py``, imports
  ``jax`` or anything of the JAX package ``repro`` (AST scan, so a lazy
  import inside a function counts too).
* The entry points run on ``cuda`` by default and raise when no GPU is
  present, unless the caller passes ``device="cpu"``.
"""
import ast
import os

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore
from repro_torch.launch import serve
from repro_torch.models.schema import init_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "optax")


def _port_files():
    pkg = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    for twin in ("quickstart", "migration", "multi_finetune",
                 "unified_serving"):
        yield os.path.join(ROOT, "examples", f"{twin}_torch.py")
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_imports_neither_jax_nor_the_jax_package():
    files = list(_port_files())
    assert len(files) > 20 and all(os.path.exists(f) for f in files)
    bad = [f"{os.path.relpath(f, ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f)
           if mod in FORBIDDEN]
    assert bad == []


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    cfg = get_reduced("llama3-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdapterStore(cfg, LoRAConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1"])
    params = init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert AdapterStore(cfg, LoRAConfig(), device="cpu").device.type == "cpu"
