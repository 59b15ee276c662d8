"""Every public name of the JAX package has its counterpart in the port.

Both packages are read with `ast`, without importing them.  For each module
of `diffab_pytorch_tpu/`, every public module-level function and class and
every public method of a public class must exist under the same name in
the port's module at the same path, or be listed in RENAMES below with the
reason and the counterpart, which must exist.
"""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "diffab_pytorch_tpu")
PORT_PKG = os.path.join(REPO, "diffab_pytorch_tpu_torch")

_LAYER = "ops/ipa_fused_layer.py"
_ATTENTION = "ops/ipa_attention.py"
# (JAX module, name) -> (port module, name), or ("torch", attribute) where
# torch itself is the counterpart
RENAMES = {
    # the Pallas module's entry points: the port has one module per CUDA
    # kernel, K1 (the fused layer) and K2 (the attention core)
    ("ops/ipa_pallas.py", "fused_ipa_layer"): (_LAYER, "fused_ipa_layer"),
    ("ops/ipa_pallas.py", "fused_ipa_attention"): (_ATTENTION, "fused_ipa_attention"),
    ("ops/ipa_pallas.py", "fused_ipa_attention_raw"): (_ATTENTION, "fused_ipa_attention_raw"),
    # flax builds submodules in setup(); an nn.Module in its constructor
    ("models/diffab.py", "DiffAbModel.setup"): ("models/diffab.py", "DiffAbModel.__init__"),
    # helpers that torch has as ops
    ("geometry/so3.py", "tensor_trace"): ("torch", "diagonal"),  # .sum(-1)
    ("geometry/so3.py", "mat3_mul"): ("torch", "matmul"),
    ("geometry/so3.py", "identity_like"): ("torch", "eye"),  # .expand(r.shape)
    # the tensor-parallel step and the state it shards have their own module
    ("parallel/dp.py", "make_sharded_train_step"): ("parallel/tp.py", "make_sharded_train_step"),
    ("parallel/dp.py", "shard_state"): ("parallel/tp.py", "shard_state"),
}


def public_names(path: str) -> set[str]:
    """Public module-level functions and classes, and Class.method for the
    public methods of each public class."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    names = set()
    for node in tree.body:
        if isinstance(node, defs) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, defs[:2]) and not m.name.startswith("_")}
    return names


def defined_names(path: str) -> set[str]:
    """Every module-level def and class, and Class.method for every method
    (dunders included), public or not."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return names


JAX_MODULES = sorted(os.path.relpath(os.path.join(root, f), JAX_PKG).replace(os.sep, "/")
                     for root, _, files in os.walk(JAX_PKG) for f in files if f.endswith(".py"))


def counterpart_exists(module: str, name: str) -> bool:
    if module == "torch":
        return hasattr(importlib.import_module("torch"), name)
    path = os.path.join(PORT_PKG, module)
    return os.path.exists(path) and name in defined_names(path)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    names = public_names(os.path.join(JAX_PKG, module))
    missing = []
    for name in sorted(names):
        target = RENAMES.get((module, name), (module, name))
        if not counterpart_exists(*target):
            missing.append(f"{name} -> {target[0]}:{target[1]}")
    assert not missing, f"{module}: no counterpart in the port for {missing}"


def test_every_rename_is_needed_and_names_a_jax_name():
    """Each exception names a public JAX name that has no same-named
    counterpart, so that the list cannot hide a name the port has."""
    for (module, name), target in RENAMES.items():
        assert name in public_names(os.path.join(JAX_PKG, module)), (module, name)
        assert not counterpart_exists(module, name), f"{module}:{name} needs no rename"
        assert counterpart_exists(*target), target
