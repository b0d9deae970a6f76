"""Plain float32 PyTorch references: no kernel, no cache, nothing of the
program, nothing of the JAX package.

A configuration file names its reference module (``"reference":
"portbench/reference/<module>.py"``): the weight layout
(``leaf_shapes``), the pruning of the dense weights (``prepare``), the
forward pass (``hidden``, ``matmul``, ``logits_at``), the kept counts
the floors read (``kept_counts``) and ``no_tf32``.  A configuration of
another family brings a module of its own, found by that name.
"""
import importlib
import pathlib


def module_of(model: dict):
    """The reference module a configuration names."""
    path = pathlib.PurePosixPath(model["reference"])
    if str(path.parent) != "portbench/reference" or path.suffix != ".py":
        raise ValueError(f"reference {model['reference']!r} is not a "
                         f"module of portbench/reference/")
    return importlib.import_module(f"{__name__}.{path.stem}")
