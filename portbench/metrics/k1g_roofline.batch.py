"""Kernel K1g (grouped bitmap products, the expert stacks): as
``k1_roofline.batch``, under the ``portbench.k1g`` label, in %."""
import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "portbench_k1_roofline", pathlib.Path(__file__).with_name(
        "k1_roofline.batch.py"))
_k1 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_k1)


def read(run):
    return _k1.roofline(run, grouped=True, label="portbench.k1g")
