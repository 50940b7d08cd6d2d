"""The port's public names (`pls_tpu_torch.__all__`) against the JAX package's.

Every name of `pls_tpu.__all__` whose object the port defines under the
same module path (`pls_tpu.utils.binio.stats_from_npy` ->
`pls_tpu_torch.utils.binio.stats_from_npy`) must resolve on
`pls_tpu_torch` itself, as the same object.  The one known gap is
`__version__`, the package metadata.  A gap that the port fills must
leave the lists, so they cannot go stale.
"""

import importlib

import pytest

import pls_tpu
import pls_tpu_torch

# whole JAX modules the port has no counterpart of (none: every module of
# the public API is ported)
GAP_MODULES: set[str] = set()
# names missing from modules the port has
GAP_NAMES = {
    "__version__",  # package metadata: the port's version is its repo's
}


def _port_module_and_attr(name: str):
    """(the port's module path for a JAX public name, the attribute there),
    or (None, None) where the object has no module path of its own."""
    obj = getattr(pls_tpu, name)
    module = None if isinstance(obj, str) else getattr(obj, "__module__", None)
    if module is None or not module.startswith("pls_tpu."):
        return None, None
    return "pls_tpu_torch" + module[len("pls_tpu"):], getattr(obj, "__name__", name)


def _implemented(name: str) -> bool:
    path, attr = _port_module_and_attr(name)
    if path is None:
        return False
    try:
        module = importlib.import_module(path)
    except ImportError:
        return False
    return hasattr(module, attr)


@pytest.mark.parametrize("name", sorted(pls_tpu.__all__))
def test_jax_public_name_resolves_where_ported(name):
    path, attr = _port_module_and_attr(name)
    module = getattr(getattr(pls_tpu, name), "__module__", None)
    if name in GAP_NAMES or module in GAP_MODULES:
        assert not _implemented(name), f"{name} is ported: drop it from the known gaps"
        return
    assert _implemented(name), f"{name} ({path}.{attr}) is neither ported nor a known gap"
    assert name in pls_tpu_torch.__all__
    assert getattr(pls_tpu_torch, name) is getattr(importlib.import_module(path), attr)


def test_port_all_resolves_and_imports_no_jax_names():
    assert len(set(pls_tpu_torch.__all__)) == len(pls_tpu_torch.__all__)
    for name in pls_tpu_torch.__all__:
        assert getattr(pls_tpu_torch, name).__module__.startswith("pls_tpu_torch"), name


def test_known_gap_modules_are_modules_of_the_jax_package():
    for module in GAP_MODULES:
        importlib.import_module(module)
    assert GAP_NAMES <= set(pls_tpu.__all__)


def test_parallel_names_are_the_jax_packages():
    import pls_tpu.parallel
    import pls_tpu_torch.parallel

    assert pls_tpu_torch.parallel.__all__ == pls_tpu.parallel.__all__
    for name in pls_tpu_torch.parallel.__all__:
        assert getattr(pls_tpu_torch.parallel, name).__module__.startswith("pls_tpu_torch.parallel")
