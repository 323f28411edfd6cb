"""The JAX package's native libraries, built for this test process alone.

The JAX package's loaders (``mrp_gnn_tpu/data/native.py``,
``graph_native.py``) have g++ write ``native/librenderer.so`` and
``native/libgraphbuild.so`` in place, and a loader in another process that
meets a half-written file deletes it, rebuilds it, and gives up for the
rest of its process when its second smoke call also fails. Port tests that
run beside other processes (pytest-xdist workers) would then meet JAX's
numpy fallback or a missing library. :func:`jax_native` points both JAX
loaders at libraries under this process's own temporary directory, so no
other process writes them; nothing of the JAX package changes.

Use it in a test module with::

    from torch_native_jax import jax_native  # noqa: F401
    pytestmark = pytest.mark.usefixtures("jax_native")

or on single tests with ``@pytest.mark.usefixtures("jax_native")``.
"""

from __future__ import annotations

import os

import pytest

from mrp_gnn_tpu.data import graph_native as jgn
from mrp_gnn_tpu.data import native as jnative

_MODULES = (jnative, jgn)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """Both JAX native libraries, built into a directory of this process's
    own (pytest gives each xdist worker its own base directory) and loaded
    afresh: ``_LIB`` of each loader module points there, ``_lib`` and
    ``_failed`` start cleared, and all three are restored afterwards.
    Asserts that both libraries are available, so a failing build fails
    the test rather than turning it into a comparison with numpy. Yields
    the directory."""
    where = tmp_path_factory.getbasetemp() / "jax_native"
    where.mkdir(exist_ok=True)
    saved = [(m, m._LIB, m._lib, m._failed) for m in _MODULES]
    for m in _MODULES:
        m._LIB = str(where / os.path.basename(m._LIB))
        m._lib, m._failed = None, False
    try:
        assert jnative.is_available(), "the JAX native renderer did not build"
        assert jgn.is_available(), "the JAX native graph builder did not build"
        yield where
    finally:
        for m, lib_path, lib, failed in saved:
            m._LIB, m._lib, m._failed = lib_path, lib, failed
