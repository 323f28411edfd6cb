"""Build the JAX package's native libraries once, before test workers start.

The JAX package's loaders (``mrp_gnn_tpu/data/native.py``,
``graph_native.py``) build ``native/lib*.so`` in place on first use. Under
``pytest -p xdist``, several workers meeting a tree without the libraries
build them at once, and a worker that loads a half-written file gives up on
the library for its process, so its native tests skip. Here the controller
(the process without ``workerinput``) builds both libraries in one
subprocess before any worker starts; the workers then find each library
and its smoke stamp fresh and never rebuild. The controller itself imports
no JAX: the build runs in the subprocess, under ``JAX_PLATFORMS=cpu``.

It writes only the git-ignored ``native/*.so`` and ``native/*.so.ok`` that
the loaders write anyway. A failed or timed-out build changes nothing: the
loaders then behave as before.
"""

import os
import subprocess
import sys

_BUILD = ("from mrp_gnn_tpu.data import graph_native, native; "
          "native.is_available(); graph_native.is_available()")
BUILD_TIMEOUT_S = 600


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    try:
        subprocess.run([sys.executable, "-c", _BUILD], cwd=root, env=env,
                       capture_output=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired):
        pass
