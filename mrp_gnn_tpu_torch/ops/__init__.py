"""Graph message-passing ops: plain torch implementations (``reference``)
and CUDA kernels (``bsp``, ``ell`` and ``edge``, sources in ``csrc/``).
Dispatch between them with :func:`mrp_gnn_tpu_torch.ops.dispatch.get_ops`.
Importing the package registers the kernels' forward ops
(``ops/library.py``), which the autograd Functions call.
"""
from mrp_gnn_tpu_torch.ops import library  # noqa: F401
