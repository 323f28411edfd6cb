"""Graph message-passing ops: plain torch implementations (``reference``)
and CUDA kernels (``bsp``, sources in ``csrc/``). Dispatch between them
with :func:`mrp_gnn_tpu_torch.ops.dispatch.get_ops`.
"""
