"""PyTorch / CUDA port of the multi-robot perception GNN framework.

A second package beside the JAX reference ``mrp_gnn_tpu``, with the same
module paths: config presets, graph batching, synthetic data, the model,
the serving ``Predictor``, the losses and the training step and loop. Plain tensor code is PyTorch; the TPU's Pallas
kernels become CUDA kernels written for Hopper (``ops/csrc``), built with
``nvcc`` at first use. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``. This package imports nothing of JAX.
"""

__version__ = "0.1.0"

_LAZY = {"GraphBatch": "mrp_gnn_tpu_torch.graph",
         "MultiRobotPerceptionNet": "mrp_gnn_tpu_torch.models.net",
         "make_dataset": "mrp_gnn_tpu_torch.data.pipeline"}


def __getattr__(name):
    # Imported on first use, so that a process that loads an exported
    # program (serving.load_exported) never imports the model code.
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
