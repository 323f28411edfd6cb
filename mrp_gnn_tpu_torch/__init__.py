"""PyTorch / CUDA port of the multi-robot perception GNN framework.

A second package beside the JAX reference ``mrp_gnn_tpu``, with the same
module paths: config presets, graph batching, synthetic data, the model,
the serving ``Predictor``, the losses and the training step and loop. Plain tensor code is PyTorch; the TPU's Pallas
kernels become CUDA kernels written for Hopper (``ops/csrc``), built with
``nvcc`` at first use. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``. This package imports nothing of JAX.
"""

__version__ = "0.1.0"

from mrp_gnn_tpu_torch.graph import GraphBatch  # noqa: F401
from mrp_gnn_tpu_torch.models.net import MultiRobotPerceptionNet  # noqa: F401
from mrp_gnn_tpu_torch.data.pipeline import make_dataset  # noqa: F401
