"""Data x graph parallelism on ``torch.distributed`` (port of
``mrp_gnn_tpu/parallel``): partition plans, the mesh of ranks, the
partitioned fusion with its halo exchange, and the context that wires them
from a config."""
