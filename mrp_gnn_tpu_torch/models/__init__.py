from mrp_gnn_tpu_torch.models.net import MultiRobotPerceptionNet  # noqa: F401
