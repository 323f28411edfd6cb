"""The benchmark of the PyTorch and CUDA port (``mrp_gnn_tpu_torch``).

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell (``run.py``). Everything that measures lives
here, where a change to the program cannot move it: the traffic generator
(``traffic.py``), the work counts and peaks (``work.py``), the tracing
(``trace.py``), the plain reference (``reference/``) and the comparison
that decides ``correct`` (``compare.py``). Cells, configurations, traffic
mixes and per-layer metrics are files found by name (``cells.py``).
"""
