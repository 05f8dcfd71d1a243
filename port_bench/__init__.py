"""The benchmark of the PyTorch and CUDA port (``fusion_sim_torch``).

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA card
and prints one JSON line.  Cells, configurations, traffic mixes, span
lists, per-layer metrics and kernel rooflines are files of their own,
found by the names ``BENCHMARK.json`` gives.
"""
