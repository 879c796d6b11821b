"""The benchmark of the PyTorch and CUDA port (``theanet_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``); ``BENCHMARK.json`` at the
checkout's root names the cells and metrics, and ``cells.py`` finds each
one's files by name. Nothing here imports JAX or the JAX package."""
