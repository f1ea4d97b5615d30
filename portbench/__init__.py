"""The benchmark of adv_grpo_torch on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once and prints one JSON line (see ``portbench/README.md``).
Nothing here imports JAX or the JAX package; ``portbench/reference`` imports
nothing of ``adv_grpo_torch`` either.
"""
