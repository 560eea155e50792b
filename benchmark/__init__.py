"""The benchmark of slam_toolkit_tpu_torch on one CUDA card.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

See README.md. Nothing here imports jax or slam_toolkit_tpu; the plain
reference (reference/) imports nothing of slam_toolkit_tpu_torch either.
"""
