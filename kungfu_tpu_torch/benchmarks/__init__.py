"""Benchmarks of the port (counterpart of kungfu_tpu/benchmarks): so far
the GPT training-throughput run, ``python -m kungfu_tpu_torch.benchmarks.gpt``."""
