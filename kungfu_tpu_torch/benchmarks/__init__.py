"""Benchmarks of the port (counterpart of kungfu_tpu/benchmarks): the GPT
training-throughput run, ``python -m kungfu_tpu_torch.benchmarks.gpt``, and
the kernel roofline, ``python -m kungfu_tpu_torch.benchmarks.roofline``."""
