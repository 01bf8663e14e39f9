"""Benchmarks of the port (counterpart of kungfu_tpu/benchmarks): the GPT
training-throughput run, ``python -m kungfu_tpu_torch.benchmarks.gpt``,
the kernel roofline, ``python -m kungfu_tpu_torch.benchmarks.roofline``,
and ResNet-50 training throughput, ``python -m
kungfu_tpu_torch.benchmarks.resnet`` (the repo's bench.py on the
port)."""
