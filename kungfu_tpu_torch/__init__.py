"""kungfu_tpu_torch — the PyTorch + CUDA port of kungfu_tpu.

A second package beside the JAX one, module for module where a
counterpart exists.  Plain tensor code is PyTorch; every kernel the JAX
package wrote in Pallas for the TPU becomes a kernel written by hand for
Hopper (``ops/csrc``), built from the checkout at first use.

What is ported so far is the serving path (the GPT model's decode code,
the paged KV cache with its paged-decode CUDA kernel, the
continuous-batching engine, its HTTP front end and CLI,
``python -m kungfu_tpu_torch.serving``) and the training path (the GPT
forward with the flash-attention CUDA kernels, chunked cross-entropy,
``torch.distributed`` collectives, synchronous SGD and the train step,
``python -m kungfu_tpu_torch.benchmarks.gpt``).

The package imports neither JAX nor anything of ``kungfu_tpu``; it keeps
its own copy of what it needs.  Entry points run on ``cuda`` unless the
caller asks for the CPU, and raise when no CUDA device is present.
"""
from .utils.device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
