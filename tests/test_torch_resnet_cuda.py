"""The ResNet slice on the card: the f32 ResNet on the card against the
same weights on the CPU, and the Prefetcher's staged batches against
their source.  Every test here needs a CUDA device and skips without one.
The file imports no JAX (nor does chip_smoke.py, whose checks it
shares), so it also runs on a GPU machine without it, from the root of
the repo:

    python -m pytest --noconftest -m cuda tests/test_torch_resnet_cuda.py

Limits: chip_smoke.RESNET_TOL (f32 card against CPU: 1e-3 of the
largest |logit|, and of max(1, |value|) per statistic and parameter).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from kungfu_tpu_torch.data.pipeline import Prefetcher, to_device
from kungfu_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card as the entry points take it: ``resolve_device`` turns
    TF32 off, so f32 convolutions are full f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")


@pytest.mark.parametrize("stage_sizes,image", [((1, 1), 32),
                                               ((3, 4, 6, 3), 64)],
                         ids=["small", "resnet50"])
def test_resnet_f32_on_the_card_matches_the_cpu(cuda_device, stage_sizes,
                                                image):
    over = chip_smoke.resnet_card_vs_cpu(cuda_device, 4, image, stage_sizes)
    assert max(over.values()) <= 1, over


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetcher_stages_batches_unchanged_and_in_order(cuda_device,
                                                          depth):
    rng = np.random.RandomState(depth)
    src = [{"x": rng.rand(16, 8, 8, 3).astype(np.float32),
            "y": rng.randint(0, 10, 16)} for _ in range(6)]
    with Prefetcher(iter(src), depth=depth,
                    place=to_device(cuda_device)) as pf:
        got = list(pf)
    assert len(got) == len(src)
    for g, s in zip(got, src):
        assert g["x"].device.type == "cuda"
        assert torch.equal(g["x"].cpu(), torch.from_numpy(s["x"]))
        assert torch.equal(g["y"].cpu(), torch.from_numpy(s["y"]))
