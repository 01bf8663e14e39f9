"""Model zoo (counterpart of kungfu_tpu/models): the GPT family, the
ResNet family, the MNIST perceptrons, VGG16/19 and the BERT encoder.
``FakeModel`` (the allreduce benchmark's gradient-size fixtures) is not
ported yet."""
from .bert import BertEncoder, bert_base, bert_tiny
from .gpt import GPTConfig
from .resnet import ResNet, ResNet50, ResNet101, ResNet152
from .simple import VGG16, VGG19, MnistMLP, MnistSLP

__all__ = [
    "BertEncoder", "bert_base", "bert_tiny", "GPTConfig",
    "ResNet", "ResNet50", "ResNet101", "ResNet152", "VGG16", "VGG19",
    "MnistMLP", "MnistSLP",
]
