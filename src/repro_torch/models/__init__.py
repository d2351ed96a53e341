# The paper's MLP is ``paper_nets.mlp`` (or ``PAPER_MODELS["mlp"]``): the
# name ``repro_torch.models.mlp`` is the zoo's feed-forward module, as in
# the JAX package.
from .paper_nets import PAPER_MODELS, PaperModel, cnn_cifar, cnn_mnist

__all__ = ["PAPER_MODELS", "PaperModel", "cnn_cifar", "cnn_mnist"]
