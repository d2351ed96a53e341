from .paper_nets import PAPER_MODELS, PaperModel, cnn_cifar, cnn_mnist, mlp

__all__ = ["PAPER_MODELS", "PaperModel", "cnn_cifar", "cnn_mnist", "mlp"]
