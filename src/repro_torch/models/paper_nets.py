"""The paper's experiment models (Section 5.1) as functions on tensor dicts.

* ``mlp``       -- 784-200-200-10 ReLU MLP (MNIST/FMNIST).
* ``cnn_mnist`` -- conv32-pool-conv64-pool-fc512-fc10 (MNIST/FMNIST).
* ``cnn_cifar`` -- 2x(conv-conv-pool-drop) + n_dense x fc512 + fc10
                   (CIFAR: n_dense=2, CINIC: n_dense=4 per the paper).

LoRA attaches to the dense ("fc*", "out") layers only; conv kernels, biases
and norms stay fully trainable.  Layouts are the JAX package's at every
public function: images NHWC, conv kernels HWIO, dense weights
(fan_out, fan_in); ``conv_apply`` permutes to NCHW/OIHW around
``F.conv2d`` internally.  ``apply`` of every model turns TF32 off (see
``runtime.full_fp32``): a TF32 convolution keeps about three decimal
digits, outside the reference's tolerances.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.runtime import full_fp32
from repro_torch.lora import apply_pair

PyTree = Any


# ------------------------------------------------------------ layer ops ----
def dense_init(gen: torch.Generator, fan_out: int, fan_in: int,
               dtype=torch.float32) -> dict:
    w = torch.randn((fan_out, fan_in), generator=gen, dtype=dtype,
                    device=gen.device) * math.sqrt(2.0 / fan_in)
    return {"w": w, "b": torch.zeros(fan_out, dtype=dtype, device=gen.device)}


def dense_apply(p: dict, x: torch.Tensor, lora_pair=None,
                alpha: float = 16.0) -> torch.Tensor:
    y = x @ p["w"].T + p["b"]
    if lora_pair is not None:
        y = y + apply_pair(x, lora_pair, alpha)
    return y


def conv_init(gen: torch.Generator, out_c: int, in_c: int, k: int = 3,
              dtype=torch.float32) -> dict:
    """HWIO kernel ``(k, k, in_c, out_c)``, zero bias."""
    w = torch.randn((k, k, in_c, out_c), generator=gen, dtype=dtype,
                    device=gen.device) * math.sqrt(2.0 / (in_c * k * k))
    return {"w": w, "b": torch.zeros(out_c, dtype=dtype, device=gen.device)}


def conv_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """NHWC conv with an HWIO kernel, SAME padding, stride 1."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                 padding="same")
    return y.permute(0, 2, 3, 1) + p["b"]


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, VALID, on NHWC."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def batch_stat_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Normalise with the batch's own statistics over every axis but the
    channel axis (no running state)."""
    dims = tuple(range(x.ndim - 1))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def dropout(gen: torch.Generator | None, x: torch.Tensor, rate: float,
            train: bool) -> torch.Tensor:
    if not train or rate <= 0.0:
        return x
    dev = gen.device if gen is not None else x.device
    keep = (torch.rand(x.shape, generator=gen, device=dev) < 1.0 - rate).to(
        x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0)


# ---------------------------------------------------------------- models ----
class PaperModel(NamedTuple):
    name: str
    init: Callable[[torch.Generator], PyTree]
    apply: Callable[..., torch.Tensor]     # (params, lora, x, train, rng)
    lora_specs: dict[str, tuple[int, int]]


def mlp(input_dim: int = 784, hidden: int = 200,
        n_classes: int = 10) -> PaperModel:
    specs = {"fc1": (hidden, input_dim), "fc2": (hidden, hidden),
             "out": (n_classes, hidden)}

    def init(gen):
        return {"fc1": dense_init(gen, hidden, input_dim),
                "fc2": dense_init(gen, hidden, hidden),
                "out": dense_init(gen, n_classes, hidden)}

    def apply(params, lora, x, train: bool = False, rng=None):
        del train, rng
        full_fp32()
        lora = lora or {}
        h = x.reshape(x.shape[0], -1)
        h = F.relu(dense_apply(params["fc1"], h, lora.get("fc1")))
        h = F.relu(dense_apply(params["fc2"], h, lora.get("fc2")))
        return dense_apply(params["out"], h, lora.get("out"))

    return PaperModel("mlp", init, apply, specs)


def cnn_mnist(n_classes: int = 10) -> PaperModel:
    fc_in = 7 * 7 * 64
    specs = {"fc1": (512, fc_in), "out": (n_classes, 512)}

    def init(gen):
        return {"conv1": conv_init(gen, 32, 1),
                "conv2": conv_init(gen, 64, 32),
                "fc1": dense_init(gen, 512, fc_in),
                "out": dense_init(gen, n_classes, 512)}

    def apply(params, lora, x, train: bool = False, rng=None):
        del train, rng
        full_fp32()
        lora = lora or {}
        h = maxpool2(F.relu(conv_apply(params["conv1"], x)))
        h = maxpool2(F.relu(conv_apply(params["conv2"], h)))
        h = h.reshape(h.shape[0], -1)
        h = F.relu(dense_apply(params["fc1"], h, lora.get("fc1")))
        return dense_apply(params["out"], h, lora.get("out"))

    return PaperModel("cnn_mnist", init, apply, specs)


def cnn_cifar(n_classes: int = 10, n_dense: int = 2, in_hw: int = 32,
              in_c: int = 3, drop: float = 0.25) -> PaperModel:
    fc_in = (in_hw // 4) * (in_hw // 4) * 64
    dims = [fc_in] + [512] * n_dense
    specs = {f"fc{i + 1}": (512, dims[i]) for i in range(n_dense)}
    specs["out"] = (n_classes, 512)

    def init(gen):
        def ones(c):
            return torch.ones(c, device=gen.device)

        def zeros(c):
            return torch.zeros(c, device=gen.device)
        params = {
            "conv1a": conv_init(gen, 32, in_c),
            "conv1b": conv_init(gen, 32, 32),
            "norm1": {"scale": ones(32), "bias": zeros(32)},
            "conv2a": conv_init(gen, 64, 32),
            "conv2b": conv_init(gen, 64, 64),
            "norm2": {"scale": ones(64), "bias": zeros(64)},
        }
        for i in range(n_dense):
            params[f"fc{i + 1}"] = dense_init(gen, 512, dims[i])
        params["out"] = dense_init(gen, n_classes, 512)
        return params

    def apply(params, lora, x, train: bool = False, rng=None):
        """``rng``: the torch.Generator dropout draws from when training
        (a fresh CPU one seeded 0 if None)."""
        full_fp32()
        lora = lora or {}
        if train and rng is None:
            rng = torch.Generator().manual_seed(0)
        h = F.relu(conv_apply(params["conv1a"], x))
        h = F.relu(conv_apply(params["conv1b"], h))
        h = batch_stat_norm(h, params["norm1"]["scale"],
                            params["norm1"]["bias"])
        h = dropout(rng, maxpool2(h), drop, train)
        h = F.relu(conv_apply(params["conv2a"], h))
        h = F.relu(conv_apply(params["conv2b"], h))
        h = batch_stat_norm(h, params["norm2"]["scale"],
                            params["norm2"]["bias"])
        h = dropout(rng, maxpool2(h), drop, train)
        h = h.reshape(h.shape[0], -1)
        for i in range(n_dense):
            h = F.relu(dense_apply(params[f"fc{i + 1}"], h,
                                   lora.get(f"fc{i + 1}")))
            h = dropout(rng, h, drop, train)
        return dense_apply(params["out"], h, lora.get("out"))

    return PaperModel("cnn_cifar", init, apply, specs)


PAPER_MODELS = {
    "mlp": mlp,
    "cnn_mnist": cnn_mnist,
    "cnn_cifar": cnn_cifar,
}
