"""Backend policy and launch counters shared by the port's kernel wrappers.

* :func:`resolve_backend` -- ``"auto"`` is ``"kernel"`` for tensors on a
  CUDA device and ``"ref"`` for tensors on the CPU; nothing else is
  consulted.  ``"pallas"`` (the JAX package's name) is an alias of
  ``"kernel"``.  ``"distributed"`` names the strategies' collective paths
  (``repro_torch.core.distributed``); no kernel wrapper takes it.
* :data:`LAUNCHES` -- one plain count per kernel, raised by its wrapper
  right after a launch succeeded and nowhere else; :data:`PLAIN_CALLS`
  counts calls of each kernel's plain PyTorch version;
  :data:`COLLECTIVES` counts ``torch.distributed`` collectives by name.
* :func:`check_launch`, :func:`stream_handle` -- what every wrapper does
  around a ctypes launch;
* :func:`bench_env` -- the header every measurement prints.
"""
from __future__ import annotations

import subprocess

import torch

BACKENDS = ("auto", "ref", "kernel", "distributed")
_ALIASES = {"pallas": "kernel"}
KERNELS = ("packed_agg", "rbla_agg", "packed_robust", "packed_stack",
           "flora_stack", "axpy_fold", "batched_lora_matmul", "lora_matmul",
           "ssd_scan")

#: kernel launches per kernel since the last :func:`reset_counts`
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
#: plain-version calls per kernel since the last :func:`reset_counts`
PLAIN_CALLS: dict[str, int] = dict.fromkeys(KERNELS, 0)
#: collectives the distributed paths called since the last
#: :func:`reset_counts`, raised right after each call returned
COLLECTIVES: dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                               "all_to_all": 0}


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def resolve_backend(backend: str, device) -> str:
    """``"auto" | "ref" | "kernel" | "distributed"`` (or alias) -> ``"ref" |
    "kernel" | "distributed"``."""
    backend = _ALIASES.get(backend, backend)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: "
                         f"{BACKENDS + tuple(_ALIASES)}")
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "ref"
    return backend


def use_kernel(backend: str, x: torch.Tensor, name: str) -> bool:
    """A wrapper's choice for tensor ``x``: launch the kernel (True) or run
    the plain version (False, only ever for a CPU tensor).  A CUDA tensor
    always launches; asking for the kernel on a CPU tensor raises, and so
    does ``"distributed"``, which names a strategy path, not a kernel's."""
    kind = resolve_backend(backend, x.device)
    if kind == "distributed":
        raise ValueError(f"{name}: backend='distributed' is a strategy path; "
                         "a kernel wrapper takes 'auto', 'ref' or 'kernel'")
    if x.is_cuda:
        if kind != "kernel":
            raise ValueError(f"{name}: a CUDA tensor always takes the kernel; "
                             f"backend={backend!r} asks for the plain version "
                             f"(call {name}_ref directly)")
        return True
    if kind == "kernel":
        raise ValueError(f"{name}: backend={backend!r} needs CUDA tensors; "
                         f"got a tensor on {x.device}")
    return False


def check_launch(err: int, name: str, lib) -> None:
    """Raise with the CUDA error text if a launch through ``lib`` returned
    an error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error "
                           f"{err})")


def stream_handle(dev) -> int:
    """The raw handle of PyTorch's current stream on ``dev`` (a device or
    a CUDA device index): kernels launch there.  Read as the raw handle
    itself, without the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream`` builds on every call."""
    index = dev if isinstance(dev, int) else torch.device(dev).index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run the plain path")
    return device


def full_fp32() -> None:
    """fp32 matmuls and convolutions in full fp32 on the card: cuDNN's
    convolutions default to TF32 (about three decimal digits), which would
    put the port's models outside the reference's tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _nvidia_smi() -> str | None:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip()


def bench_env() -> dict:
    """torch and CUDA versions, and the card's name and power limit as
    ``nvidia-smi`` reports them (None where there is no card)."""
    cuda = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_kind": torch.cuda.get_device_name(0) if cuda else None,
        "n_devices": torch.cuda.device_count() if cuda else 0,
        "nvidia_smi": _nvidia_smi() if cuda else None,
    }
