"""JAX's expert-parallel MoE (``repro.models.moe_ep.moe_forward_ep_wrapped``)
on a (data, model) mesh of host devices, for ``tests/test_torch_ep_mesh.py``.

    python tests/_ep_mesh_jax.py INPUTS OUT

Forces as many host devices as the largest case's mesh holds (so it runs in
a process of its own), and writes, for every case of the pickled ``INPUTS``,
the output, the loss <y, cotangent> and its gradient w.r.t. every LoRA
factor to the pickle ``OUT``.
"""
import os
import pickle
import sys
from pathlib import Path

import numpy as np

with open(sys.argv[1], "rb") as f:
    CASES = pickle.load(f)
N_DEV = max(int(np.prod(c["mesh"])) for c in CASES)
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N_DEV}"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models.moe_ep import moe_forward_ep_wrapped  # noqa: E402


def run(case):
    cfg = get_config(case["arch"]).reduced(**case["overrides"])
    n = int(np.prod(case["mesh"]))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(case["mesh"]),
                ("data", "model"))
    p = jax.tree.map(jnp.asarray, case["params"])
    lora = jax.tree.map(jnp.asarray, case["lora"])
    x, ct = jnp.asarray(case["x"]), jnp.asarray(case["cotangent"])
    factors = {k: {f: v[f] for f in ("A", "B")} for k, v in lora.items()}

    def loss_fn(fa):
        lo = {k: dict(lora[k], **fa[k]) for k in lora}
        y = moe_forward_ep_wrapped(p, lo, x, cfg)
        return jnp.sum(y * ct), y
    with jax.set_mesh(mesh):
        (loss, y), grad = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(factors)
    return {"y": np.asarray(y), "loss": np.asarray(loss),
            "grad": jax.tree.map(np.asarray, grad)}


if __name__ == "__main__":
    out = {c["name"]: run(c) for c in CASES}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
