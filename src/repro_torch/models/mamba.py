"""Mamba2 (SSD, state-space duality) block on tensor dicts.

Shapes (n_groups fixed to 1), as in the JAX package:
  d_inner = expand * d_model;  H = d_inner // ssm_head_dim;  N = ssm_state
  in_proj : d_model -> 2*d_inner + 2*N + H      (z, x, B, C, dt)
  conv    : depthwise causal width-4 over [x, B, C]
  out_proj: d_inner -> d_model

``full`` and ``prefill`` run the chunked SSD through the ``ssd_scan``
wrapper (the hand-written kernel for a CUDA tensor, :func:`ssd_chunked`
on the CPU); ``scan_backend="ref"`` calls the plain version directly,
also on the card.  Under a mesh (DTensor activations) the scan runs
through ``local_map`` on each rank's heads: the heads sharded over
``"model"`` and the batch over the data axes where they divide, the
layout ``rules.cache_specs`` gives the ``ssm`` state (:func:`_mesh_scan`).  Decode carries (conv_state (B, conv_w-1, d_conv_ch),
ssm_state (B, H, P, N)) and is plain PyTorch, as in the reference.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ssd_scan import chunk_len, ssd_scan, ssd_scan_ref

from .common import dense, dense_init, dtype_of, norm_init, rmsnorm, settle


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    h = d_in // cfg.ssm_head_dim
    return d_in, h, cfg.ssm_state, cfg.ssm_head_dim


def mamba_init(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    d_in, h, n, _ = _dims(cfg)
    conv_ch = d_in + 2 * n
    dt = dtype_of(cfg)
    dev = gen.device
    return {
        "ln": norm_init(cfg, device=dev),
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * n + h, dt),
        "conv_w": torch.randn((cfg.ssm_conv, conv_ch), generator=gen,
                              dtype=dt, device=dev)
        * (1.0 / cfg.ssm_conv) ** 0.5,
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "gn": {"scale": torch.ones((d_in,), dtype=torch.float32, device=dev)},
        "out_proj": dense_init(gen, d_in, d, dt),
    }


MAMBA_LORA_TARGETS = ("in_proj", "out_proj")


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) lower-triangular segment sums (-inf above
    the diagonal)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, L, C); w: (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    # unfold: sum_j w[j] * x[t-k+1+j]
    out = sum(xp[:, j:j + x.shape[1], :] * w[j][None, None, :]
              for j in range(k))
    return out + b[None, None, :]


def ssd_chunked(xdt: torch.Tensor, dtA: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int,
                h_init: torch.Tensor | None = None):
    """Chunked SSD.  xdt: (B,L,H,P) (inputs pre-scaled by dt);
    dtA: (B,L,H); Bm/Cm: (B,L,N).  Returns (y (B,L,H,P), h_final
    (B,H,P,N))."""
    b, l, h, p = xdt.shape
    n = Bm.shape[-1]
    q = chunk_len(l, chunk)
    nc = l // q
    xc = xdt.reshape(b, nc, q, h, p)
    Bc = Bm.reshape(b, nc, q, n)
    Cc = Cm.reshape(b, nc, q, n)
    Ac = dtA.reshape(b, nc, q, h).movedim(-1, 1)           # (B,H,NC,Q)
    A_cs = torch.cumsum(Ac, -1)                            # (B,H,NC,Q)

    # 1) intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(Ac))                             # (B,H,NC,Q,Q)
    scores = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)       # (B,NC,Q,Q)
    y_diag = torch.einsum("bhcqs,bcshp->bcqhp",
                          scores[:, None] * L.to(scores.dtype), xc)

    # 2) per-chunk output states
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)        # (B,H,NC,Q)
    states = torch.einsum("bhcqn,bcqhp->bchpn",
                          Bc[:, None] * decay_states.to(Bc.dtype)[..., None],
                          xc)                              # (B,NC,H,P,N)

    # 3) inter-chunk recurrence (carry h across chunks)
    A_tot = A_cs[..., -1]                                  # (B,H,NC)
    hcur = (torch.zeros((b, h, p, n), dtype=xdt.dtype, device=xdt.device)
            if h_init is None else h_init)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hcur)
        hcur = hcur * torch.exp(A_tot[..., c])[..., None, None].to(
            hcur.dtype) + states[:, c]
    h_prevs = torch.stack(h_prevs, 1)                      # (B,NC,H,P,N)

    # 4) inter-chunk contribution to outputs
    state_decay = torch.exp(A_cs).to(Cc.dtype)             # (B,H,NC,Q)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prevs) \
        * state_decay.permute(0, 2, 3, 1)[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, hcur


def _ssd_core(zxbcdt: torch.Tensor, p: Mapping, cfg, scan, heads=None):
    """The mixer between its projections for full and prefill modes: from
    the fused projection ``zxbcdt`` (B, S, 2 d_in + 2N + H), the causal
    conv over [x, B, C], then ``scan`` over heads ``heads = (h0, h1)``
    (all by default) and the D skip.  Returns (y (B, S, h1 - h0, P),
    h_last (B, h1 - h0, P, N), the conv's last K - 1 inputs)."""
    d_in, h, n, pd = _dims(cfg)
    _, xin, Bm, Cm, dt = torch.split(zxbcdt, [d_in, d_in, n, n, h], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])             # (B,S,H)
    A = -torch.exp(p["A_log"])                             # (H,)
    conv_in = torch.cat([xin, Bm, Cm], -1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xc, Bc, Cc = torch.split(conv_out, [d_in, n, n], dim=-1)
    xh = xc.reshape(xc.shape[:2] + (h, pd))
    h0, h1 = heads or (0, h)
    xh, dt, A, D = xh[:, :, h0:h1], dt[..., h0:h1], A[h0:h1], p["D"][h0:h1]
    xdt = xh * dt[..., None].to(xh.dtype)
    dtA = dt * A[None, None, :]
    y, h_last = scan(xdt, dtA, Bc, Cc)
    y = y + D[None, None, :, None].to(y.dtype) * xh
    return y, h_last, conv_in[:, -(cfg.ssm_conv - 1):, :]


def _core_on_mesh(zxbcdt, p: Mapping, cfg, scan):
    """:func:`_ssd_core` through ``local_map`` for a DTensor ``zxbcdt``:
    each rank takes its batch rows (over the data axes, by
    ``rules.batch_axes``) of the whole projection, runs the conv whole and
    scans its own heads (over ``"model"`` where they divide it, the layout
    ``rules.cache_specs`` gives the ``ssm`` state).  A rank's gradient of
    the projection and of the conv and scan parameters is a partial sum
    over the ranks that split the heads or the batch."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding import P, rules
    _, h, _, _ = _dims(cfg)
    mesh = zxbcdt.device_mesh
    names = rules.axis_names(mesh)
    bax = rules.batch_axes(mesh, zxbcdt.shape[0])
    hax = rules.maybe(mesh, h, "model")
    hl, h0 = h, 0
    if hax:
        dim = names.index("model")
        hl = h // mesh.size(dim)
        h0 = mesh.get_local_rank(dim) * hl

    def pl(*spec):
        return rules.placements(P(*spec), mesh)
    split = {a for a in names if (a == "model" and hax) or a in (bax or ())}
    keys = ("conv_w", "conv_b", "dt_bias", "A_log", "D")
    leaves = [p[k] for k in keys]
    ins = (pl(bax, None, None),) + tuple(pl(*[None] * t.ndim)
                                         for t in leaves)
    grads = (tuple(Partial() if a == "model" and hax else q
                   for a, q in zip(names, ins[0])),) + tuple(
        tuple(Partial() if a in split else q for a, q in zip(names, pl_))
        for pl_ in ins[1:])

    def core(zx, *leaves):
        return _ssd_core(zx, dict(zip(keys, leaves)), cfg, scan,
                         (h0, h0 + hl))
    return local_map(
        core, out_placements=(pl(bax, None, hax, None),
                              pl(bax, hax, None, None), pl(bax, None, None)),
        in_placements=ins, in_grad_placements=grads, device_mesh=mesh,
        redistribute_inputs=True)(zxbcdt, *leaves)


def mamba_forward(p: Mapping, lora: Mapping | None, x: torch.Tensor, cfg, *,
                  mode: str, cache: Mapping | None = None, pos=None,
                  alpha: float = 16.0, scan_backend: str = "auto",
                  plain_scan=ssd_scan_ref):
    """Returns (y, new_cache or None).  x: (B, S, d).  ``scan_backend``:
    ``"auto"`` (the kernel for CUDA tensors, the plain version on the CPU),
    ``"kernel"`` or ``"ref"`` (``plain_scan`` wherever x lies: by default
    the plain version; an oracle with its arguments may stand in)."""
    lora = lora or {}
    d_in, h, n, pd = _dims(cfg)
    hx = rmsnorm(p["ln"], x, cfg.norm_eps)
    # on a mesh: the fused projection whole on every rank of "model" before
    # it splits into five uneven parts (the scan then takes its heads)
    zxbcdt = settle(dense(p["in_proj"], hx, lora.get("in_proj"), alpha))
    z, xin, Bm, Cm, dt = torch.split(zxbcdt, [d_in, d_in, n, n, h], dim=-1)

    if mode in ("full", "prefill"):
        if scan_backend == "ref":
            def scan(xdt, dtA, Bc, Cc):
                return plain_scan(xdt, dtA, Bc, Cc, cfg.ssm_chunk)
        else:
            def scan(xdt, dtA, Bc, Cc):
                return ssd_scan(xdt.contiguous(), dtA.contiguous(),
                                Bc.contiguous(), Cc.contiguous(),
                                cfg.ssm_chunk, backend=scan_backend)
        core = _core_on_mesh if isinstance(zxbcdt, DTensor) else _ssd_core
        y, h_last, tail = core(zxbcdt, p, cfg, scan)
        y = y.reshape(x.shape[:2] + (d_in,))
        y = rmsnorm(p["gn"], y * F.silu(z), cfg.norm_eps)
        out = dense(p["out_proj"], y, lora.get("out_proj"), alpha)
        return out, ({"conv": tail, "ssm": h_last} if mode == "prefill"
                     else None)
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}; options: full | prefill | "
                         "decode")

    # ------------------------------ decode ------------------------------
    # x: (B,1,d); cache: conv (B,K-1,C), ssm (B,H,P,N)
    dt = F.softplus(dt.float() + p["dt_bias"])             # (B,S,H)
    A = -torch.exp(p["A_log"])                             # (H,)
    conv_in = torch.cat([xin, Bm, Cm], -1)                 # (B,1,C)
    hist = torch.cat([cache["conv"], conv_in], 1)          # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :]                # (B,1,C)
    xc, Bc, Cc = torch.split(conv_out, [d_in, n, n], dim=-1)
    xh = xc.reshape(xc.shape[0], h, pd)                    # (B,H,P)
    dt1 = dt[:, 0]                                         # (B,H)
    dA = torch.exp(dt1 * A[None, :])                       # (B,H)
    Bv = Bc[:, 0]                                          # (B,N)
    Cv = Cc[:, 0]                                          # (B,N)
    dBx = torch.einsum("bhp,bn->bhpn", xh * dt1[..., None].to(xh.dtype), Bv)
    h_new = cache["ssm"] * dA[..., None, None].to(xh.dtype) + dBx
    y = torch.einsum("bhpn,bn->bhp", h_new, Cv)
    y = y + p["D"][None, :, None].to(y.dtype) * xh
    y = y.reshape(x.shape[0], 1, d_in)
    y = rmsnorm(p["gn"], y * F.silu(z), cfg.norm_eps)
    out = dense(p["out_proj"], y, lora.get("out_proj"), alpha)
    return out, {"conv": hist[:, 1:], "ssm": h_new}


def mamba_init_cache(cfg, batch: int, dtype, device=None) -> dict:
    d_in, h, n, pd = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * n),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, h, pd, n), dtype=dtype, device=device)}
