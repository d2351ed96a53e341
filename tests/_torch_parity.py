"""Shared helpers for the port's parity tests (``test_torch_*.py``): one
place converts between JAX, numpy and torch and states the tolerance rule
of ``tests/test_kernels.py`` (rtol = tol, atol = tol * max(1, max|want|);
tol 2e-5 in fp32, 2e-2 in bf16)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax_adapters, from_jax_params, to_numpy

F32_TOL = 2e-5
BF16_TOL = 2e-2


def np32(x) -> np.ndarray:
    """Any array-like (torch, jax, numpy, incl. bf16) as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_close(got, want, tol=F32_TOL, msg=""):
    g, w = np32(got), np32(want)
    assert g.shape == w.shape, f"{msg}: shape {g.shape} != {w.shape}"
    assert np.isfinite(w).all(), f"{msg}: reference is not finite"
    scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale, err_msg=msg,
                               equal_nan=False)


def assert_trees_close(got, want, tol=F32_TOL, msg=""):
    """``got``: a port tree; ``want``: a JAX tree with the same keys."""
    if isinstance(want, dict):
        assert set(got) == set(want), f"{msg}: keys {set(got)} != {set(want)}"
        for k in want:
            assert_trees_close(got[k], want[k], tol, f"{msg}/{k}")
        return
    assert_close(got, want, tol, msg)


def jax_tree_to_numpy(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def port_tree(jax_tree, device="cpu"):
    """A JAX params/adapters tree as port tensors, through the bridge."""
    return from_jax_params(jax_tree_to_numpy(jax_tree), device)


def _reference_rig(cfg, r_storage=None):
    """The JAX run's initial model and client partition, made as
    ``repro.fl.simulator._build_sim`` makes them: ``key, pkey, akey =
    jax.random.split(PRNGKey(seed), 3)`` for ``model.init`` /
    ``init_adapters`` (adapters at ``r_storage``, default ``cfg.r_max``).
    Returns ``(params, adapters, draw)``; ``draw(ci)``
    takes the next ``fit_key = PRNGKey(int(rng.integers(0, 2**31)))``
    from ``np.random.default_rng(seed)`` and returns client ``ci``'s batch
    indices, ``idx_key, _ = jax.random.split(fit_key)`` then
    ``sample_batch_indices``, as ``repro.fl.client`` draws them."""
    import jax
    import jax.numpy as jnp
    from repro.data import make_dataset, staircase_partition
    from repro.data.pipeline import sample_batch_indices
    from repro.lora import init_adapters
    from repro.models.paper_nets import PAPER_MODELS
    model = PAPER_MODELS[cfg.model]()
    _, pkey, akey = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    params = model.init(pkey)
    adapters = init_adapters(akey, model.lora_specs, r_storage or cfg.r_max,
                             cfg.r_max)
    train = make_dataset(cfg.dataset, cfg.n_per_class, cfg.seed, "train")
    clients = staircase_partition(train, cfg.n_clients, cfg.r_max,
                                  cfg.ratio_step, cfg.seed)
    max_n = max(len(c.x) for c in clients)
    steps = max(1, (max_n * cfg.local_epochs) // cfg.batch_size)
    rng = np.random.default_rng(cfg.seed)

    def draw(ci):
        fit_key = jax.random.PRNGKey(int(rng.integers(0, 2 ** 31)))
        idx_key, _ = jax.random.split(fit_key)
        return np.array(sample_batch_indices(
            idx_key, jnp.asarray(clients[ci].n, jnp.int32), cfg.batch_size,
            steps))
    return params, adapters, draw


def sim_reference_inputs(cfg, r_storage=None):
    """The JAX synchronous run's initial model and every client's batch
    indices, keyed ``(round, client)`` (see :func:`_reference_rig`)."""
    from repro.fl.selection import select_clients
    params, adapters, draw = _reference_rig(cfg, r_storage)
    idx = {}
    for rnd in range(cfg.rounds):
        for ci in select_clients(cfg.n_clients, rnd, cfg.participation,
                                 cfg.seed):
            idx[rnd, ci] = draw(ci)
    return params, adapters, idx


def async_reference_inputs(cfg, r_storage=None):
    """The JAX event-driven run's initial model and the batch indices of
    every arrival, keyed ``(k, client)`` for the ``k``-th arrival.  The
    arrival order depends only on the latencies, so the heap of
    ``repro.fl.run_async_simulation`` is replayed here: every client
    dispatched at time 0 in client order, then each popped client
    re-dispatched at its arrival time, ties broken by dispatch order; one
    ``fit_key`` is drawn per arrival, in pop order."""
    import heapq

    from repro.fl.selection import ClientLatencyModel
    params, adapters, draw = _reference_rig(cfg, r_storage)
    latency = ClientLatencyModel(
        cfg.n_clients, median_s=cfg.latency_median_s,
        sigma=cfg.latency_sigma, straggler_sigma=cfg.straggler_sigma,
        seed=cfg.seed)
    heap = [(latency.sample(ci), ci, ci) for ci in range(cfg.n_clients)]
    heapq.heapify(heap)
    seq = cfg.n_clients
    idx = {}
    for k in range(cfg.total_updates or cfg.rounds * cfg.n_clients):
        now, _, ci = heapq.heappop(heap)
        idx[k, ci] = draw(ci)
        heapq.heappush(heap, (now + latency.sample(ci), seq, ci))
        seq += 1
    return params, adapters, idx


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):      # a copy: a CPU tensor's numpy
        return tree.detach().cpu().numpy().copy()   # view would follow it
    return np.asarray(tree)


def spy_states(monkeypatch, cls):
    """Record, as numpy trees, the adapters and base trainables of every
    server state ``cls.aggregate`` returns (patched on the class, so the
    configured copies of ``with_options`` are seen too; copied at once,
    because both loops donate each round's buffers to the next)."""
    seen = []
    orig = cls.aggregate

    def spy(self, *a, **k):
        state = orig(self, *a, **k)
        seen.append(SimpleNamespace(
            adapters=_np_tree(state.adapters),
            base_trainable=_np_tree(state.base_trainable)))
        return state
    monkeypatch.setattr(cls, "aggregate", spy)
    return seen


def need_cuda():
    """Skip (inside a test, never at import) when there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


_GROUP_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}


def group_cohort(seed, n=5, dtype="f32", fans=(10, 24), r=8, lead=(),
                 with_prev=True, use_mask=True, per_client=False):
    """The segments of one grouped round, made with numpy from ``seed``:
    for each fan an A leaf ``(n, *lead, r, fan)`` (row mode) and a B leaf
    ``(n, *lead, fan, r)`` (column mode), stacked over the n clients or
    (``per_client``) as n per-client tensors.  Ranks per (client, lead
    index) in [0, r - 2], client 0 at rank 0, so the last two rank rows have
    no owner; ``use_mask=False`` owns every row.  ``dtype`` "int8" carries
    per-(client, rank row) scales; "mixed" (per-client only) cycles fp32,
    bf16 and int8 clients.  Outputs are bf16 for a bf16 cohort, else fp32.
    Returns the keyword arguments of ``packed_agg_group`` (CPU tensors)."""
    rng = np.random.default_rng(seed)
    kinds = ([("f32", "bf16", "int8")[i % 3] for i in range(n)]
             if dtype == "mixed" else [dtype] * n)
    ranks = rng.integers(0, r - 1, (n,) + tuple(lead))
    ranks[0] = 0
    own = np.arange(r) < ranks[..., None]                 # (n, *lead, r)
    if not use_mask:
        own[:] = True
    out_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    xs, prevs, cols, scales, offs, masks = [], [], [], [], [], []
    off = 0
    for fan in fans:
        for col in (False, True):
            shape = tuple(lead) + ((fan, r) if col else (r, fan))
            clients, scs = [], []
            for kind in kinds:
                v = rng.normal(size=shape).astype(np.float32)
                sc = None
                if kind == "int8":
                    v = rng.integers(-127, 128, shape).astype(np.int8)
                    sc = torch.as_tensor(rng.uniform(
                        0.001, 0.02, tuple(lead) + (r,)).astype(np.float32))
                clients.append(torch.as_tensor(v).to(_GROUP_DTYPES[kind]))
                scs.append(sc)
            if per_client:
                xs.append(clients)
                scales.append(scs if any(s is not None for s in scs)
                              else None)
            else:
                xs.append(torch.stack(clients))
                scales.append(torch.stack(scs) if scs[0] is not None
                              else None)
            prevs.append(torch.as_tensor(rng.normal(size=shape).astype(
                np.float32)).to(out_dtype) if with_prev else None)
            cols.append(col)
            offs.append(off)
            masks.append(own.reshape(n, -1).astype(np.float32))
            off += masks[-1].shape[1]
    weights = torch.as_tensor(rng.uniform(0.5, 2.0, n).astype(np.float32))
    return dict(xs=xs, masks=torch.as_tensor(np.concatenate(masks, 1)),
                weights=weights, prevs=prevs, cols=cols, scales=scales,
                mask_offs=offs, out_dtypes=[out_dtype] * len(xs))


def group_to_buckets(kw):
    """The cohort of :func:`group_cohort` packed as the JAX plans pack it:
    every segment's rank rows (B transposed), buckets by row width.
    Returns ``[(x, masks, prev, scales, [(segment, first_row, rows)])]``
    with x ``(n, rows, width)``: a stacked cohort in its dtype with its
    scales, per-client leaves dequantised to fp32 (``s * x`` in fp32, as
    the kernel dequantises on the load)."""
    from repro_torch.kernels.rbla_agg.ref import leaf_rank_rows
    buckets = {}
    for i, (x, prev, col, sc, off) in enumerate(zip(
            kw["xs"], kw["prevs"], kw["cols"], kw["scales"],
            kw["mask_offs"])):
        if isinstance(x, torch.Tensor):
            xr = leaf_rank_rows(x, col)
            sr = None if sc is None else sc.reshape(xr.shape[0], -1)
        else:           # per-client leaves: dequantised fp32 rows
            clients = []
            for t, s in zip(x, sc or [None] * len(x)):
                tr = leaf_rank_rows(t[None].float(), col)[0]
                if s is not None:
                    tr = s.reshape(-1)[:, None] * tr
                clients.append(tr)
            xr, sr = torch.stack(clients), None
        rows = xr.shape[1]
        m = kw["masks"][:, off:off + rows]
        pr = None if prev is None else leaf_rank_rows(prev[None], col)[0]
        b = buckets.setdefault(xr.shape[-1], ([], [], [], [], []))
        start = sum(p.shape[1] for p in b[0])
        for lst, v in zip(b, (xr.contiguous(), m, pr, sr,
                              (i, start, rows))):
            lst.append(v)
    out = []
    for xs, ms, ps, ss, where in buckets.values():
        out.append((torch.cat(xs, 1), torch.cat(ms, 1),
                    None if ps[0] is None else torch.cat(ps, 0),
                    None if ss[0] is None else torch.cat(ss, 1), where))
    return out


__all__ = ["F32_TOL", "BF16_TOL", "np32", "assert_close",
           "assert_trees_close", "jax_tree_to_numpy", "port_tree",
           "sim_reference_inputs", "async_reference_inputs", "spy_states",
           "need_cuda", "from_jax_adapters", "from_jax_params", "to_numpy",
           "group_cohort", "group_to_buckets"]
