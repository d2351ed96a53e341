"""Inputs and weights made from the run's seed, on the device, in a few
large calls.

A tree of tensors is filled from one ``torch.Generator`` on the device:
every leaf drawn from a normal distribution comes out of one ``randn``
call per dtype, carved into views and scaled leaf by leaf; the few
leaves a rule sets to a constant or a range are written directly.  The
same seed gives the same tensors.  Tokens follow the bigram process of
the fine-tuning examples (a fixed random permutation followed with
probability ``p_follow``, else a uniform draw), run on the device.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by ``seed`` (any whole number that
    fits 64 bits; larger ones are folded)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def sub_seed(seed: int, *parts: int) -> int:
    """A second seed drawn from ``seed`` and ``parts`` (a client, a round),
    so that each stream is reproducible on its own."""
    h = int(seed) % (2 ** 61 - 1)
    for p in parts:
        h = (h * 1_000_003 + int(p) + 0x9E3779B1) % (2 ** 61 - 1)
    return h


def walk(tree, path=()):
    """(path, leaf) over a tree of dicts, tuples and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (i,))
    else:
        yield path, tree


def rebuild(tree, fn: Callable, path=()):
    """The tree with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def fill(structure, gen: torch.Generator, rule: Callable, device) -> dict:
    """Real tensors shaped as ``structure``'s leaves (tensors on the meta
    device, or anything with ``shape`` and ``dtype``).

    ``rule(path, shape, dtype)`` returns ``("normal", std)`` for a draw,
    ``("const", value)``, ``("uniform", lo, hi)`` or ``("loguniform", lo,
    hi)``.  Normal leaves of one dtype share one ``randn`` call; the
    others get one call each, in the tree's order."""
    leaves = list(walk(structure))
    plans = {path: rule(path, tuple(leaf.shape), leaf.dtype)
             for path, leaf in leaves}
    by_dtype: dict = {}
    for path, leaf in leaves:
        if plans[path][0] == "normal":
            by_dtype.setdefault(leaf.dtype, []).append((path, leaf))
    views = {}
    for dtype, group in by_dtype.items():
        total = sum(math.prod(leaf.shape) for _, leaf in group)
        flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
        at = 0
        for path, leaf in group:
            n = math.prod(leaf.shape)
            v = flat[at:at + n].view(tuple(leaf.shape))
            v.mul_(plans[path][1])
            views[path] = v
            at += n

    def make(path, leaf):
        if path in views:
            return views[path]
        plan = plans[path]
        shape = tuple(leaf.shape)
        if plan[0] == "const":
            return torch.full(shape, plan[1], dtype=leaf.dtype, device=device)
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        lo, hi = plan[1], plan[2]
        if plan[0] == "uniform":
            return (lo + (hi - lo) * u).to(leaf.dtype)
        if plan[0] == "loguniform":
            return torch.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                             * u).to(leaf.dtype)
        raise ValueError(f"unknown fill rule {plan[0]!r} at {path}")
    return rebuild(structure, make)


def model_weights_rule(path, shape, dtype):
    """The benchmark's weights: a dense kernel ``w`` (..., fan_in, fan_out)
    N(0, 1/fan_in); the embedding N(0, 0.02^2); norm scales 1; biases 0;
    a Mamba2 mixer's ``A_log`` log U(1, 16), ``dt_bias`` the inverse
    softplus of a dt drawn log-uniform in [1e-3, 1e-1] (the published
    initialisation), ``D`` 1 and its causal conv N(0, 1/width)."""
    name = path[-1]
    if name == "w":
        return ("normal", shape[-2] ** -0.5)
    if name == "table":
        return ("normal", 0.02)
    if name in ("scale", "D"):
        return ("const", 1.0)
    if name in ("b", "bias", "conv_b"):
        return ("const", 0.0)
    if name == "conv_w":
        return ("normal", shape[-2] ** -0.5)
    if name == "A_log":
        return ("uniform", 0.0, math.log(16.0))
    if name == "dt_bias":
        # softplus^-1(dt) = dt + log(-expm1(-dt)); drawn as dt below
        return ("dt_inverse_softplus", 1e-3, 1e-1)
    raise ValueError(f"no weight rule for leaf {path}")


def model_weights(structure, gen, device, extra_rules=None):
    """:func:`fill` under :func:`model_weights_rule`; ``dt_bias`` leaves
    become the inverse softplus of their draws.  ``extra_rules`` (a
    configuration's ``weight_rules``) maps a leaf's name to a rule of its
    own, taken first: ``["normal", std]``, ``["normal_fan_in"]`` (N(0,
    1/fan_in)), ``["const", v]``, ``["uniform", lo, hi]`` or
    ``["loguniform", lo, hi]``."""
    extra = extra_rules or {}

    def rule(path, shape, dtype):
        if path[-1] in extra:
            plan = tuple(extra[path[-1]])
            return ("normal", shape[-2] ** -0.5) \
                if plan[0] == "normal_fan_in" else plan
        plan = model_weights_rule(path, shape, dtype)
        return ("loguniform",) + plan[1:] if plan[0] == \
            "dt_inverse_softplus" else plan
    tree = fill(structure, gen, rule, device)

    def fix(path, t):
        if path[-1] == "dt_bias":
            return t + torch.log(-torch.expm1(-t))
        return t
    return rebuild(tree, fix)


def lora_rule(a_std: float, b_std: float):
    """Adapter factors: ``A`` (..., r, fan_in) N(0, a_std^2 / fan_in),
    ``B`` N(0, b_std^2); the rank leaves are set by :func:`set_rank`."""
    def rule(path, shape, dtype):
        if path[-1] == "A":
            return ("normal", a_std * shape[-1] ** -0.5)
        if path[-1] == "B":
            return ("normal", b_std)
        if path[-1] == "rank":
            return ("const", 0)
        raise ValueError(f"no adapter rule for leaf {path}")
    return rule


def set_rank(tree, rank: int):
    """Every pair of ``tree`` at live rank ``rank``: rows of ``A`` and
    columns of ``B`` at or past it zeroed in place, the rank leaves
    filled."""
    for path, leaf in walk(tree):
        if path[-1] == "A":
            leaf[..., rank:, :] = 0
        elif path[-1] == "B":
            leaf[..., rank:] = 0
        elif path[-1] == "rank":
            leaf.fill_(rank)
    return tree


def bigram_tokens(gen: torch.Generator, vocab: int, rows: int, length: int,
                  p_follow: float, device) -> torch.Tensor:
    """(rows, length) int64 tokens of the bigram process: the first token
    uniform, then each the successor of the one before under a fixed
    random permutation with probability ``p_follow``, else uniform."""
    table = torch.randperm(vocab, generator=gen, device=device)
    fresh = torch.randint(0, vocab, (rows, length), generator=gen,
                          device=device)
    follow = torch.rand((rows, length), generator=gen,
                        device=device) < p_follow
    toks = torch.empty((rows, length), dtype=torch.int64, device=device)
    toks[:, 0] = fresh[:, 0]
    for t in range(1, length):
        toks[:, t] = torch.where(follow[:, t], table[toks[:, t - 1]],
                                 fresh[:, t])
    return toks
