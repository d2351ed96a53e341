"""Operations and bytes of one chunked SSD scan (Mamba-2's state-space
dual form) over xdt (B, L, H, P), dtA (B, L, H) in fp32, B/C (B, L, N),
state N, chunk Q (dividing L), one multiply-add counted as two.

Operations: per (batch, chunk) ``C B^T`` on the causal triangle with its
diagonal (Q (Q + 1) / 2 pairs of N); per head the masked product with
the inputs on the same triangle (P each), the chunk's own state (Q N P)
and the inter-chunk term (Q N P); the carry across chunks (N P a head and
chunk).  Bytes: the inputs read once and the output and final state
written once, in the operands' item size."""
from __future__ import annotations


def flops(b: int, l: int, h: int, p: int, n: int, q: int) -> int:
    nc = l // q
    tri = q * (q + 1)
    return (b * nc * tri * n
            + b * h * nc * (tri * p + 2 * 2 * q * n * p + 2 * n * p))


def bytes_moved(b: int, l: int, h: int, p: int, n: int,
                itemsize: int = 2) -> int:
    inputs = (b * l * h * p + 2 * b * l * n) * itemsize + b * l * h * 4
    outputs = (b * l * h * p + b * h * p * n) * itemsize
    return inputs + outputs
