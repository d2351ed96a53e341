"""Each count in ``gpubench/counts`` against a case worked by hand."""
from __future__ import annotations

from gpubench.counts import (lm_prefill, lm_train, mamba_prefill, mamba_train, packed_agg,
                             ssd_scan)


def test_packed_agg_bytes_by_hand():
    # a pair A (2, 4, 10), B (2, 6, 4): a rank row is 2 * (10 + 6) fp32
    # = 128 B; uploads at ranks 1 and 2 read 3 rows, rows 2 and 3 come from
    # the previous global, 4 rows are written
    assert packed_agg.pair_bytes((2, 4, 10), (2, 6, 4), [1, 2], 4) == 1152
    assert packed_agg.round_bytes([((2, 4, 10), (2, 6, 4))] * 2, [1, 2],
                                  4) == 2 * 1152 + 8
    # a cohort that owns every row reads nothing of the previous global
    assert packed_agg.pair_bytes((1, 2, 1), (1, 1, 2), [2, 2], 2) \
        == 2 * 4 * (4 + 2)


def test_ssd_scan_by_hand():
    # B=1, L=4, H=1, P=1, N=1, Q=2: two chunks of 3 causal pairs
    # C B^T: 2 chunks * 2 * 3 * 1 = 12; per head and chunk: masked product
    # 2 * 3 * 1 = 6, state 2 * 2 = 4, inter-chunk 4, carry 2 -> 16 * 2 = 32
    assert ssd_scan.flops(1, 4, 1, 1, 1, 2) == 44
    # bf16 xdt 4, B and C 4 each, fp32 dtA 4; y 4 and h_final 1 in bf16
    assert ssd_scan.bytes_moved(1, 4, 1, 1, 1, 2) == 24 + 16 + 10


def test_lm_train_by_hand():
    cfg = {"d_model": 2, "n_heads": 1, "n_kv_heads": 1, "head_dim": 2,
           "d_ff": 2, "vocab_size": 3, "n_layers": 1, "window": 0}
    f = lm_train.forward(cfg, 1, 2, 1)
    # seven 2x2 projections over 2 tokens, and the 2x3 head
    assert f["dense"] == 7 * 2 * 2 * 4 + 2 * 2 * 2 * 3
    # 3 causal pairs, two products of width 2
    assert f["attention"] == 2 * 2 * 3 * 2
    assert f["lora"] == 7 * 2 * 2 * 1 * 4
    assert lm_train.step_flops(cfg, 1, 2, 1) == 2 * 136 + 3 * 24 + 3 * 112
    # 5 positions, window 2: 1 + 2 + 2 + 2 + 2
    assert lm_train.attended(5, 2) == 9
    assert lm_train.attended(5, 8) == 15


def test_lm_prefill_by_hand():
    cfg = {"d_model": 2, "n_heads": 1, "n_kv_heads": 1, "head_dim": 2,
           "d_ff": 2, "vocab_size": 3, "n_layers": 1, "window": 0}
    # the seven projections and their LoRA terms over 2 tokens, attention
    # on 3 causal pairs, the 2x3 head at the last position alone
    assert lm_prefill.prefill_flops(cfg, 1, 2, 1) == 112 + 112 + 24 + 12


def test_mamba_prefill_by_hand():
    cfg = {"d_model": 2, "ssm_expand": 1, "ssm_head_dim": 2, "ssm_state": 1,
           "ssm_conv": 2, "ssm_chunk": 2, "vocab_size": 3, "n_layers": 1}
    # in_proj 2 -> 7 (z, x, B, C, dt), out_proj 2 -> 2, rank-1 adapters on
    # both, a width-2 conv over 4 channels, over 2 tokens: 56 + 16 + 36 +
    # 16 + 32; the scan (B=1, L=2, H=1, P=2, N=1, Q=2) 6 + 32; the head at
    # the last position 2 * 2 * 3
    assert mamba_prefill.scan_flops(cfg, 1, 2) == 38
    assert mamba_prefill.prefill_flops(cfg, 1, 2, 1) == 156 + 38 + 12


def test_mamba_train_by_hand():
    cfg = {"d_model": 2, "ssm_expand": 1, "ssm_head_dim": 2, "ssm_state": 1,
           "ssm_conv": 2, "ssm_chunk": 2, "vocab_size": 3, "n_layers": 1}
    # frozen: projections 56 + 16, conv 32, the head over both tokens
    # 2 * 2 * 2 * 3 = 24, twice; the scan 38 and the adapters 36 + 16
    # three times
    assert mamba_train.step_flops(cfg, 1, 2, 1) == \
        2 * (56 + 16 + 32 + 24) + 3 * 38 + 3 * 52
