"""The frozen roofline counts against the numbers ``PERF.md`` keeps."""

from __future__ import annotations

from portbench import roofline


def test_fused_update_bytes():
    # 36,430 touched rows of the largest Criteo table, at D 10 and D 1
    assert roofline.fused_update(10131227, 36430, 10)[0] == 858_309_068
    assert roofline.fused_update(10131227, 36430, 1)[0] == 122_303_324


def test_embedding_backward_counts_no_dense_table():
    small = roofline.embedding_backward(131072 * 26, (10, 1), 500_000)
    # the same keys and touched rows into tables of any size: no V * D * 4
    assert small == roofline.embedding_backward(131072 * 26, (10, 1),
                                                500_000)
    keys = 131072 * 26
    assert small[0] == 4 * keys + 4 * keys * 11 + 4 * 500_000 * 11


def test_wkv6_counts_leave_out_chunk_states():
    fwd = roofline.wkv6_forward(512, 512, 64)[0]
    bwd = roofline.wkv6_backward(512, 512, 64)[0]
    assert fwd == 4 * (5 * 512 * 512 * 64 + 512 * 64 + 512 * 64 * 64)
    assert bwd == 4 * (9 * 512 * 512 * 64 + 2 * 512 * 64 + 512 * 64 * 64)


def test_bound_takes_the_larger():
    t, by = roofline.bound_s(3.35e12, 1.0)
    assert by == "bytes" and abs(t - 1.0) < 1e-12
    t, by = roofline.bound_s(1.0, 67e12)
    assert by == "operations" and abs(t - 1.0) < 1e-12


def test_deepfm_row_flops():
    # the deep tower 273-400-400-400-1 and the FM term, three passes
    assert roofline.ctr_model_flops(26, 10, 13, (400, 400, 400)) == 3 * (
        2 * (273 * 400 + 400 * 400 + 400 * 400 + 400) + 4 * 260)


def test_rwkv6_params_match_the_port_count():
    import json

    from portbench.tests.tiny import ROOT

    cfg = json.loads((ROOT / "configs" / "rwkv6-7b-8l.json").read_text())
    # lm.param_counts of rwkv6-7b at 8 layers, less the [65536, 4096] table
    assert roofline.rwkv6_nonembedding_params(cfg) == (
        2_286_292_992 - 65536 * 4096)
