"""The yardstick's operation and byte counts against hand counts at the
cells' shapes."""

import pytest

from benchmark import harness, work

NQ = harness.load_json(harness.HERE / "configs" / "nq_ar2.json")
MS = harness.load_json(harness.HERE / "configs" / "msdoc_ar2.json")


def test_peaks_are_the_data_sheet():
    assert work.PEAK_BF16 == 989e12 and work.PEAK_INT8 == 1979e12
    assert work.PEAK_BYTES == 3.35e12


def test_bert_base_forward_by_hand():
    # 12 layers x (4 x 768^2 + 2 x 768 x 3072) weights x 2 x 128 tokens
    c = NQ["retriever"]
    per_layer = 4 * 768 * 768 + 2 * 768 * 3072
    assert work.dense_ops(c, 128) == 2 * 128 * per_layer * 12
    assert work.attention_ops(c, 1, 128) == 4 * 128 * 128 * 768 * 12


def test_nq_reranker_step_by_hand():
    # CE-large over 8 x 16 rows of 160 tokens, forward + backward (x3)
    t = 8 * 16 * 160
    dense = 2 * t * (4 * 1024 ** 2 + 2 * 1024 * 4096) * 24
    attn = 4 * 128 * 160 * 160 * 1024 * 24
    head = 2 * 128 * 1024
    w = work.cotrain_step_work(NQ, "reranker")
    assert w == {"bf16": 3.0 * (dense + attn + head), "int8": 0.0}
    assert w["bf16"] / work.PEAK_BF16 == pytest.approx(0.0385, rel=0.01)


def test_nq_retriever_step_by_hand():
    de_layer = 4 * 768 ** 2 + 2 * 768 * 3072
    q = 2 * 8 * 32 * de_layer * 12 + 4 * 8 * 32 * 32 * 768 * 12
    c = 2 * 128 * 128 * de_layer * 12 + 4 * 128 * 128 * 128 * 768 * 12
    teacher_int8 = 2 * 128 * 160 * (4 * 1024 ** 2 + 2 * 1024 * 4096) * 24
    teacher_bf16 = 4 * 128 * 160 * 160 * 1024 * 24 + 2 * 128 * 1024
    w = work.cotrain_step_work(NQ, "retriever")
    assert w["int8"] == teacher_int8
    assert w["bf16"] == 3.0 * (q + c) + teacher_bf16


def test_msdoc_retriever_step_counts_the_projection():
    w = work.cotrain_step_work(MS, "retriever")
    rows = 32 * 16
    de_layer = 4 * 768 ** 2 + 2 * 768 * 3072
    tower_c = 2 * rows * 512 * de_layer * 12 + 4 * rows * 512 * 512 * 768 * 12
    tower_q = 2 * 32 * 32 * de_layer * 12 + 4 * 32 * 32 * 32 * 768 * 12
    proj = 2 * (rows + 32) * 768 * 768
    teacher = 4 * rows * 512 * 512 * 768 * 12 + 2 * rows * 768
    assert w["bf16"] == pytest.approx(3.0 * (tower_c + tower_q + proj)
                                      + teacher)


def test_attention_launch_by_hand():
    # K5 over 128 rows x 160 tokens x 1024 wide: q, k, v, o bf16, mask i32
    f = work.attention_work(NQ["reranker"], 128, 160, False)
    assert f["ops"] == 4 * 128 * 160 * 160 * 1024
    assert f["bytes"] == 4 * 2 * 128 * 160 * 1024 + 4 * 128 * 160
    b = work.attention_work(NQ["reranker"], 128, 160, True)
    assert b["ops"] == 2 * f["ops"]
    assert b["bytes"] == 7 * 2 * 128 * 160 * 1024 + 4 * 128 * 160
    # at S=160, d=64 the launch is bound by its bytes
    assert work.least_seconds(f["ops"], f["bytes"], work.PEAK_BF16) == \
        f["bytes"] / work.PEAK_BYTES


def test_int8_linear_launch_by_hand():
    w = work.int8_linear_work(131072, 3072, 768, 4)
    assert w["ops"] == 2 * 131072 * 3072 * 768
    assert w["bytes"] == (131072 * 768 + 3072 * 768 + 4 * 131072
                          + 8 * 3072 + 4 * 131072 * 3072)
    enc = work.encoder_int8_linear_work(NQ["retriever"], 131072)
    assert enc["ops"] == 12 * 2 * 131072 * (3 * 768 * 768 + 768 * 768
                                            + 2 * 768 * 3072)


def test_encode_chunk_by_hand():
    w = work.encode_chunk_work(NQ, 1024, 128)
    assert w["int8"] == 2 * 1024 * 128 * (4 * 768 ** 2 + 2 * 768 * 3072) * 12
    assert w["bf16"] == 4 * 1024 * 128 * 128 * 768 * 12
