"""``models.bert.skip_init``: a model that draws its weights from a
generator builds on the meta device, so PyTorch's own initializers do not
run, and :func:`~simxns_tpu_torch.models.bert.init_weights` then gives it
CPU storage and draws. Its state_dict is bitwise the one the plain build
gives (PyTorch's initializers first, then the same draws), with the same
parameters shared. ``from_state_dict`` builds a T5 from a converted
state_dict the same way and holds exactly its tensors."""

import contextlib

import pytest
import torch

from simxns_tpu_torch.models import bert, colbert, condenser, cross_encoder
from simxns_tpu_torch.models import dual_encoder, reader, seq2seq, t5
from torch_parity import one_torch_thread  # noqa: F401

TINY = bert.BertConfig.tiny(vocab_size=96, max_position_embeddings=32)

MODELS = {
    "biencoder": (dual_encoder, lambda: dual_encoder.BiEncoder(
        dual_encoder.BiEncoderConfig(bert=TINY, projection_dim=16), _gen())),
    "cross_encoder": (cross_encoder, lambda: cross_encoder.CrossEncoder(
        cross_encoder.CrossEncoderConfig(bert=TINY, binary_head=True),
        _gen())),
    "colbert": (colbert, lambda: colbert.ColBERT(
        colbert.ColBERTConfig(bert=TINY, dim=16, share_weight=False),
        _gen())),
    "condenser": (condenser, lambda: condenser.Condenser(
        condenser.CondenserConfig(bert=TINY, n_head_layers=1), _gen())),
    "reader": (reader, lambda: reader.Reader(
        reader.ReaderConfig(bert=TINY), _gen())),
    "seq2seq": (seq2seq, lambda: seq2seq.Seq2Seq(
        seq2seq.Seq2SeqConfig(bert=TINY, num_decoder_layers=1), _gen())),
}


def _gen():
    return torch.Generator().manual_seed(7)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_seeded_build_equals_the_plain_build(name, monkeypatch):
    module, build = MODELS[name]
    fast = build()
    monkeypatch.setattr(module, "skip_init",
                        lambda on=True: contextlib.nullcontext())
    plain = build()
    assert not any(p.is_meta for p in fast.parameters())
    # the same parameters, shared where the plain build shares them
    assert ([n for n, _ in fast.named_parameters()]
            == [n for n, _ in plain.named_parameters()])
    want, got = plain.state_dict(), fast.state_dict()
    assert list(got) == list(want)
    for key, tensor in want.items():
        assert got[key].device.type == "cpu"
        assert got[key].dtype == tensor.dtype, key
        assert torch.equal(got[key], tensor), key


@pytest.mark.parametrize("tied", [True, False])
def test_t5_from_state_dict_holds_its_tensors(tied):
    cfg = t5.T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64,
                      num_layers=2, num_decoder_layers=1, num_heads=4,
                      relative_attention_num_buckets=8,
                      relative_attention_max_distance=16,
                      tie_word_embeddings=tied, dtype=torch.float32)
    sd = t5.T5(cfg, _gen()).state_dict()
    model = bert.from_state_dict(t5.T5, cfg, sd).eval()
    assert not any(p.is_meta for p in model.parameters())
    got = model.state_dict()
    assert list(got) == list(sd)
    for key, tensor in sd.items():
        assert got[key].data_ptr() == tensor.data_ptr(), key
    ids = torch.randint(2, 64, (2, 5), generator=_gen())
    ones = torch.ones_like(ids)
    rebuilt = t5.T5(cfg).eval()
    rebuilt.load_state_dict(sd)
    with torch.no_grad():
        assert torch.equal(model(ids, ones, ids, ones),
                           rebuilt(ids, ones, ids, ones))
