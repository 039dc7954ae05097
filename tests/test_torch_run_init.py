"""``--init-checkpoint`` in the port's launcher (``run_ar2``, ``run_kd``,
``run_pretrain``, ``run_lead``) against the JAX launcher's
(``tests/test_run.py:218, 239``).

Each artifact is a random-init ``transformers`` model saved to
``tmp_path`` (seed 0). Every run reaches its end, and at the graft the
named encoders hold exactly the artifact's converted weights (bitwise,
the first layers of a deeper artifact). One trajectory, LEAD's student
from a DistilBERT artifact, is held against the JAX launcher's from the
same artifact and the same CE weights: each joint loss within 2e-3
relative and the same top-1 (``tests/test_torch_run_lead.py``'s limit and
its reasons). A T5-shaped artifact exits with the JAX launcher's message.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from simxns_tpu import run as jrun
from simxns_tpu.models import BertConfig as JBertConfig
from simxns_tpu.models import CrossEncoder as JCrossEncoder
from simxns_tpu.models import CrossEncoderConfig as JCrossEncoderConfig
from simxns_tpu_torch import run as prun
from simxns_tpu_torch.models import hf_import, params_from_jax
from torch_parity import one_torch_thread  # noqa: F401

transformers = pytest.importorskip("transformers")


def _save(model, tmp_path, name="artifact"):
    d = tmp_path / name
    d.mkdir()
    torch.save(model.state_dict(), d / "pytorch_model.bin")
    return d


def _roberta(tmp_path):
    """A RoBERTa MLM artifact: its ``lm_head`` keys name the family (a bare
    ``RobertaModel`` state_dict reads as BERT's, in both packages)."""
    cfg = transformers.RobertaConfig(
        vocab_size=2048, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=80, type_vocab_size=1, pad_token_id=1)
    torch.manual_seed(0)
    return _save(transformers.RobertaForMaskedLM(cfg), tmp_path)


def _distilbert(tmp_path):
    cfg = transformers.DistilBertConfig(
        vocab_size=2048, dim=64, n_layers=4, n_heads=4, hidden_dim=128,
        max_position_embeddings=64, dropout=0.0, attention_dropout=0.0)
    torch.manual_seed(0)
    return _save(transformers.DistilBertModel(cfg), tmp_path)


def _bert(tmp_path, layers, mlm=False, positions=64):
    cfg = transformers.BertConfig(
        vocab_size=2048, hidden_size=64, num_hidden_layers=layers,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=positions)
    torch.manual_seed(0)
    cls = transformers.BertForMaskedLM if mlm else transformers.BertModel
    return _save(cls(cfg), tmp_path)


@pytest.fixture
def grafts(monkeypatch):
    """Spy on the launcher's graft: after each call, every grafted encoder
    must equal the artifact's first ``num_layers`` layers bitwise; records
    (prefixes, num_layers, family) per call."""
    calls = []
    real = prun._graft_encoder

    def spy(model, init, prefixes, num_layers):
        real(model, init, prefixes, num_layers)
        want = prun.truncate_layers(init["encoder"], num_layers)
        sd = model.state_dict()
        for prefix in prefixes:
            got = {k[len(prefix) + 1:]: v for k, v in sd.items()
                   if k.startswith(prefix + ".")}
            assert sorted(got) == sorted(want)
            assert all(torch.equal(got[k].cpu(), want[k]) for k in want)
        calls.append((tuple(prefixes), num_layers, init["family"]))

    monkeypatch.setattr(prun, "_graft_encoder", spy)
    return calls


def test_msdoc_init_checkpoint_roberta(tmp_path, grafts):
    """A RoBERTa artifact warm-starts both towers of the MS-Doc retriever
    (roberta positions, pad 1) and the run trains to its end (no warm-up,
    2 steps: the graft is the check)."""
    art = _roberta(tmp_path)
    out = prun.main(["--recipe", "msdoc_ar2_simans", "--synthetic",
                     "--steps", "2", "--warm-epochs", "0", "--batch", "8",
                     "--corpus-size", "64", "--num-queries", "24", "--topk",
                     "8", "--device", "cpu",
                     "--init-checkpoint", str(art),
                     "--output-dir", str(tmp_path / "run")])
    assert np.isfinite(out["top1"]) and 0.0 <= out["top1"] <= 1.0
    assert grafts == [(("question_model.encoder", "ctx_model.encoder"), 2,
                       "roberta")]


def test_kd_init_checkpoint_truncated_bert(tmp_path, grafts):
    """prod_kd_nq: the tiny 2-layer student takes the first 2 of a 4-layer
    BERT artifact's layers (the PROD student init), both towers."""
    art = _bert(tmp_path, layers=4)
    out = prun.main(["--recipe", "prod_kd_nq", "--synthetic", "--steps", "8",
                     "--batch", "8", "--corpus-size", "48",
                     "--num-queries", "16", "--device", "cpu",
                     "--init-checkpoint", str(art / "pytorch_model.bin"),
                     "--output-dir", str(tmp_path / "run")])
    assert out["steps"] == 8 and np.isfinite(out["final_loss"])
    assert grafts == [(("question_model.encoder", "ctx_model.encoder"), 2,
                       "bert")]


def test_pretrain_init_checkpoint_grafts_the_mlm_head(tmp_path, grafts,
                                                      monkeypatch):
    """master_pretrain from a BERT MLM artifact: the Condenser's encoder
    and its MLM head are the artifact's at the start."""
    art = _bert(tmp_path, layers=2, mlm=True)
    heads = []
    real = prun.init_condenser

    def spy(cfg, seed):
        model = real(cfg, seed)
        heads.append(model)
        return model

    monkeypatch.setattr(prun, "init_condenser", spy)
    init = prun._load_init_checkpoint(prun.build_parser().parse_args(
        ["--recipe", "master_pretrain", "--init-checkpoint", str(art)]))
    out = prun.main(["--recipe", "master_pretrain", "--steps", "4",
                     "--batch", "8", "--device", "cpu", "--lr", "0",
                     "--init-checkpoint", str(art),
                     "--output-dir", str(tmp_path / "run")])
    assert np.isfinite(out["final_loss"])
    assert grafts == [(("encoder",), 2, "bert")]
    # at lr 0 the head stays the artifact's through the run
    got = heads[0].mlm.state_dict()
    assert sorted(got) == sorted(init["mlm"])
    assert all(torch.equal(got[k].cpu(), init["mlm"][k]) for k in got)


def test_init_checkpoint_refuses_a_t5_artifact(tmp_path):
    """A T5-shaped artifact is no encoder warm start: both launchers exit
    with the same message."""
    d = tmp_path / "t5"
    d.mkdir()
    torch.save({"encoder.block.0.layer.0.SelfAttention.q.weight":
                torch.zeros(4, 4), "shared.weight": torch.zeros(8, 4)},
               d / "pytorch_model.bin")
    argv = ["--recipe", "lead_ms_distill", "--synthetic", "--steps", "2",
            "--batch", "8", "--corpus-size", "48", "--num-queries", "16",
            "--init-checkpoint", str(d)]
    with pytest.raises(SystemExit) as port:
        prun.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jax_exit:
        jrun.main(argv)
    assert str(port.value) == str(jax_exit.value)
    assert "T5" in str(port.value)


def _lead_losses(directory):
    with open(os.path.join(directory, "metrics.jsonl"), encoding="utf-8") as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)
                if r.get("phase") == "lead"]


def _init_models_with_jax_ce(de_cfg, ce_cfg, seed):
    """The JAX launcher's initial CE (PRNGKey(seed + 1)); the student's
    encoder is grafted from the artifact afterwards on both sides."""
    bert = JBertConfig.tiny(
        vocab_size=ce_cfg.bert.vocab_size,
        max_position_embeddings=ce_cfg.bert.max_position_embeddings)
    d = np.ones((2, 8), np.int32)
    jce = JCrossEncoder(JCrossEncoderConfig(bert=bert)).init(
        jax.random.PRNGKey(seed + 1), d, d)
    de, ce = prun.BiEncoder(de_cfg), prun.CrossEncoder(ce_cfg)
    ce.load_state_dict(params_from_jax(jax.device_get(jce)))
    return de, ce


def test_lead_init_checkpoint_distilbert_matches_jax(tmp_path, grafts,
                                                     monkeypatch):
    """``tests/test_run.py:239``: a 4-layer DistilBERT artifact warm-starts
    (and cuts to 2 layers) the LEAD student's shared tower; 8 joint steps
    follow the JAX launcher's from the same artifact."""
    art = _distilbert(tmp_path)
    argv = ["--recipe", "lead_ms_distill", "--synthetic", "--steps", "8",
            "--batch", "8", "--corpus-size", "48", "--num-queries", "16",
            "--init-checkpoint", str(art / "pytorch_model.bin")]
    want = jrun.main(argv + ["--output-dir", str(tmp_path / "jax")])
    monkeypatch.setattr(prun, "init_models", _init_models_with_jax_ce)
    got = prun.main(argv + ["--device", "cpu", "--output-dir",
                            str(tmp_path / "port")])
    assert grafts == [(("question_model.encoder",), 2, "distilbert")]
    lg, lw = _lead_losses(tmp_path / "port"), _lead_losses(tmp_path / "jax")
    assert [s for s, _ in lg] == [s for s, _ in lw] == list(range(1, 9))
    for (step, g), (_, w) in zip(lg, lw):
        assert abs(g - w) <= 2e-3 * abs(w), (step, g, w)
    assert got["top1"] == want["top1"]


def test_artifact_config_follows_the_jax_launcher(tmp_path):
    """``_init_bert_cfg``: the shapes, RoBERTa's positions and the recipe's
    shallower depth as the JAX launcher's; a vocabulary smaller than the
    corpus's exits with its message."""
    art = _roberta(tmp_path)
    args = prun.build_parser().parse_args(
        ["--recipe", "msdoc_ar2_simans", "--init-checkpoint", str(art)])
    jargs = jrun.build_parser().parse_args(
        ["--recipe", "msdoc_ar2_simans", "--init-checkpoint", str(art)])
    init, jinit = prun._load_init_checkpoint(args), jrun._load_init_checkpoint(
        jargs)
    assert init["family"] == jinit["family"] == "roberta"
    ours = prun._init_bert_cfg(init, prun.BertConfig.tiny(num_layers=1),
                               1000)
    want = jrun._init_bert_cfg(jinit, JBertConfig.tiny(num_layers=1), 1000)
    for f in ("vocab_size", "hidden_size", "num_layers", "intermediate_size",
              "max_position_embeddings", "type_vocab_size", "position_style",
              "pad_token_id"):
        assert getattr(ours, f) == getattr(want, f), f
    assert ours.num_layers == 1
    with pytest.raises(SystemExit) as port:
        prun._init_bert_cfg(init, prun.BertConfig.tiny(), 4096)
    with pytest.raises(SystemExit) as jax_exit:
        jrun._init_bert_cfg(jinit, JBertConfig.tiny(), 4096)
    assert str(port.value) == str(jax_exit.value)
    assert hf_import.sniff_hf_family(init["sd"]) == "roberta"
