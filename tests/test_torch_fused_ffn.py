"""The port's fused FFN (``simxns_tpu_torch/ops/fused_ffn.py``) against the
JAX package's Pallas kernels in interpret mode, and remat.

On the CPU every kernel wrapper of the port runs its plain PyTorch version,
so these tests hold the plain versions (what the CUDA kernels K9-K12 are
compared with on the card) to the TPU kernels themselves, then the two
``autograd.Function``s, the tiling rule and its fallback, a model, a
reranker step and an AR2 retriever step under ``ffn_impl="fused_vjp"``, and
``BertConfig.remat``. JAX weights are [in, out]; the port's are
``nn.Linear`` [out, in], so each weight crosses transposed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simxns_tpu.ops.flash_attention as jfa
import simxns_tpu.ops.fused_ffn as ff
import simxns_tpu.ops.fused_layer as jfl
from simxns_tpu.losses.contrastive import grouped_nll as jgrouped
from simxns_tpu.models import CrossEncoder as JaxCrossEncoder
from simxns_tpu.models import CrossEncoderConfig as JaxCrossEncoderConfig
from simxns_tpu.models.bert import BertEncoder as JaxBertEncoder
from simxns_tpu.parallel import create_mesh
from simxns_tpu.train import TrainState as JaxTrainState
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_ar2_retriever_step as jmake_ar2
from simxns_tpu.train import make_reranker_step as jmake_ce
from simxns_tpu_torch import run as port_run
from simxns_tpu_torch.config import RECIPES
from simxns_tpu_torch.models import (BertConfig, BertEncoder, CrossEncoder,
                                     CrossEncoderConfig, int8_view,
                                     params_from_jax)
from simxns_tpu_torch.ops import fused_ffn as pf
from simxns_tpu_torch.train import (TrainState, make_adamw,
                                    make_ar2_retriever_step,
                                    make_reranker_step, steps)
from torch_parity import (RUN_TINY, biencoder_pair, crossencoder_pair,
                          jax_bert, port_bert, token_batch)
from torch_parity import one_torch_thread  # noqa: F401

F32 = jnp.float32
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
N, M = 2, 32            # queries, passages per query: 64 rows x 20 tokens


@pytest.fixture(autouse=True)
def _interpret():
    old = ff.INTERPRET, jfa.INTERPRET, jfl.INTERPRET
    ff.INTERPRET = jfa.INTERPRET = jfl.INTERPRET = True
    yield
    ff.INTERPRET, jfa.INTERPRET, jfl.INTERPRET = old


@pytest.fixture
def f_block_128():
    """The JAX train kernels with 128-wide f-blocks, so F=384 spans three
    and their accumulation over blocks runs."""
    old = ff._F_BLOCK
    ff._F_BLOCK = 128
    yield
    ff._F_BLOCK = old


def _inputs(m, h, f, seed, dt=torch.float32):
    """(x, w1 [h, f], b1, w2 [f, h], b2, dy) as numpy f32 in the JAX layout;
    x and dy already rounded to ``dt``."""
    rng = np.random.default_rng(seed)

    def rounded(a):
        return torch.from_numpy(a).to(dt).float().numpy()

    return (rounded(rng.standard_normal((m, h), dtype=np.float32)),
            rng.normal(0, 0.02, (h, f)).astype(np.float32),
            rng.normal(0, 0.02, (f,)).astype(np.float32),
            rng.normal(0, 0.02, (f, h)).astype(np.float32),
            rng.normal(0, 0.02, (h,)).astype(np.float32),
            rounded(rng.standard_normal((m, h), dtype=np.float32)))


def _port(x, w1, b1, w2, b2, dt, grad=False):
    """The port's tensors: x in ``dt``, f32 weights in nn.Linear layout."""
    out = [torch.from_numpy(x).to(dt), torch.from_numpy(w1.T.copy()),
           torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
           torch.from_numpy(b2)]
    return [t.requires_grad_() for t in out] if grad else out


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(
        t, torch.Tensor) else t.detach().float().numpy()


def _rel(got, want):
    """max |got - want| over the largest |want|."""
    want = _np(want)
    return float(np.abs(_np(got) - want).max() / max(np.abs(want).max(), 1e-6))


# (m, h, f, dtype). f32: the same arithmetic up to summation order. bf16:
# F spans three 128-wide blocks on the JAX side (f_block_128).
KERNEL_CASES = [(64, 128, 256, torch.float32), (32, 128, 384, torch.bfloat16)]


@pytest.mark.parametrize("m,h,f,dt", KERNEL_CASES)
def test_train_forward_plain_matches_pallas_kernel(m, h, f, dt, f_block_128):
    """K9's plain version against ``_fused_train_call``: f32 to 1e-5
    (summation order); bf16 ``hb`` to one bf16 step (the f32 sum may cross
    a rounding boundary) and ``y`` within 3e-2 of its largest value, the
    JAX tests' own bf16 bound."""
    x, w1, b1, w2, b2, _ = _inputs(m, h, f, 1, dt)
    tile, fb = ff._train_tiles(m, h, f)
    jy, jhb = ff._fused_train_call(tile, fb, jnp.asarray(x, _JDT[dt]), w1, b1,
                                   w2, b2)
    px, pw1, pb1, pw2, pb2 = _port(x, w1, b1, w2, b2, dt)
    y, hb = pf.ffn_train_fwd(px, pw1.to(dt), pb1.to(dt), pw2.to(dt),
                             pb2.to(dt))
    assert y.dtype == hb.dtype == dt and hb.shape == (m, f)
    if dt == torch.float32:
        np.testing.assert_allclose(_np(hb), _np(jhb), atol=1e-5)
        np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5)
    else:
        assert np.all(np.abs(_np(hb) - _np(jhb))
                      <= 2.0 ** -7 * np.abs(_np(jhb)) + 1e-6)
        assert _rel(y, jy) < 3e-2
    y12 = pf.ffn_fused_fwd(px, pw1.to(dt), pb1.to(dt), pw2.to(dt), pb2.to(dt))
    assert torch.equal(y12, y)       # K12's plain version is K9's without hb


@pytest.mark.parametrize("m,h,f,dt", KERNEL_CASES)
def test_backward_plain_matches_pallas_kernels(m, h, f, dt, f_block_128):
    """K10's and K11's plain versions, and db2, against ``_fused_train_bwd``
    from the JAX kernel's own residuals: f32 to atol 1e-4 / rtol 1e-3 (the
    JAX tests' bound), bf16 within 3e-2 of the largest value."""
    x, w1, b1, w2, b2, dy = _inputs(m, h, f, 2, dt)
    tile, fb = ff._train_tiles(m, h, f)
    jx = jnp.asarray(x, _JDT[dt])
    _, jhb = ff._fused_train_call(tile, fb, jx, w1, b1, w2, b2)
    want = ff._fused_train_bwd(tile, fb, (jx, jnp.asarray(w1),
                                          jnp.asarray(w2), jhb),
                               jnp.asarray(dy, _JDT[dt]))
    px, pw1, _, pw2, _ = _port(x, w1, b1, w2, b2, dt)
    pdy = torch.from_numpy(dy).to(dt)
    phb = torch.from_numpy(np.asarray(jhb, np.float32)).to(dt)
    dx, dh = pf.ffn_bwd_dx(pdy, pw1.to(dt), pw2.to(dt), phb)
    dw1, db1, dw2 = pf.ffn_bwd_dw(px, pdy, phb, dh)
    assert dx.dtype == dh.dtype == dt
    assert dw1.dtype == db1.dtype == dw2.dtype == torch.float32
    got = (dx, dw1.T, db1, dw2.T, pdy.float().sum(0))
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        if dt == torch.float32:
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-3,
                                       err_msg=name)
        else:
            assert _rel(g, w) < 3e-2, name


@pytest.mark.parametrize("m,h,f,dt", KERNEL_CASES)
@pytest.mark.parametrize("knob", ["fused_vjp", "fused"])
def test_knob_gradients_match_jax_grad(knob, m, h, f, dt, f_block_128):
    """Both ``autograd.Function``s: the five gradients of ``sum(y ** 2)``
    against ``jax.grad`` of the JAX function, dtypes included, at the
    bounds of the kernel tests above."""
    x, w1, b1, w2, b2, _ = _inputs(m, h, f, 3, dt)
    jfn = {"fused_vjp": ff.fused_ffn_vjp, "fused": ff.fused_ffn}[knob]
    jargs = (jnp.asarray(x, _JDT[dt]), jnp.asarray(w1), jnp.asarray(b1),
             jnp.asarray(w2), jnp.asarray(b2))
    jy = jfn(*jargs)
    want = jax.grad(lambda *a: jnp.sum(jfn(*a).astype(F32) ** 2),
                    argnums=(0, 1, 2, 3, 4))(*jargs)
    args = _port(x, w1, b1, w2, b2, dt, grad=True)
    y = pf.ffn(*args, knob)
    grads = torch.autograd.grad(y.float().square().sum(), args)
    got = (grads[0], grads[1].T, grads[2], grads[3].T, grads[4])
    if dt == torch.float32:
        np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5)
    else:
        assert _rel(y, jy) < 3e-2
    for name, g, w, a in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want,
                             args):
        assert g.dtype == a.dtype and _JDT[g.dtype] == w.dtype, name
        if dt == torch.float32:
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-3,
                                       err_msg=name)
        else:
            assert _rel(g, w) < 3e-2, name


def test_3d_activations_keep_their_shape():
    """[B, S, H] in, [B, S, H] out, through the kernel path (64 rows)."""
    x, w1, b1, w2, b2, _ = _inputs(64, 128, 256, 4)
    args = _port(x, w1, b1, w2, b2, torch.float32)
    want = np.asarray(ff.fused_ffn(jnp.asarray(x).reshape(4, 16, 128), w1, b1,
                                   w2, b2))
    for knob in ("fused", "fused_vjp"):
        got = pf.ffn(args[0].reshape(4, 16, 128), *args[1:], knob)
        assert got.shape == (4, 16, 128)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("knob", ["fused_vjp", "fused"])
def test_unaligned_shapes_fall_back_to_the_reference(knob):
    """(7, 96, 200) tiles on neither side: both return the XLA-style
    composition with the true erf, equal to 1e-6."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((7, 96), dtype=np.float32)
    w1 = rng.normal(0, 0.02, (96, 200)).astype(np.float32)
    w2 = rng.normal(0, 0.02, (200, 96)).astype(np.float32)
    b1, b2 = np.zeros(200, np.float32), np.zeros(96, np.float32)
    jfn = {"fused_vjp": ff.fused_ffn_vjp, "fused": ff.fused_ffn}[knob]
    want = np.asarray(jfn(jnp.asarray(x), w1, b1, w2, b2))
    args = _port(x, w1, b1, w2, b2, torch.float32)
    got = pf.ffn(*args, knob)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert torch.equal(got, pf.ffn_reference(*args))


def test_tiling_rules_agree_with_jax():
    """``_train_tiles`` and ``fused_ffn``'s rule over a grid of (M, H, F),
    including F=4096 -> f-block 512 and F=3072 -> 768."""
    for m in (1, 7, 16, 48, 250, 256, 300, 512, 20480, 65536):
        for h in (96, 128, 768, 1024):
            for f in (128, 200, 256, 384, 3072, 4096, 8192):
                assert pf._train_tiles(m, h, f) == ff._train_tiles(m, h, f)
                tile = min(256, max(16, -(-m // 16) * 16))
                tiles = not (h % 128 or f % 128 or m % tile)
                assert (pf._fused_tile(m, h, f) is not None) == tiles
    assert pf._train_tiles(20480, 1024, 4096) == (256, 512)
    assert pf._train_tiles(16384, 768, 3072) == (256, 768)
    assert pf._train_tiles(64, 128, 200) is None


def test_plain_versions_use_the_kernels_erf_not_the_true_one():
    """Where shapes tile the knobs compute the Abramowitz-Stegun GELU from
    the rounded ``hb``; only the fallback uses the true erf."""
    x, w1, b1, w2, b2, _ = _inputs(64, 128, 256, 7)
    args = _port(x * 3, w1 * 20, b1, w2, b2, torch.float32)
    y = pf.fused_ffn(*args)
    hb = args[0] @ args[1].T + args[2]
    want = pf.gelu_exact(hb) @ args[3].T + args[4]
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-6)
    assert not torch.equal(y, pf.ffn_reference(*args))
    h = torch.linspace(-6, 6, 4001)
    np.testing.assert_allclose(pf.gelu_exact(h).numpy(), np.asarray(
        ff._gelu_exact(jnp.asarray(h.numpy()))), atol=1e-6)
    np.testing.assert_allclose(pf.gelu_grad(h).numpy(), np.asarray(
        ff._gelu_and_deriv(jnp.asarray(h.numpy()))[1]), atol=1e-6)


# --- models, steps, remat ----------------------------------------------------

def _encoder_pair(seed, **knobs):
    """(jax encoder, params, port encoder) with identical f32 weights; 4 x
    16 tokens make 64 rows, so the FFN shapes tile."""
    cfg = jax_bert(dtype=F32, **knobs)
    jenc = JaxBertEncoder(cfg)
    rng = np.random.default_rng(seed)
    ids, mask = token_batch(rng, 4, 16)
    params = jenc.init(jax.random.PRNGKey(seed), ids, mask)
    port = BertEncoder(port_bert(cfg))
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    return jenc, params, port, ids, mask


def _model_grads(jenc, params, port, ids, mask):
    def jloss(p):
        return jnp.sum(jenc.apply(p, ids, mask).pooled ** 2)

    want_loss, want = jax.value_and_grad(jloss)(params)
    loss = port(torch.from_numpy(ids), torch.from_numpy(mask)).pooled.square(
    ).sum()
    return loss, steps.gradients(port, loss), float(want_loss), want


def _check_grads(port_grads, jax_grads, rel):
    want = params_from_jax(jax.device_get(jax_grads))
    assert set(want) == set(port_grads)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = port_grads[name]
        g = torch.zeros_like(w) if g is None else g.float()
        err = float((g - w).abs().max())
        assert err <= rel * scale, (name, err)


@pytest.mark.parametrize("knob", ["fused_vjp", "fused"])
def test_model_matches_jax_under_the_ffn_knobs(knob):
    """A 2-layer encoder built from JAX params with the knob set: the loss
    to 1e-4 relative and every gradient to 1e-4 of the largest (f32
    summation order, as the training-step tests), and the state_dict keys
    of the ``"xla"`` model."""
    jenc, params, port, ids, mask = _encoder_pair(31, ffn_impl=knob)
    loss, grads, want_loss, want = _model_grads(jenc, params, port, ids, mask)
    assert abs(float(loss) - want_loss) <= 1e-4 * abs(want_loss)
    _check_grads(grads, want, rel=1e-4)
    plain = BertEncoder(port.cfg.replace(ffn_impl="xla"))
    assert list(plain.state_dict()) == list(port.state_dict())
    assert list(BertEncoder(port.cfg.replace(remat=True)).state_dict()) == list(
        port.state_dict())


@pytest.mark.parametrize("knob", ["xla", "fused_vjp"])
def test_remat_changes_nothing_but_memory(knob):
    """``remat=True`` gives the loss and gradients of ``remat=False``
    exactly (the CPU recomputation repeats the same operations), and
    matches the JAX model built with ``remat=True``."""
    jenc, params, port, ids, mask = _encoder_pair(33, ffn_impl=knob,
                                                  remat=True)
    assert port.cfg.remat
    loss, grads, want_loss, want = _model_grads(jenc, params, port, ids, mask)
    assert abs(float(loss) - want_loss) <= 1e-4 * abs(want_loss)
    _check_grads(grads, want, rel=1e-4)
    plain = BertEncoder(port.cfg.replace(remat=False))
    plain.load_state_dict(port.state_dict())
    loss0 = plain(torch.from_numpy(ids),
                  torch.from_numpy(mask)).pooled.square().sum()
    grads0 = steps.gradients(plain, loss0)
    assert torch.equal(loss0, loss)
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name


def test_remat_runs_the_forward_twice_and_guards_its_policy(monkeypatch):
    """A recomputed layer calls the forward wrapper (K9 on the card) a
    second time inside backward(); an encode under no_grad is untouched;
    ``remat_policy="dots"`` is refused by name, an unknown one as in JAX."""
    calls = []
    real = pf.ffn_train_fwd
    monkeypatch.setattr(pf, "ffn_train_fwd",
                        lambda *a: calls.append(1) or real(*a))
    cfg = BertConfig.tiny(hidden_size=128, intermediate_size=256,
                          ffn_impl="fused_vjp", remat=True)
    enc = BertEncoder(cfg)
    ids = torch.ones(4, 16, dtype=torch.long)
    loss = enc(ids).pooled.square().sum()
    assert len(calls) == 2
    loss.backward()
    assert len(calls) == 4                   # 2 layers, each forward twice
    with torch.no_grad():
        enc(ids)
    assert len(calls) == 6
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BertEncoder(cfg.replace(remat_policy="dots"))(ids)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        BertEncoder(cfg.replace(remat_policy="everything"))(ids)


def test_int8_view_drops_the_training_knobs():
    """The fused-int8 encode view of a model trained with
    ``ffn_impl="fused_vjp"`` and remat runs neither."""
    ce = CrossEncoder(CrossEncoderConfig(bert=BertConfig.tiny(
        hidden_size=128, remat=True, ffn_impl="fused_vjp")))
    bert = int8_view(ce).cfg.bert
    assert (bert.layer_impl, bert.ffn_impl, bert.remat) == (
        "fused_int8", "xla", False)


@pytest.mark.parametrize("flag,want", [("recipe", (False, False)),
                                       ("ce", (False, True)),
                                       ("de", (True, False)),
                                       ("both", (True, True)),
                                       ("none", (False, False))])
def test_remat_flag_reaches_the_model_configs(flag, want, monkeypatch):
    """``--remat`` of the launcher sets ``remat`` on the retriever's and
    the reranker's BertConfig, as ``simxns_tpu/run.py:735-737``."""
    seen = {}

    class Stop(Exception):
        pass

    def capture(de_cfg, ce_cfg, seed):
        seen["remat"] = (de_cfg.bert.remat, ce_cfg.bert.remat)
        raise Stop

    monkeypatch.setattr(port_run, "init_models", capture)
    args = port_run.build_parser().parse_args(
        ["--recipe", "nq_ar2_simans", "--device", "cpu", "--remat", flag,
         *RUN_TINY])
    with pytest.raises(Stop):
        port_run.run_ar2("nq_ar2_simans", RECIPES["nq_ar2_simans"], args)
    assert seen["remat"] == want


def _batch(seed):
    rng = np.random.default_rng(seed)
    q_ids, q_mask = token_batch(rng, N, 8)
    ctx_ids, ctx_mask = token_batch(rng, N * M, 12)
    joint_ids, joint_mask = token_batch(rng, N * M, 20)
    return {"q_ids": q_ids, "q_mask": q_mask, "ctx_ids": ctx_ids,
            "ctx_mask": ctx_mask,
            "positive_idx": (np.arange(N) * M).astype(np.int32),
            "joint_ids": joint_ids.reshape(N, M, 20),
            "joint_mask": joint_mask.reshape(N, M, 20)}


def _run_steps(jstep, tstep, jstate, tstate, batches, jextra=(), textra=()):
    for b in batches:
        jstate, jm = jstep(jstate, *jextra, b)
        tstate, tm = tstep(tstate, *textra, b)
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= 1e-4 * abs(want)
    return jstate


def _check_params(module, jparams):
    want = params_from_jax(jax.device_get(jparams))
    for name, p in module.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= 1e-5, (name, err)


def _tx():
    kw = dict(lr=1e-4, total_steps=0, eps=1e-3)
    return jmake_adamw(**kw), make_adamw(**kw)


def test_reranker_step_under_fused_vjp_matches_jax():
    """One gradient check and two reranker steps with
    ``ffn_impl="fused_vjp"`` and the grouped attention on both sides (64
    joint rows x 20 tokens = 1280 FFN rows, which tile): the pattern and
    bounds of ``test_torch_train.py``."""
    jmodel, params, port = crossencoder_pair(
        jax_bert(small_s_attn="group", ffn_impl="fused_vjp", dtype=F32),
        seed=41)
    batches = [_batch(50 + s) for s in range(2)]
    b0 = batches[0]

    def jloss(p):
        logits = jmodel.apply(p, b0["joint_ids"].reshape(N * M, -1),
                              b0["joint_mask"].reshape(N * M, -1),
                              group_size=M)["logits"]
        return jgrouped(logits)

    loss, _ = steps.reranker_loss(port, steps.to_device(b0, "cpu"))
    _check_grads(steps.gradients(port, loss), jax.grad(jloss)(params),
                 rel=1e-4)
    jtx, tx = _tx()
    jstate = JaxTrainState.create(jax.tree.map(jnp.copy, params), jtx)
    jstate = _run_steps(jmake_ce(jmodel, jtx, create_mesh(n_data=1),
                                 group_size=M),
                        make_reranker_step(tx, device="cpu"), jstate,
                        TrainState.create(port, tx), batches)
    _check_params(port, jstate.params)


def test_ar2_retriever_step_under_fused_vjp_matches_jax():
    """Two AR2 retriever steps with ``ffn_impl="fused_vjp"`` in the dual
    encoder (16 query rows and 768 passage rows tile) and the fused-int8
    teacher view, whose config drops the knob on both sides."""
    jde, de_params, port_de = biencoder_pair(
        jax_bert(ffn_impl="fused_vjp", dtype=F32), seed=43)
    ce_cfg = jax_bert(small_s_attn="group", ffn_impl="fused_vjp", dtype=F32)
    _, ce_params, port_ce = crossencoder_pair(ce_cfg, seed=44)
    jteacher = JaxCrossEncoder(JaxCrossEncoderConfig(bert=ce_cfg.replace(
        layer_impl="fused_int8", ffn_impl="xla", proj_impl="xla")))
    teacher = int8_view(port_ce)
    batches = [_batch(60 + s) for s in range(2)]
    kw = dict(temperature=0.8, adv_lambda=0.5, scale_scores=0.25)
    jtx, tx = _tx()
    jstate = JaxTrainState.create(jax.tree.map(jnp.copy, de_params), jtx)
    jstate = _run_steps(jmake_ar2(jde, jteacher, jtx, create_mesh(n_data=1),
                                  **kw),
                        make_ar2_retriever_step(tx, device="cpu", **kw),
                        jstate, TrainState.create(port_de, tx), batches,
                        jextra=(ce_params,), textra=(teacher,))
    _check_params(port_de, jstate.params)
