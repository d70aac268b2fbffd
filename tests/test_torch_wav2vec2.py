"""The port's wav2vec 2.0 / UniSpeech pretraining against the JAX package's
(CPU, fp32).

A tiny Wav2Vec2PretrainModel is initialised by JAX from a seed, carried
into the port with ``wav2vec2_state_dict_from_jax`` and loaded with
``strict=True``. Dropout and layerdrop are 0. Each test runs the JAX side
with its own draws and records them (``JaxDraws``: the negatives'
``categorical``, the quantizer's ``gumbel``, the codebook negatives'
``randint``, the CTC head's ``bernoulli``); the port is fed those draws
through its sampling functions and JAX's mask as ``boundary_mask``, so both
compute the same function.

With the quantizer the batch has no padded frame: the port keeps padded
frames out of the quantizer's perplexities, where the JAX package counts
them (ops/quantizer.py); ``test_padded_frames_get_no_gradient`` holds
that. Without it the rows are padded.

Tolerances, fp32: logits and losses rtol 1e-5 (one forward, sums in other
orders; the -2^30 fill equal); ids and masks equal; per-parameter
gradients relative L2 1e-5 plus 1e-6 of the global gradient norm (the
k_proj bias's gradient is zero analytically, float noise on both sides),
1e-4 with the CTC term (CTC gradients are fp32-noisy on both sides); the
accuracy count within the number of near-tied frames;
parameters after two AdamW steps atol 2e-6, as tests/test_torch_train.py
holds them. The samplers are held statistically with fixed seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_quantizer import JaxDraws, feed
from unispeech_tpu.configs import EncoderConfig as JEncoderConfig
from unispeech_tpu.configs import GumbelVQConfig as JGumbelVQConfig
from unispeech_tpu.configs import MaskConfig as JMaskConfig
from unispeech_tpu.configs import Wav2Vec2PretrainConfig as JW2VConfig
from unispeech_tpu.models.wav2vec2 import Wav2Vec2PretrainModel as JW2V
from unispeech_tpu.train import optim as joptim
from unispeech_tpu.train.losses import wav2vec2_contrastive_loss as jax_w2v_loss
from unispeech_tpu.train.state import create_train_state as jax_create_state
from unispeech_tpu.train.state import make_train_step as jax_make_step
from unispeech_tpu.train.tasks import make_wav2vec2_loss_fn as jax_make_w2v_loss_fn
from unispeech_tpu.train.tasks import split_rngs
from unispeech_tpu_torch.configs import EncoderConfig, GumbelVQConfig, MaskConfig
from unispeech_tpu_torch.configs import Wav2Vec2PretrainConfig
from unispeech_tpu_torch.convert.from_jax import (
    jax_params_from_wav2vec2_state_dict,
    jax_params_of,
    wav2vec2_state_dict_from_jax,
)
from unispeech_tpu_torch.models import wav2vec2
from unispeech_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModel
from unispeech_tpu_torch.ops import quantizer
from unispeech_tpu_torch.train import optim
from unispeech_tpu_torch.train.losses import wav2vec2_contrastive_loss
from unispeech_tpu_torch.train.state import create_train_state, make_train_step
from unispeech_tpu_torch.train.tasks import make_wav2vec2_loss_fn

ENC = dict(
    conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)),
    encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
    encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
    dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, encoder_layerdrop=0.0,
)
W2V = dict(final_dim=24, num_negatives=5, logit_temp=0.1, final_dropout=0.0)
VQ = dict(num_vars=8, groups=2, vq_dim=24)
B, NS = 3, 3000
LENGTHS = np.asarray([3000, 2400, 1700], np.int32)
FULL = np.full(B, NS, np.int32)  # no padded frame
VOCAB = 9
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
VARIANTS = {
    "base": dict(),
    "unispeech": dict(transpose=True, ctc_vocab_size=VOCAB, negatives_from_everywhere=True),
    "cross_glu_depth2": dict(cross_sample_negatives=3, target_glu=True,
                             vq=dict(weight_proj_depth=2, weight_proj_factor=2)),
    "codebook_negatives": dict(codebook_negatives=4, negatives_from_everywhere=True),
    "no_quantizer": dict(quantize_targets=False, negatives_from_everywhere=True,
                         cross_sample_negatives=2),
    "large_style": dict(transpose=True, ctc_vocab_size=VOCAB,
                        enc=dict(extractor_mode="layer_norm", layer_norm_first=True,
                                 normalize=True)),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models here gain nothing from intra-op threads, and under a
    parallel test run OpenMP's spinning threads slow them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(variant="base"):
    v = dict(VARIANTS[variant])
    e = {**ENC, **v.pop("enc", {})}
    q = {**VQ, **v.pop("vq", {})}
    w = {**W2V, **v}
    mask = dict(mask_prob=0.65, mask_length=4)
    jcfg = JW2VConfig(encoder=JEncoderConfig(**e), time_mask=JMaskConfig(**mask),
                      quantizer=JGumbelVQConfig(**q), **w)
    cfg = Wav2Vec2PretrainConfig(encoder=EncoderConfig(**e), time_mask=MaskConfig(**mask),
                                 quantizer=GumbelVQConfig(**q), **w)
    return jcfg, cfg


def build_pair(variant="base"):
    jcfg, cfg = configs(variant)
    jmodel = JW2V(jcfg)
    params = jmodel.init({k: jax.random.PRNGKey(i) for i, k in enumerate(
        ("params", "mask", "negatives", "gumbel", "replace"))},
        jnp.zeros((1, NS)), mask=True, deterministic=True)["params"]
    params = jax.tree.map(np.array, params)
    model = Wav2Vec2PretrainModel(cfg)
    model.load_state_dict(wav2vec2_state_dict_from_jax(params, cfg), strict=True)
    return jcfg, jmodel, params, cfg, model


def batch(seed=0, with_labels=False, lengths=FULL):
    rng = np.random.RandomState(seed)
    b = {"source": rng.randn(B, NS).astype(np.float32), "lengths": lengths}
    if with_labels:
        b["labels"] = rng.randint(1, VOCAB, (B, 8)).astype(np.int32)
        b["label_lengths"] = np.asarray([8, 6, 3], np.int32)
    return b


def torch_batch(b, mask=None):
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    if mask is not None:
        tb["boundary_mask"] = torch.from_numpy(np.array(mask))
    return tb


def negative_indices(cfg, draws, T):
    """The flat indices JAX's two categorical draws stand for."""
    parts = []
    if cfg.num_negatives:
        same = draws.one("categorical", (B, T * cfg.num_negatives)).reshape(
            B, T, cfg.num_negatives)
        parts.append(same + (np.arange(B) * T)[:, None, None])
    if cfg.cross_sample_negatives:
        parts.append(draws.one("categorical", (1, B * T * cfg.cross_sample_negatives))
                     .reshape(B, T, cfg.cross_sample_negatives))
    return np.concatenate(parts, -1).astype(np.int64)


def feed_draws(monkeypatch, cfg, draws, T):
    """Feed the port the draws JAX recorded for one forward."""
    feed(monkeypatch, wav2vec2, "sample_negative_indices", negative_indices(cfg, draws, T))
    if cfg.quantize_targets:
        feed(monkeypatch, quantizer, "gumbel_noise",
             draws.one("gumbel", (B * T * cfg.quantizer.groups, cfg.quantizer.num_vars)))
    if cfg.codebook_negatives:
        feed(monkeypatch, wav2vec2, "codebook_ids",
             draws.one("randint", (B, T, cfg.codebook_negatives, cfg.quantizer.groups))
             .astype(np.int64))
    if cfg.ctc_vocab_size and cfg.transpose:
        feed(monkeypatch, wav2vec2, "replace_mask", draws.one("bernoulli", (B, T)))


def metrics_close(met, jmet, logits, weights):
    """Each metric rtol 1e-5, but the accuracy count: a masked frame whose
    positive logit is within 1e-5 of its best negative's is a tie that float
    noise breaks either way, so the counts may differ by the number of such
    frames."""
    lg = logits.detach().numpy()
    ties = int(((np.abs(lg[..., 0] - lg[..., 1:].max(-1)) <= 1e-5 * np.maximum(
        1.0, np.abs(lg[..., 0]))) & (weights.numpy() > 0)).sum())
    for k, v in jmet.items():
        if k == "correct":
            assert abs(float(met[k]) - float(v)) <= ties, (float(met[k]), float(v), ties)
        else:
            np.testing.assert_allclose(float(met[k].detach()), float(v), rtol=1e-5, err_msg=k)


def grads_close(model, want, cfg, tol=1e-5):
    want = wav2vec2_state_dict_from_jax(jax.tree.map(np.asarray, want), cfg)
    total = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    for name, p in model.named_parameters():
        # a head the loss does not reach has no gradient here, zeros in JAX
        g = np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
        w = want[name].numpy()
        assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w) + 1e-6 * total, name


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_logits_loss_and_gradients_match_jax(monkeypatch, variant):
    """One training forward (masks, Gumbel noise, negatives, codebook
    negatives, the replace mask) with JAX's draws: the contrastive logits
    (with the -2^30 of negatives equal to their positive), the quantizer's
    outputs, the CTC logits and the quantized stream, the InfoNCE loss with
    its diversity and feature penalties, and the gradients."""
    jcfg, jmodel, params, cfg, model = build_pair(variant)
    b = batch(lengths=FULL if cfg.quantize_targets else LENGTHS)
    T = cfg.encoder.num_frames(NS)
    draws = JaxDraws(monkeypatch, "categorical", "gumbel", "randint", "bernoulli")
    rngs = {k: jax.random.PRNGKey(i + 10) for i, k in enumerate(
        ("mask", "negatives", "gumbel", "replace", "dropout"))}
    cot = np.random.RandomState(2).randn(B, T, VOCAB).astype(np.float32)

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(b["source"]), jnp.asarray(b["lengths"]),
                           mask=True, deterministic=False, num_updates=3, rngs=rngs)
        w_m = out.mask_indices.astype(jnp.float32) * (~out.padding_mask).astype(jnp.float32)
        loss, _, met = jax_w2v_loss(out.contrastive_logits, w_m, out.features_pen,
                                    out.vq_result, features_pen_weight=10.0)
        if out.ctc_logits is not None:
            loss = loss + jnp.sum(out.ctc_logits * cot)
        return loss, (out, met)

    (jl, (jout, jmet)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    feed_draws(monkeypatch, cfg, draws, T)
    tb = torch_batch(b)
    out = model(tb["source"], tb["lengths"], mask=True, deterministic=False, num_updates=3,
                generator=torch.Generator(),
                boundary_mask=torch.from_numpy(np.array(jout.mask_indices)))
    w_m = out.mask_indices.float() * (~out.padding_mask).float()
    assert bool(out.padding_mask.any()) == (not cfg.quantize_targets)
    loss, _, met = wav2vec2_contrastive_loss(out.contrastive_logits, w_m, out.features_pen,
                                             out.vq_result, features_pen_weight=10.0)
    if out.ctc_logits is not None:
        loss = loss + (out.ctc_logits * torch.from_numpy(cot)).sum()
    np.testing.assert_array_equal(out.mask_indices.numpy(), np.asarray(jout.mask_indices))
    lg, jlg = out.contrastive_logits.detach().numpy(), np.asarray(jout.contrastive_logits)
    np.testing.assert_array_equal(lg == -(2.0 ** 30), jlg == -(2.0 ** 30))
    assert (lg == -(2.0 ** 30)).any()  # some negative equals its positive
    np.testing.assert_allclose(lg, jlg, rtol=1e-5, atol=1e-5)
    if cfg.ctc_vocab_size:
        np.testing.assert_allclose(out.ctc_logits.detach().numpy(), np.asarray(jout.ctc_logits),
                                   rtol=1e-5, atol=1e-5)
    if cfg.transpose:
        np.testing.assert_allclose(out.q_stream.detach().numpy(), np.asarray(jout.q_stream),
                                   rtol=1e-5, atol=1e-5)
    if cfg.quantize_targets:
        np.testing.assert_array_equal(out.vq_result["targets"].numpy(),
                                      np.asarray(jout.vq_result["targets"]))
    metrics_close(met, jmet, out.contrastive_logits, w_m)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    grads_close(model, jg, cfg)


@pytest.mark.parametrize("mtlalpha", [0.0, 0.5])
def test_make_wav2vec2_loss_fn_matches_jax(monkeypatch, mtlalpha):
    """The task's loss (UniSpeech: mtlalpha * CTC + (1 - mtlalpha) *
    InfoNCE) with JAX's draws, its metrics and gradients."""
    jcfg, jmodel, params, cfg, model = build_pair("unispeech")
    b = batch(with_labels=True)
    T = cfg.encoder.num_frames(NS)
    jfn = jax_make_w2v_loss_fn(jmodel, mtlalpha=mtlalpha)
    rng = jax.random.PRNGKey(4)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    # the mask and logits the loss function's forward draws (the same rngs)
    jout = jmodel.apply({"params": params}, jb["source"], jb["lengths"], mask=True,
                        deterministic=False, num_updates=2, rngs=split_rngs(rng))
    draws = JaxDraws(monkeypatch, "categorical", "gumbel", "bernoulli")
    (jl, (jss, jmet)), jg = jax.value_and_grad(
        lambda p: (lambda r: (r[0], r[1:]))(jfn(p, jb, rng, 2)), has_aux=True)(params)
    feed_draws(monkeypatch, cfg, draws, T)
    loss, ss, met = make_wav2vec2_loss_fn(model, mtlalpha=mtlalpha)(
        torch_batch(b, jout.mask_indices), torch.Generator(), 2)
    assert ("loss_ctc" in met) == (mtlalpha > 0) == ("loss_ctc" in jmet)
    w_m = torch.from_numpy(np.array(jout.mask_indices & ~jout.padding_mask, np.float32))
    metrics_close({k: v for k, v in met.items() if k != "layers_dropped"}, jmet,
                  torch.from_numpy(np.array(jout.contrastive_logits)), w_m)
    np.testing.assert_allclose(float(ss), float(jss), rtol=0)
    loss.backward()
    # CTC gradients are fp32-noisy on both sides (1.5e-5 and 3e-5 relative
    # to an fp64 one, tests/test_torch_ctc.py): 1e-4 with the CTC term
    grads_close(model, jg, cfg, tol=1e-4 if mtlalpha else 1e-5)


def test_train_steps_match_jax(monkeypatch):
    """Two steps of the port's make_train_step on the UniSpeech model's
    contrastive loss against JAX's jitted step, each fed that step's
    recorded draws (step 0 has learning rate 0 under the warmup, so step 1
    moves the parameters). The CTC term stays out: its fp32 gradient noise
    (above) would move Adam's first normalised update of near-zero
    gradients by more than the atol."""
    jcfg, jmodel, params, cfg, model = build_pair("unispeech")
    b = batch(seed=1, with_labels=True)
    T = cfg.encoder.num_frames(NS)
    rng = jax.random.PRNGKey(7)
    tx = joptim.make_optimizer(joptim.OptimConfig(**OPT))
    jstate = jax_create_state(params, tx)
    jloss_fn = jax_make_w2v_loss_fn(jmodel)
    jstep = jax_make_step(jloss_fn, tx, donate_state=False)
    state = create_train_state(model, optim.OptimConfig(**OPT), device="cpu")
    step = make_train_step(make_wav2vec2_loss_fn(model))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    draws = JaxDraws(monkeypatch, "categorical", "gumbel", "bernoulli")
    for i in range(2):
        r = jax.random.fold_in(rng, i)
        mask = jmodel.apply({"params": jstate.params}, jb["source"], jb["lengths"], mask=True,
                            deterministic=False, rngs=split_rngs(r),
                            features_only=True).mask_indices
        for calls in draws.calls.values():
            calls.clear()
        jstate, jmet = jstep(jstate, jb, rng)  # jit: the callbacks record each run
        jax.effects_barrier()
        feed_draws(monkeypatch, cfg, draws, T)
        met = step(state, torch_batch(b, mask), torch.Generator())
        for k in ("loss_per_sample", "grad_norm", "sample_size"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    want = wav2vec2_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
    start = wav2vec2_state_dict_from_jax(params, cfg)
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=2e-6, rtol=0,
                                   err_msg=name)
        moved = max(moved, float((want[name] - start[name]).abs().max()))
    assert moved > 1e-4


@pytest.mark.parametrize("variant", ["unispeech", "cross_glu_depth2", "no_quantizer"])
def test_params_round_trip(variant):
    """The inverse carry (and the training loop's export) gives back the JAX tree."""
    _, _, params, cfg, model = build_pair(variant)
    for back in (jax_params_from_wav2vec2_state_dict(model.state_dict(), cfg),
                 jax_params_of(model)):
        flat_a = jax.tree_util.tree_leaves_with_path(params)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[path], leaf)


def test_padded_frames_get_no_gradient():
    """A padded batch (one row of length 0) in WavLM-Large's structure: no
    loss term reaches a padded frame's conv features, so their gradient is
    exactly 0. In the JAX package the diversity term averages over the
    padded frames too, and the zero-variance LayerNorms of a fully padded
    frame blow its gradient up: with the perplexities over every frame the
    frontend's gradient norm grows over 1e4-fold here."""
    from unispeech_tpu_torch.ops.masking import frame_padding_mask

    _, cfg = configs("large_style")
    lengths = np.asarray([3000, 1700, 0], np.int32)

    def run(all_frames):
        model = Wav2Vec2PretrainModel(cfg, generator=torch.Generator().manual_seed(0))
        grads = {}

        def hook(module, inputs, out):
            out.register_hook(lambda g: grads.setdefault("conv_features", g))

        model.layer_norm.register_forward_hook(hook)
        tb = torch_batch(batch(with_labels=True, lengths=lengths))
        with pytest.MonkeyPatch.context() as m:
            if all_frames:  # the JAX package's reading: every frame counts
                real = quantizer._frame_mean
                m.setattr(quantizer, "_frame_mean", lambda x, valid: real(x, None))
            loss, _, _ = make_wav2vec2_loss_fn(model, mtlalpha=0.5)(
                tb, torch.Generator().manual_seed(1), 0)
            loss.backward()
        g = grads["conv_features"]
        pad = frame_padding_mask(tb["lengths"], NS, g.shape[1])
        front = torch.sqrt(sum((p.grad.double() ** 2).sum()
                               for p in model.feature_extractor.parameters()))
        return g, pad, float(front)

    g, pad, front = run(False)
    assert pad.any() and not g[pad].any() and g[~pad].any()
    assert np.isfinite(front)
    g_all, _, front_all = run(True)
    assert g_all[pad].any() and front_all > 1e4 * front


# ------------------------------------------------------------------ samplers
def _pool(seed=0, B=4, T=60):
    g = np.random.default_rng(seed)
    lengths = np.asarray([60, 41, 17, 0])
    valid = np.arange(T)[None] < lengths[:, None]
    return torch.from_numpy(valid & (g.random((B, T)) < 0.5)), torch.from_numpy(valid)


def test_negatives_stay_in_their_pool_and_row():
    for pool in _pool():
        B, T = pool.shape
        idx = wav2vec2.sample_negative_indices(torch.Generator().manual_seed(0), pool, 7, 5)
        assert idx.shape == (B, T, 12)
        flat = pool.reshape(-1)
        has = pool.any(-1)
        # every draw of a row with a pool lands in the pool (never padding)
        assert flat[idx[has]].all()
        assert (idx[..., :7] // T == torch.arange(B)[:, None, None]).all()
        assert len(torch.unique(idx[has][..., 7:] // T)) > 1
        assert (idx >= 0).all() and (idx < B * T).all()


def test_negatives_are_uniform_over_the_pool():
    """Chi-square of the same-row draws of one query row over its pool
    (p > 0.001 for each of 3 seeds), and of the cross draws over the
    batch's pool."""
    from scipy.stats import chisquare

    pool, _ = _pool(1)
    B, T = pool.shape
    for seed in range(3):
        idx = wav2vec2.sample_negative_indices(torch.Generator().manual_seed(seed), pool,
                                               200, 200)
        members = torch.nonzero(pool[0]).reshape(-1)
        counts = torch.bincount(idx[0, :, :200].reshape(-1), minlength=T)[members]
        assert counts.sum() == T * 200 and chisquare(counts.numpy()).pvalue > 1e-3
        fm = torch.nonzero(pool.reshape(-1)).reshape(-1)
        cross = torch.bincount(idx[..., 200:].reshape(-1), minlength=B * T)[fm]
        assert cross.sum() == B * T * 200 and chisquare(cross.numpy()).pvalue > 1e-3


def test_model_pool_is_masked_valid_frames_unless_everywhere(monkeypatch):
    """The model draws from the masked valid frames, or from every valid
    frame with negatives_from_everywhere."""
    real = wav2vec2.sample_negative_indices
    seen = {}

    def spy(gen, pool, n_same, n_cross):
        seen["pool"] = pool.clone()
        return real(gen, pool, n_same, n_cross)

    monkeypatch.setattr(wav2vec2, "sample_negative_indices", spy)
    for variant, everywhere in (("base", False), ("unispeech", True)):
        _, cfg = configs(variant)
        model = Wav2Vec2PretrainModel(cfg, generator=torch.Generator().manual_seed(0))
        tb = torch_batch(batch(lengths=LENGTHS))
        with torch.no_grad():
            out = model(tb["source"], tb["lengths"], mask=True, deterministic=False,
                        generator=torch.Generator().manual_seed(1))
        valid = ~out.padding_mask
        want = valid if everywhere else valid & out.mask_indices
        assert torch.equal(seen["pool"], want)
        assert everywhere or not torch.equal(want, valid)


def test_replace_mask_rate_and_codebook_ids():
    m = wav2vec2.replace_mask(torch.Generator().manual_seed(0), 0.3, (400, 500))
    assert abs(float(m.float().mean()) - 0.3) < 0.005
    ids = wav2vec2.codebook_ids(torch.Generator().manual_seed(0), (200_000,), 7)
    counts = torch.bincount(ids, minlength=7)
    assert ids.min() == 0 and ids.max() == 6 and (counts - 200_000 / 7).abs().max() < 1000


def test_training_forward_is_seeded_and_finite():
    """The whole UniSpeech forward with the port's own draws: the same
    generator seed gives the same loss, another seed another."""
    _, cfg = configs("unispeech")
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dropout=0.1,
                                                               attention_dropout=0.1))
    model = Wav2Vec2PretrainModel(cfg, generator=torch.Generator().manual_seed(0))
    fn = make_wav2vec2_loss_fn(model, mtlalpha=0.5)
    losses = [float(fn(torch_batch(batch(with_labels=True)),
                       torch.Generator().manual_seed(s), 0)[0].detach()) for s in (0, 0, 1)]
    assert np.isfinite(losses).all() and losses[0] == losses[1] != losses[2]
