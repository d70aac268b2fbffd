"""The port's seq2seq fine-tuning against the JAX package's (CPU): the
sinusoidal table, the decoder (causality, encoder padding, a fully padded
encoder row), the Seq2SeqModel's logits, the label-smoothed loss, a frozen
and an unfrozen train step, greedy and beam decoding, the n-gram ban, the
params carry both ways, and the padded-row finding (ROADMAP 3.15).

Tiny models are initialised by JAX from a seed in fp32 and carried into the
port with ``seq2seq_state_dict_from_jax`` (``load_state_dict(strict=True)``).
Tolerances, fp32: logits rtol 1e-5 / atol 1e-5 (tests/test_torch_ctc.py);
the loss rtol 1e-6 on the same logits; a train step as
tests/test_torch_ctc.py holds it: loss rtol 1e-5, gradient norm rtol 1e-4,
each tensor's gradient at relative L2 1e-4 (+1e-6 of the global norm), and
parameters after the step atol 2e-6 where the gradient element exceeds 1e-3
of its tensor's norm (the first Adam step of a tensor divides each
gradient element by its own size: an element within fp32 noise of 0, such
as the k_proj biases, whose gradient is 0 analytically, moves by up to lr
either way). Decoded tokens exact, beam scores rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.configs import EncoderConfig as JEncoderConfig
from unispeech_tpu.configs import MaskConfig as JMaskConfig
from unispeech_tpu.data.dataset import DataConfig as JDataConfig
from unispeech_tpu.data.dataset import Seq2SeqIterator as JSeq2SeqIterator
from unispeech_tpu.data.dictionary import Dictionary as JDictionary
from unispeech_tpu.data.manifest import Manifest as JManifest
from unispeech_tpu.models import seq2seq as jseq
from unispeech_tpu.train import optim as joptim
from unispeech_tpu.train.state import create_train_state as jax_create_state
from unispeech_tpu.train.state import make_train_step as jax_make_step
from unispeech_tpu.train.tasks import make_seq2seq_loss_fn as jax_make_loss_fn
from unispeech_tpu.train.tasks import split_rngs
from unispeech_tpu_torch.configs import EncoderConfig, MaskConfig
from unispeech_tpu_torch.convert.from_jax import (
    decoder_state_dict_from_jax,
    jax_params_from_seq2seq_state_dict,
    jax_params_of,
    seq2seq_state_dict_from_jax,
)
from unispeech_tpu_torch.data.dataset import DataConfig, Seq2SeqIterator
from unispeech_tpu_torch.data.dictionary import Dictionary
from unispeech_tpu_torch.data.manifest import Manifest
from unispeech_tpu_torch.models import seq2seq
from unispeech_tpu_torch.train import optim
from unispeech_tpu_torch.train.state import create_train_state, make_train_step
from unispeech_tpu_torch.train.tasks import make_seq2seq_loss_fn

ENC = dict(
    conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)),
    encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
    encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
    dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, encoder_layerdrop=0.0,
    relative_position_embedding=True, num_buckets=32, max_distance=64, gru_rel_pos=True,
)
DEC = dict(vocab_size=12, embed_dim=48, ffn_embed_dim=96, layers=2, heads=4,
           max_target_positions=64)
# pre-LN with learned positions and a tied output (the other wiring)
PRE_LN = dict(normalize_before=True, learned_pos=True, share_input_output_embed=True)
B, NS = 3, 3000
LENGTHS = np.asarray([3000, 2400, 1700], np.int32)
EOS, PAD = 2, 1


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models gain nothing from intra-op threads (see test_torch_train)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def build_pair(dec=None, seed=0, **over):
    """(JAX model, its params, port config, port model) of one init."""
    d = {**DEC, **(dec or {})}
    kw = {"apply_mask": False, **over}
    jkw = {k: (JMaskConfig(**v.__dict__) if isinstance(v, MaskConfig) else v)
           for k, v in kw.items()}
    jcfg = jseq.Seq2SeqConfig(encoder=JEncoderConfig(**ENC),
                              decoder=jseq.Seq2SeqDecoderConfig(**d), **jkw)
    cfg = seq2seq.Seq2SeqConfig(encoder=EncoderConfig(**ENC),
                                decoder=seq2seq.Seq2SeqDecoderConfig(**d), **kw)
    jmodel = jseq.Seq2SeqModel(jcfg)
    k = jax.random.PRNGKey(seed)
    params = to_numpy(jmodel.init({"params": k, "mask": k, "dropout": k}, jnp.zeros((1, NS)),
                                  jnp.zeros((1, 8), jnp.int32), deterministic=True)["params"])
    model = seq2seq.Seq2SeqModel(cfg)
    model.load_state_dict(seq2seq_state_dict_from_jax(params, cfg.encoder), strict=True)
    return jmodel, params, cfg, model


def batch(seed=0, S=8):
    """A padded batch: eos-shifted prev_tokens, eos-terminated targets."""
    rng = np.random.RandomState(seed)
    lens = [S - 1, 4, 2]
    tgt = np.full((B, S), PAD, np.int32)
    prev = np.full((B, S), PAD, np.int32)
    mask = np.zeros((B, S), np.float32)
    for r, L in enumerate(lens):
        toks = rng.randint(4, DEC["vocab_size"], L)
        tgt[r, :L], tgt[r, L] = toks, EOS
        prev[r, 0], prev[r, 1:L + 1] = EOS, toks
        mask[r, :L + 1] = 1.0
    return {"source": rng.randn(B, NS).astype(np.float32), "lengths": LENGTHS,
            "prev_tokens": prev, "targets": tgt, "target_mask": mask}


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def test_sinusoidal_table_matches_jax():
    """atol 1e-5: the fp32 argument pos * freq reaches 66 rad here, where one
    ulp is 4e-6, and XLA's exp and sin round apart from torch's."""
    for n, dim, pad in ((32, 16, 1), (64, 48, 1), (10, 7, 0)):
        got = seq2seq.sinusoidal_positions(n, dim, pad)
        want = np.asarray(jseq.sinusoidal_positions(n, dim, pad))
        assert got.shape == want.shape == (n + pad + 1, dim)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        assert not got[pad].any()


@pytest.mark.parametrize("dec", [None, PRE_LN], ids=["post_ln", "pre_ln_learned_tied"])
def test_decoder_matches_jax_causal_and_ignores_encoder_padding(dec):
    """The decoder alone on given encoder frames: JAX's logits; the logits
    at position t do not move when a later token changes; padded encoder
    frames do not matter; a fully padded encoder row stays finite (the
    -1e30 mask gives a uniform cross-attention row)."""
    d = jseq.Seq2SeqDecoderConfig(**{**DEC, **(dec or {})})
    jdec = jseq.TransformerDecoder(d)
    rng = np.random.RandomState(1)
    S, T, D = 9, 7, DEC["embed_dim"]
    tokens = rng.randint(3, DEC["vocab_size"], (2, S)).astype(np.int32)
    tokens[1, 6:] = PAD
    enc = rng.randn(2, T, D).astype(np.float32)
    pad = np.zeros((2, T), bool)
    pad[1, 4:] = True
    params = to_numpy(jdec.init(jax.random.PRNGKey(2), jnp.asarray(tokens), jnp.asarray(enc),
                                jnp.asarray(pad))["params"])
    want = np.asarray(jdec.apply({"params": params}, jnp.asarray(tokens), jnp.asarray(enc),
                                 jnp.asarray(pad)))
    port = seq2seq.TransformerDecoder(seq2seq.Seq2SeqDecoderConfig(**{**DEC, **(dec or {})}))
    port.load_state_dict(decoder_state_dict_from_jax(params), strict=True)
    tt, te, tp = torch.from_numpy(tokens), torch.from_numpy(enc), torch.from_numpy(pad)
    with torch.no_grad():
        got = port(tt, te, tp)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        later = tt.clone()
        later[:, 5:] = (later[:, 5:] + 1) % DEC["vocab_size"]
        moved = port(later, te, tp)
        torch.testing.assert_close(moved[:, :5], got[:, :5], rtol=0, atol=0)
        assert not torch.allclose(moved[:, 5:], got[:, 5:])
        noisy = te.clone()
        noisy[1, 4:] = 100.0
        torch.testing.assert_close(port(tt, noisy, tp)[1], got[1], rtol=1e-6, atol=1e-6)
        all_pad = tp.clone()
        all_pad[1] = True
        assert torch.isfinite(port(tt, te, all_pad)).all()


@pytest.mark.parametrize("dec", [None, PRE_LN, dict(embed_dim=64)],
                         ids=["enc_proj", "pre_ln_learned_tied", "same_width"])
def test_logits_match_jax(dec):
    jmodel, params, cfg, model = build_pair(dec)
    assert ("enc_proj" in params) == (model.enc_proj is not None)
    b = batch()
    jout = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, deterministic=True))(
        params, jnp.asarray(b["source"]), jnp.asarray(b["prev_tokens"]),
        jnp.asarray(b["lengths"]))
    with torch.no_grad():
        out = model(torch.from_numpy(b["source"]), torch.from_numpy(b["prev_tokens"]),
                    torch.from_numpy(b["lengths"]))
    assert out.logits.dtype == torch.float32 and out.logits.shape == jout.logits.shape
    np.testing.assert_array_equal(out.enc_padding_mask.numpy(),
                                  np.asarray(jout.enc_padding_mask))
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits), rtol=1e-5,
                               atol=1e-5)


def test_label_smoothed_loss_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 6, 11).astype(np.float32) * 3
    targets = rng.randint(0, 11, (3, 6)).astype(np.int32)
    mask = (rng.rand(3, 6) < 0.7).astype(np.float32)
    for ls in (0.0, 0.1, 0.3):
        jl, jn, jm = jseq.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets),
                                             jnp.asarray(mask), ls)
        loss, n, m = seq2seq.cross_entropy_loss(torch.from_numpy(logits),
                                                torch.from_numpy(targets),
                                                torch.from_numpy(mask), ls)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
        for k in ("nll_loss", "ntokens", "correct", "sample_size"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6, err_msg=k)
        assert float(n) == float(jn) == mask.sum()


def _jax_mask(jmodel, params, b, key, step):
    """The time mask JAX's train step draws at ``step`` (its loss function
    applies the model with split_rngs(fold_in(key, step)))."""
    _, inter = jmodel.apply(
        {"params": params}, jnp.asarray(b["source"]), jnp.asarray(b["prev_tokens"]),
        jnp.asarray(b["lengths"]), deterministic=False, step=step,
        rngs=split_rngs(jax.random.fold_in(key, step)),
        capture_intermediates=lambda mdl, name: mdl.name == "wavlm", mutable=["intermediates"])
    return np.asarray(inter["intermediates"]["wavlm"]["__call__"][0].mask_indices)


def test_frozen_and_unfrozen_steps_match_jax():
    """Two steps of the port's make_train_step against JAX's at a fixed lr,
    masking on (time mask 0.5/4, JAX's draw fed to the port as
    ``boundary_mask``), dropout off: step 0 is frozen (the backbone moves by
    AdamW's decay alone, enc_proj and the decoder by Adam), step 1 is not."""
    tm = MaskConfig(mask_prob=0.5, mask_length=4)
    cm = MaskConfig(mask_prob=0.0, mask_length=4, min_masks=0)
    jmodel, params, cfg, model = build_pair(freeze_finetune_updates=1, apply_mask=True,
                                            time_mask=tm, channel_mask=cm)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = dict(lr=1e-3, schedule="fixed")
    tx = joptim.make_optimizer(joptim.OptimConfig(**opt))
    jstate = jax_create_state(params, tx)
    jloss = jax_make_loss_fn(jmodel)
    jstep = jax_make_step(jloss, tx, donate_state=False)
    state = create_train_state(model, optim.OptimConfig(**opt), device="cpu")
    step = make_train_step(make_seq2seq_loss_fn(model))
    b = batch(2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    key = jax.random.PRNGKey(0)
    for i in range(2):
        mask = _jax_mask(jmodel, jstate.params, b, key, i)
        assert 0 < mask.sum() < mask.size
        rng_i = jax.random.fold_in(key, i)
        grads = jax.grad(lambda p: (lambda l, ss, _: l / ss)(*jloss(p, jb, rng_i, i)))(
            jstate.params)
        jgrad = seq2seq_state_dict_from_jax(to_numpy(grads), cfg.encoder)
        total = np.sqrt(sum(float((v.double() ** 2).sum()) for v in jgrad.values()))
        jstate, jmet = jstep(jstate, jb, key)
        tb = torch_batch(b)
        tb["boundary_mask"] = torch.from_numpy(mask.copy())
        met = step(state, tb, torch.Generator().manual_seed(0))
        for k, rtol in (("loss_per_sample", 1e-5), ("grad_norm", 1e-4), ("sample_size", 0)):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=rtol, err_msg=k)
        want = seq2seq_state_dict_from_jax(to_numpy(jstate.params), cfg.encoder)
        for name, p in model.named_parameters():
            got, w = p.detach().numpy(), want[name].numpy()
            g, wg = p.grad.numpy(), jgrad[name].numpy()
            assert np.linalg.norm(g - wg) <= 1e-4 * np.linalg.norm(wg) + 1e-6 * total, name
            sure = np.abs(wg) > 1e-3 * np.linalg.norm(wg)
            if not wg.any():  # frozen: the decay alone
                sure = np.ones_like(sure)
            np.testing.assert_allclose(got[sure], w[sure], atol=2e-6, rtol=0, err_msg=name)
        if i == 0:
            fc1 = "wavlm.encoder.layers.1.fc1.weight"
            np.testing.assert_allclose(model.state_dict()[fc1].numpy(),
                                       (before[fc1] * (1 - 1e-3 * 0.01)).numpy(), rtol=1e-6)
            assert not torch.equal(model.state_dict()["enc_proj.weight"],
                                   before["enc_proj.weight"])


@pytest.mark.parametrize("ngram", [0, 2, 3])
def test_greedy_and_beam_decode_match_jax(ngram):
    """greedy_decode and beam_decode (K = 3, max_len 10) give JAX's tokens,
    and the beams' normalised scores agree (rtol 1e-5); beam K = 1 without
    the ban is greedy; the beams are sorted best first."""
    jmodel, params, cfg, model = build_pair(dict(vocab_size=9), seed=3)
    b = batch(4)
    src, lens = jnp.asarray(b["source"]), jnp.asarray(b["lengths"])
    tsrc, tlens = torch.from_numpy(b["source"]), torch.from_numpy(b["lengths"])
    jg = np.asarray(jseq.greedy_decode(jmodel, {"params": params}, src, lens, EOS, EOS,
                                       max_len=10))
    g = seq2seq.greedy_decode(model, tsrc, tlens, EOS, EOS, max_len=10)
    np.testing.assert_array_equal(g.numpy(), jg)
    jt, js = jseq.beam_decode(jmodel, {"params": params}, src, lens, EOS, EOS, beam_size=3,
                              max_len=10, len_penalty=1.0, no_repeat_ngram=ngram)
    t, s = seq2seq.beam_decode(model, tsrc, tlens, EOS, EOS, beam_size=3, max_len=10,
                               len_penalty=1.0, no_repeat_ngram=ngram)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    assert (s[:, :-1] >= s[:, 1:]).all()
    if ngram == 0:
        t1, _ = seq2seq.beam_decode(model, tsrc, tlens, EOS, EOS, beam_size=1, max_len=10)
        np.testing.assert_array_equal(t1[:, 0].numpy(), g.numpy())


def test_ngram_ban_mask_matches_jax():
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, 4, (2, 3, 12)).astype(np.int32)
    banned = 0
    for n in (2, 3, 4):
        for t in range(0, 11):
            want = np.asarray(jseq._ngram_ban_mask(jnp.asarray(tokens), t, n, 6))
            got = seq2seq._ngram_ban_mask(torch.from_numpy(tokens).long(), t, n, 6)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"n={n} t={t}")
            banned += int(want.sum())
    assert banned > 0


@pytest.mark.parametrize("dec", [None, PRE_LN], ids=["enc_proj", "pre_ln_learned_tied"])
def test_params_round_trip(dec):
    """JAX -> port -> JAX gives back the JAX tree (``jax_params_of`` too);
    port -> JAX -> port gives back the state dict."""
    _, params, cfg, model = build_pair(dec)
    back = jax_params_from_seq2seq_state_dict(model.state_dict(), cfg.encoder)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    for tree in (back, jax_params_of(model)):
        flat_b = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[path], leaf)
    sd = seq2seq_state_dict_from_jax(back, cfg.encoder)
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def _letter_corpus(tmp_path, n=5):
    from tests.test_torch_data import _corpus

    d = _corpus(tmp_path, n=n, lo=8000, hi=20000)
    rng = np.random.RandomState(6)
    texts = [" ".join(rng.choice(list("ABCDE|"), rng.randint(0, 9))) for _ in range(n)]
    texts[1] = ""  # a real utterance with an empty transcript
    return d, texts


def test_padded_rows_finding(tmp_path):
    """ROADMAP 3.15. Fixed-shape seq2seq batches pad with zero-length rows.
    JAX's Seq2SeqIterator gives each such row one eos target with mask 1,
    so each adds an eos, predicted from an all-padding encoder row, to the
    loss and to ntokens; the port gives them mask 0. Everything else of
    the batches is bit-identical, and a real utterance with an empty
    transcript keeps its eos target in both."""
    d, texts = _letter_corpus(tmp_path)
    kw = dict(max_tokens=64_000, min_sample_size=1000, num_buckets=2)
    man_path = str(d / "train.tsv")
    port = Seq2SeqIterator(Manifest.load(man_path), DataConfig(**kw), texts,
                           Dictionary.letters(), seed=3)
    jax_it = JSeq2SeqIterator(JManifest.load(man_path), JDataConfig(**kw), texts,
                              JDictionary.letters(), seed=3)
    n_pad = n_empty = 0
    for got, want in zip(port.epoch_batches(1), jax_it.epoch_batches(1)):
        assert got.keys() == want.keys()
        zero = want["lengths"] == 0
        for k in got:
            if k != "target_mask":
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["target_mask"][~zero], want["target_mask"][~zero])
        # JAX: one eos target per padding row; the port: none
        assert (want["target_mask"][zero].sum(-1) == 1).all()
        assert (want["targets"][zero, 0] == EOS).all()
        assert not got["target_mask"][zero].any()
        n_pad += int(zero.sum())
        empty = (want["lengths"] > 0) & (want["targets"][:, 0] == EOS)
        assert (got["target_mask"][empty, 0] == 1).all()
        n_empty += int(empty.sum())
    assert n_pad > 0 and n_empty > 0
