"""The port's host-side text and decode modules against the JAX package's
(CPU): the dictionary, the text encoders and ``post_process``, edit
distance and WER, the ARPA LM, the CTC prefix beam search, and the
valid-time decode of fine-tuning.

These are copies of pure-Python modules (the port's edit distance is the
numpy row DP the JAX package falls back to), so every result is held
exactly; LM scores are held to 1e-12 (the same float operations); the
valid decode runs a tiny fp32 model carried from JAX (logits within
1e-5, tests/test_torch_ctc.py), and its error sums are held exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.data import text_encoders as jte
from unispeech_tpu.data.dictionary import Dictionary as JDictionary
from unispeech_tpu.decode import wer as jwer
from unispeech_tpu.decode.arpa import ArpaLM as JArpaLM
from unispeech_tpu.decode.beam import CtcBeamDecoder as JBeam
from unispeech_tpu.decode.beam import best_path_decode as jax_best_path
from unispeech_tpu_torch.data import text_encoders as te
from unispeech_tpu_torch.data.dictionary import Dictionary
from unispeech_tpu_torch.decode import wer
from unispeech_tpu_torch.decode.arpa import ArpaLM
from unispeech_tpu_torch.decode.beam import CtcBeamDecoder, KenLMWrapper, best_path_decode

LN10 = math.log(10.0)

ARPA = """\
\\data\\
ngram 1=5
ngram 2=2

\\1-grams:
-0.5\t<s>\t-0.3
-1.0\t</s>
-0.7\ta\t-0.2
-0.9\tb\t-0.1
-2.0\t<unk>

\\2-grams:
-0.3\t<s> a
-0.4\ta b

\\end\\
"""


@pytest.fixture()
def arpa(tmp_path):
    p = tmp_path / "tiny.arpa"
    p.write_text(ARPA)
    return str(p)


# ---------------------------------------------------------------- dictionary
def test_dictionary_letters_round_trip(tmp_path):
    d, jd = Dictionary.letters(), JDictionary.letters()
    assert d.symbols == jd.symbols and len(d) == 32
    assert d.blank() == d.bos() == 0 and (d.pad(), d.eos(), d.unk()) == (1, 2, 3)
    for line in ("H E L L O |", "  A  B\tC | ", "X ? Q |", ""):
        np.testing.assert_array_equal(d.encode_line(line), jd.encode_line(line))
        ids = d.encode_line(line, append_eos=True)
        assert d.string(ids) == jd.string(ids)
        assert d.string(ids, ignore=[d.eos()]) == jd.string(ids, ignore=[d.eos()])
    p = tmp_path / "dict.ltr.txt"
    d.save(str(p))
    assert Dictionary.load(str(p)).symbols == JDictionary.load(str(p)).symbols == d.symbols


@pytest.mark.parametrize("text", ['{"a": 4, "b": 5, "c": 6}', "x 10\ny -3\nz\nw 2 extra\n"],
                         ids=["json", "dict_txt"])
def test_dictionary_load_matches_jax(tmp_path, text):
    p = tmp_path / ("vocab.json" if text.startswith("{") else "dict.txt")
    p.write_text(text)
    d, jd = Dictionary.load(str(p)), JDictionary.load(str(p))
    assert (d.symbols, d.count, d.indices) == (jd.symbols, jd.count, jd.indices)
    d.encode_line("new tokens", add_if_not_exist=True)
    jd.encode_line("new tokens", add_if_not_exist=True)
    assert d.symbols == jd.symbols


# ---------------------------------------------------------------- text encoders
@pytest.mark.parametrize("s", ["hello world", "ümlaut façade", "日本語 テスト", "mixed 平仮名 x",
                               "a\t b\n c"])
def test_byte_and_char_encoders_match_jax(s):
    toks = te.ByteEncoder().encode(s)
    assert toks == jte.ByteEncoder().encode(s)
    assert te.ByteEncoder().decode(toks) == jte.ByteEncoder().decode(toks)
    ctoks = te.CharEncoder().encode(s)
    assert ctoks == jte.CharEncoder().encode(s)
    assert te.CharEncoder().decode(ctoks) == jte.CharEncoder().decode(ctoks)
    for cut in range(len(toks)):  # truncated byte strings, as model output can be
        broken = te.byte_encode(s)[:cut]
        assert te.smart_byte_decode(broken) == jte.smart_byte_decode(broken)


def test_subword_nmt_bpe_matches_jax(tmp_path):
    codes = tmp_path / "codes.bpe"
    codes.write_text("#version: 0.2\nl o\nlo w</w>\ne r</w>\nlo w\n")
    bpe, jbpe = te.SubwordNMTBPE(str(codes)), jte.SubwordNMTBPE(str(codes))
    for s in ("low", "lower", "low lower", "slow flower er"):
        assert bpe.encode(s) == jbpe.encode(s)
        assert bpe.decode(bpe.encode(s)) == jbpe.decode(jbpe.encode(s))
    assert te.get_text_encoder("none") is None
    for name, kw in (("bpe", {}), ("nope", {}), ("sentencepiece", {})):
        with pytest.raises(ValueError):
            te.get_text_encoder(name, **kw)


@pytest.mark.parametrize("symbol,sentence", [
    ("letter", "H E L L O | W O R L D |"), ("sentencepiece", "▁he llo ▁world"),
    ("wordpiece", "_he llo _world"), ("silence", "a <SIL> b  <SIL>"),
    ("_EOW", "h i_EOW y o u_EOW"), ("bpe", "low@@ er new"), ("@@ ", "a@@ b"),
    ("byte", te.ByteEncoder().encode("héllo")), ("char", "a ▁ b"), ("none", "x y"),
])
def test_post_process_matches_jax(symbol, sentence):
    assert wer.post_process(sentence, symbol) == jwer.post_process(sentence, symbol)


# ---------------------------------------------------------------- WER
def test_edit_distance_and_wer_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(40):
        a = rng.integers(0, 4, rng.integers(0, 12)).tolist()
        b = rng.integers(0, 4, rng.integers(0, 12)).tolist()
        assert wer.edit_distance(a, b) == jwer.edit_distance(a, b)
    words = ["the", "cat", "sat", "on", "a", "mat"]
    sc, jsc = wer.WerScorer(), jwer.WerScorer()
    for _ in range(10):
        hyp = " ".join(rng.choice(words, rng.integers(0, 6)))
        ref = " ".join(rng.choice(words, rng.integers(1, 6)))
        sc.add(hyp, ref)
        jsc.add(hyp, ref)
    assert (sc.w_errs, sc.w_len, sc.c_errs, sc.c_len) == (
        jsc.w_errs, jsc.w_len, jsc.c_errs, jsc.c_len)
    assert sc.wer == jsc.wer and sc.uer == jsc.uer


# ---------------------------------------------------------------- ARPA LM
def test_arpa_scores(arpa):
    lm, jlm = ArpaLM(arpa), JArpaLM(arpa)
    assert lm.order == 2 and lm.ngrams == jlm.ngrams
    st = lm.start()
    st, s = lm.score(st, "a")
    assert s == pytest.approx(-0.3 * LN10)
    st_b, s = lm.score(st, "b")
    assert s == pytest.approx(-0.4 * LN10)
    assert lm.score(st, "a")[1] == pytest.approx(-0.9 * LN10)  # backoff
    assert lm.score(st, "zzz")[1] == pytest.approx(-2.2 * LN10)  # <unk>
    assert lm.finish(st_b) == pytest.approx(-1.1 * LN10)
    st, jst = lm.start(), jlm.start()
    for w in ("a", "b", "b", "zzz", "a", "a", "</s>"):
        (st, s), (jst, js) = lm.score(st, w), jlm.score(jst, w)
        assert st == jst and s == pytest.approx(js, abs=1e-12)


def test_kenlm_wrapper_reads_arpa_without_kenlm(arpa, tmp_path):
    try:
        import kenlm  # noqa: F401
    except ImportError:
        assert isinstance(KenLMWrapper(arpa), ArpaLM)
        with pytest.raises(ImportError):
            KenLMWrapper(str(tmp_path / "x.bin"))
    else:
        assert np.isfinite(KenLMWrapper(arpa).score(KenLMWrapper(arpa).start(), "a")[1])


# ---------------------------------------------------------------- beam search
@pytest.mark.parametrize("mode", ["plain", "lexicon", "lexicon_lm"])
def test_beam_decoder_nbest_matches_jax(mode, arpa):
    """Units 0 blank, 1 'a', 2 'b', 3 '|' (the word boundary), 4 'c'."""
    rng = np.random.default_rng(1)
    T, V = 14, 5
    lp = np.log(rng.dirichlet(np.ones(V) * 0.5, size=T)).astype(np.float32)
    kw = dict(beam=8, beam_threshold=25.0)
    if mode != "plain":
        kw.update(silence_id=3, lexicon={"a": [[1]], "b": [[2]], "ab": [[1, 2]],
                                         "ca": [[4, 1], [4, 4, 1]]},
                  lm_weight=0.5, word_score=-0.3)
    if mode == "lexicon_lm":
        nbest = CtcBeamDecoder(lm=ArpaLM(arpa), **kw).decode(lp, 12)
        jnbest = JBeam(lm=JArpaLM(arpa), **kw).decode(lp, 12)
    else:
        nbest = CtcBeamDecoder(**kw).decode(lp, 12)
        jnbest = JBeam(**kw).decode(lp, 12)
    assert len(nbest) == len(jnbest) > 1
    for (u, w, s), (ju, jw, js) in zip(nbest, jnbest):
        assert (u, w) == (ju, jw) and s == js
    if mode != "plain":
        assert any(w for _, w, _ in nbest)  # words were emitted
    assert best_path_decode(lp, 12) == jax_best_path(lp, 12)


# ---------------------------------------------------------------- valid decode
@pytest.mark.parametrize("decoder", ["greedy", "kenlm"])
def test_valid_decode_fn_matches_jax(decoder, arpa):
    """make_ctc_valid_decode_fn on a tiny fp32 model carried from JAX: the
    same WER/UER sums as the JAX package's, greedy and ARPA-LM decoded."""
    from unispeech_tpu.configs import base_encoder_config as jbase
    from unispeech_tpu.models.ctc import CtcFinetuneConfig as JCfg
    from unispeech_tpu.models.ctc import CtcFinetuneModel as JModel
    from unispeech_tpu.train.state import TrainState as JState
    from unispeech_tpu.train.tasks import make_ctc_valid_decode_fn as jax_make_fn
    from unispeech_tpu_torch.configs import base_encoder_config
    from unispeech_tpu_torch.convert.from_jax import ctc_state_dict_from_jax
    from unispeech_tpu_torch.models.ctc import CtcFinetuneConfig, CtcFinetuneModel
    from unispeech_tpu_torch.train.state import TrainState
    from unispeech_tpu_torch.train.tasks import make_ctc_valid_decode_fn

    enc = dict(conv_layers=((16, 10, 5), (16, 8, 4), (16, 4, 2)), encoder_layers=1,
               encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_attention_heads=2,
               dropout=0.0, attention_dropout=0.0, relative_position_embedding=False,
               gru_rel_pos=False)
    d = Dictionary.letters()
    jmodel = JModel(JCfg(encoder=jbase(**enc), vocab_size=len(d), apply_mask=False))
    src = np.random.RandomState(5).randn(2, 3200).astype(np.float32)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(src[:1]),
                         deterministic=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg = CtcFinetuneConfig(encoder=base_encoder_config(**enc), vocab_size=len(d),
                            apply_mask=False)
    model = CtcFinetuneModel(cfg)
    model.load_state_dict(ctc_state_dict_from_jax(params, cfg.encoder), strict=True)

    lexicon = {"a": [[d.index("A"), d.index("|")]], "b": [[d.index("B"), d.index("|")]]}
    kw = dict(decoder=decoder, beam=4, lexicon=lexicon if decoder == "kenlm" else None,
              lm_path=arpa if decoder == "kenlm" else None, lm_weight=1.0)
    labels = np.ones((2, 4), np.int32)
    for r, txt in enumerate(["A |", "B | A |"]):
        ids = [d.index(t) for t in txt.split()]
        labels[r, :len(ids)] = ids
    b = {"source": src, "lengths": np.asarray([3200, 2500], np.int32), "labels": labels,
         "label_lengths": np.asarray([2, 4], np.int32)}
    jstate = JState(step=jnp.zeros((), jnp.int32), params=params, opt_state=())
    want = jax_make_fn(jmodel, JDictionary.letters(), **kw)(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    got = make_ctc_valid_decode_fn(model, d, **kw)(
        TrainState(model=model, optimizer=None), {k: torch.from_numpy(v) for k, v in b.items()})
    assert got == want
    assert got["wer_len"] == 3.0 and got["uer_len"] > 0
