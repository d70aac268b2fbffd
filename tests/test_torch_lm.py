"""The port's Transformer LM and its shallow fusion against the JAX
package's (CPU): TransformerLM logits and ``lm_loss``, causality, a train
step, the params carry both ways, ``NeuralLMScorer`` scores and the
fusion case of tests/test_lm_beam.py, and ``load_neural_lm``'s config
fallback.

Tiny LMs are initialised by JAX from a seed in fp32 and carried into the
port with ``lm_state_dict_from_jax`` (``load_state_dict(strict=True)``).
Tolerances, fp32: logits and log-probs rtol 1e-5 / atol 1e-5 (the same
products summed in other orders, as tests/test_torch_seq2seq.py); the
summed loss rtol 1e-5; decoded words exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.data.dictionary import Dictionary as JDictionary
from unispeech_tpu.decode.beam import CtcBeamDecoder as JCtcBeamDecoder
from unispeech_tpu.decode.lm_fusion import NeuralLMScorer as JNeuralLMScorer
from unispeech_tpu.models import lm as jlm
from unispeech_tpu.train.checkpoint import save_params_npz
from unispeech_tpu_torch.convert.from_jax import (
    jax_params_from_lm_state_dict,
    jax_params_of,
    lm_state_dict_from_jax,
)
from unispeech_tpu_torch.data.dictionary import Dictionary
from unispeech_tpu_torch.decode.beam import CtcBeamDecoder
from unispeech_tpu_torch.decode.lm_fusion import NeuralLMScorer, load_neural_lm
from unispeech_tpu_torch.models import lm

TINY = dict(embed_dim=32, ffn_dim=64, layers=2, heads=2, dropout=0.0, max_positions=64)
# post-LN with learned positions and an untied output (the other wiring)
POST_LN = dict(normalize_before=False, learned_pos=True, share_input_output_embed=False)


def to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def build_pair(vocab=17, seed=0, **over):
    kw = {**TINY, "vocab_size": vocab, **over}
    jmodel = jlm.TransformerLM(jlm.TransformerLMConfig(**kw))
    params = to_numpy(jmodel.init({"params": jax.random.PRNGKey(seed)},
                                  jnp.zeros((1, 8), jnp.int32))["params"])
    cfg = lm.TransformerLMConfig(**kw)
    model = lm.TransformerLM(cfg)
    model.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return jmodel, params, cfg, model


def tokens(seed=1, B=3, S=12, vocab=17):
    t = np.random.RandomState(seed).randint(2, vocab, (B, S)).astype(np.int32)
    t[1, 9:] = 1  # a padded tail
    return t


@pytest.mark.parametrize("over", [{}, POST_LN], ids=["pre_ln_tied", "post_ln_learned_untied"])
def test_logits_loss_and_causality_match_jax(over):
    jmodel, params, cfg, model = build_pair(**over)
    t = tokens()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(t)))
    with torch.no_grad():
        got = model(torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 12, 17)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    tl, tn = lm.lm_loss(got[:, :-1], torch.from_numpy(t[:, 1:]), cfg.padding_idx)
    jl, jn = jlm.lm_loss(jnp.asarray(want[:, :-1]), jnp.asarray(t[:, 1:]), cfg.padding_idx)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tn) == float(jn) == (t[:, 1:] != 1).sum()
    later = torch.from_numpy(t).clone()
    later[:, 7] = (later[:, 7] + 1) % 15 + 2
    with torch.no_grad():
        moved = model(later)
    torch.testing.assert_close(moved[:, :7], got[:, :7], rtol=0, atol=0)
    assert not torch.allclose(moved[:, 7:], got[:, 7:])


def test_train_step_loss_and_gradients_match_jax():
    """The summed next-token loss and its gradients with dropout 0: each
    parameter's gradient at relative L2 1e-4 (+1e-6 of the global norm),
    as tests/test_torch_seq2seq.py holds a step."""
    jmodel, params, cfg, model = build_pair()
    t = tokens(2)
    jfn = lambda p: jlm.lm_loss(jmodel.apply({"params": p}, jnp.asarray(t[:, :-1])),
                                jnp.asarray(t[:, 1:]), cfg.padding_idx)[0]
    jloss, jgrads = jax.value_and_grad(jfn)(params)
    loss, _ = lm.lm_loss(model(torch.from_numpy(t[:, :-1]), deterministic=False,
                               generator=torch.Generator().manual_seed(0)),
                         torch.from_numpy(t[:, 1:]), cfg.padding_idx)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = lm_state_dict_from_jax(to_numpy(jgrads))
    total = np.sqrt(sum(float((v.double() ** 2).sum()) for v in want.values()))
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-6 * total, name


def test_dropout_draws_from_the_generator():
    _, _, cfg, model = build_pair(dropout=0.1)
    t = torch.from_numpy(tokens(3))
    run = lambda s: model(t, deterministic=False, generator=torch.Generator().manual_seed(s))
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        model(t, deterministic=False)
    torch.testing.assert_close(model(t), model(t), rtol=0, atol=0)


@pytest.mark.parametrize("over", [{}, POST_LN], ids=["pre_ln_tied", "post_ln_learned_untied"])
def test_params_round_trip(over):
    _, params, cfg, model = build_pair(**over)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    for tree in (jax_params_from_lm_state_dict(model.state_dict()), jax_params_of(model)):
        flat_b = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[path], leaf)
    sd = lm_state_dict_from_jax(jax_params_from_lm_state_dict(model.state_dict()))
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def _word_dicts(words):
    j, p = JDictionary(), Dictionary()
    for w in words:
        j.add_symbol(w)
        p.add_symbol(w)
    return j, p


def test_neural_lm_scorer_matches_jax():
    """The port's scorer and the JAX one on the same weights: every state's
    log-probs (rtol 1e-5 / atol 1e-5), the state tuples, the sentence-end
    score, and a prefix longer than the window (its last ``window`` words)."""
    words = ["ab", "ad", "ba", "bad", "dab"]
    jd, pd = _word_dicts(words)
    _, params, cfg, model = build_pair(vocab=len(pd))
    jcfg = jlm.TransformerLMConfig(**{**TINY, "vocab_size": len(pd)})
    js = JNeuralLMScorer(params, jcfg, jd, window=6)
    ps = NeuralLMScorer(model, pd, window=6)
    jst, pst = js.start(), ps.start()
    assert jst == pst
    for w in ["ab", "bad", "zzz", "ad", "ba", "dab", "ab", "ad"]:
        jst, jsc = js.score(jst, w)
        pst, psc = ps.score(pst, w)
        assert jst == pst
        np.testing.assert_allclose(psc, jsc, rtol=1e-5, atol=1e-5, err_msg=w)
        np.testing.assert_allclose(ps._next_logprobs(pst), js._next_logprobs(jst), rtol=1e-5,
                                   atol=1e-5)
    assert len(pst) > 6
    np.testing.assert_allclose(ps.finish(pst), js.finish(jst), rtol=1e-5, atol=1e-5)
    assert pst in ps._cache


def _fusion_case(units):
    """The fusion case of tests/test_lm_beam.py: a lexicon beam over four
    frames whose second letter is ambiguous, the acoustics slightly for d."""
    sil = units.index("|")
    ia, ib, idd = units.index("a"), units.index("b"), units.index("d")
    em = np.full((4, len(units)), -8.0, np.float32)
    em[0, ia] = -0.1
    em[1, ib] = -0.8
    em[1, idd] = -0.6
    em[2, sil] = -0.1
    em[3, units.blank()] = -0.1
    return em, sil, {"ab": [[ia, ib]], "ad": [[ia, idd]]}


@pytest.mark.parametrize("lm_weight", [0.0, 0.5, 5.0])
def test_fusion_decode_matches_jax(lm_weight):
    """The CTC lexicon beam with the neural LM fused: the port's decoder and
    scorer give the JAX package's n-best words and scores (rtol 1e-5); with
    an LM that loves "ab" (tests/test_lm_beam.py's biased scorer) the fused
    decode turns from "ad" to "ab" in both."""
    ju, pu = _word_dicts(["|", "a", "b", "d"])
    em, sil, lexicon = _fusion_case(pu)
    jw, pw = _word_dicts(["ab", "ad"])
    _, params, _, model = build_pair(vocab=len(pw), seed=3)
    jcfg = jlm.TransformerLMConfig(**{**TINY, "vocab_size": len(pw)})
    kw = dict(beam=8, silence_id=sil, lexicon=lexicon, lm_weight=lm_weight, word_score=0.0)
    jn = JCtcBeamDecoder(blank_id=ju.blank(), lm=JNeuralLMScorer(params, jcfg, jw, window=8),
                         **kw).decode(em)
    pn = CtcBeamDecoder(blank_id=pu.blank(), lm=NeuralLMScorer(model, pw, window=8),
                        **kw).decode(em)
    assert [h[1] for h in pn] == [h[1] for h in jn] and pn
    np.testing.assert_allclose([h[2] for h in pn], [h[2] for h in jn], rtol=1e-5)

    def biased(cls):
        class Biased(cls):
            def _next_logprobs(self, state):
                lp = np.full((len(pw),), -10.0, np.float32)
                lp[pw.index("ab")] = -0.01
                return lp
        return Biased

    jb = JCtcBeamDecoder(blank_id=ju.blank(),
                         lm=biased(JNeuralLMScorer)(params, jcfg, jw, window=8), **kw)
    pb = CtcBeamDecoder(blank_id=pu.blank(), lm=biased(NeuralLMScorer)(model, pw, window=8),
                        **kw)
    want = ["ab"] if lm_weight > 0 else ["ad"]
    assert pb.decode(em)[0][1] == jb.decode(em)[0][1] == want


def test_load_neural_lm_reads_the_export_and_the_config_fallback(tmp_path):
    """A JAX-layout .npz with ``<stem>.json`` beside it, or only
    ``lm_config.json`` in its directory, loads into the port's scorer with
    the JAX scorer's log-probs."""
    words = ["ab", "ad", "ba"]
    jd, pd = _word_dicts(words)
    _, params, cfg, _ = build_pair(vocab=len(pd), seed=4)
    pd.save(str(tmp_path / "words.txt"))
    keys = ("vocab_size", "embed_dim", "ffn_dim", "layers", "heads", "dropout",
            "padding_idx", "max_positions", "learned_pos", "normalize_before",
            "share_input_output_embed")
    cfg_json = json.dumps({k: getattr(cfg, k) for k in keys})
    jcfg = jlm.TransformerLMConfig(**json.loads(cfg_json))
    js = JNeuralLMScorer(params, jcfg, jd, window=16)
    for sub, cfg_name in (("a", "lm.json"), ("b", "lm_config.json")):
        (tmp_path / sub).mkdir()
        save_params_npz(str(tmp_path / sub / "lm.npz"), params)
        (tmp_path / sub / cfg_name).write_text(cfg_json)
        ps = load_neural_lm(str(tmp_path / sub / "lm.npz"), str(tmp_path / "words.txt"),
                            window=16, device="cpu")
        st = ps.start()
        for w in ["ba", "ab"]:
            np.testing.assert_allclose(ps._next_logprobs(st), js._next_logprobs(st),
                                       rtol=1e-5, atol=1e-5)
            st, _ = ps.score(st, w)
