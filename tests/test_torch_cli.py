"""``python -m unispeech_tpu_torch.tools dump-features --feature model`` against
the JAX CLI on the same manifest and params .npz (CPU).

Both CLIs run the model in bf16, with bf16 rounding at different points (the
JAX CPU path rounds each stride-collapsed conv matmul, the port accumulates
each fused conv in fp32 and rounds once; the GEMM libraries differ). bf16
keeps 8 significant bits, a relative rounding error of up to 2**-9 per
operation, and a few layers of such differences give a relative L2 error of
a few 1e-3; the features are held at relative L2 <= 2e-2.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.configs import WavLMModelConfig as JaxWavLMConfig
from unispeech_tpu.configs import base_encoder_config, large_encoder_config
from unispeech_tpu.models.wavlm import WavLM as JaxWavLM
from unispeech_tpu.tools.__main__ import main as jax_main
from unispeech_tpu.train.checkpoint import save_params_npz
from unispeech_tpu_torch.tools.__main__ import main as torch_main

TINY = dict(
    encoder_layers=3, encoder_embed_dim=96, encoder_ffn_embed_dim=192,
    encoder_attention_heads=4, conv_layers=[[64, 10, 5], [64, 3, 2], [64, 3, 2]],
    conv_pos=16, conv_pos_groups=4, num_buckets=32, max_distance=64,
)


def _write_wav(path, samples, rate=16000):
    import wave

    pcm = np.clip(samples * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


@pytest.fixture
def wavs(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for i, n in enumerate((3000, 4200, 5100)):
        _write_wav(tmp_path / f"u{i}.wav", rng.standard_normal(n) * 0.1)
        rows.append(f"u{i}.wav\t{n}")
    (tmp_path / "train.tsv").write_text(f"{tmp_path}\n" + "\n".join(rows) + "\n")
    return tmp_path


def _export(tmp_path, enc_fn):
    """A JAX checkpoint of the tiny model that ``--arch`` with TINY builds."""
    enc = enc_fn(
        relative_position_embedding=True, gru_rel_pos=True, dropout=0.0,
        attention_dropout=0.0, encoder_layerdrop=0.0,
        **{k: tuple(map(tuple, v)) if k == "conv_layers" else v for k, v in TINY.items()})
    model = JaxWavLM(JaxWavLMConfig(encoder=enc))
    params = model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4000)))["params"]
    save_params_npz(str(tmp_path / "params.npz"), params)
    return tmp_path


@pytest.fixture
def setup(wavs):
    return _export(wavs, base_encoder_config)


def _args(d, feat_dir, *extra):
    return ["dump-features", "--manifest", str(d / "train.tsv"), "--feat-dir",
            str(d / feat_dir), "--feature", "model", "--checkpoint",
            str(d / "params.npz"), "--encoder-json", json.dumps(TINY), "--layer", "2",
            *extra]


def test_dump_features_matches_jax(setup):
    _dump_and_compare(setup)


def test_dump_features_matches_jax_large(wavs):
    """``--arch large``: WavLM-Large's config (layer_norm extractor, pre-LN,
    normalized input) made tiny by ``--encoder-json``, on a checkpoint the
    JAX package exported."""
    _dump_and_compare(_export(wavs, large_encoder_config), "--arch", "large")


def _dump_and_compare(d, *extra):
    jax_main(_args(d, "jax", *extra))
    torch_main(_args(d, "torch", *extra, "--device", "cpu"))
    assert (d / "jax" / "train_0_1.len").read_text() == (
        d / "torch" / "train_0_1.len").read_text()
    want = np.load(d / "jax" / "train_0_1.npy")
    got = np.load(d / "torch" / "train_0_1.npy")
    assert got.shape == want.shape and got.dtype == np.float32
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 2e-2, rel


def test_default_device_needs_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(_args(setup, "torch"))


def test_manifest_and_audio_match_jax(wavs):
    """The port's copy of the manifest reader and audio loader, on plain wav
    paths and on a "zip:offset:length" slice of a stored zip member."""
    import struct
    import zipfile

    from unispeech_tpu.data.manifest import Manifest as JaxManifest
    from unispeech_tpu.data.manifest import load_audio as jax_load_audio
    from unispeech_tpu_torch.data.manifest import Manifest, load_audio

    man, jman = Manifest.load(str(wavs / "train.tsv")), JaxManifest.load(str(wavs / "train.tsv"))
    assert (man.root, man.paths, man.sizes.tolist()) == (
        jman.root, jman.paths, jman.sizes.tolist())
    for i in range(len(man)):
        np.testing.assert_array_equal(load_audio(man.abspath(i)),
                                      jax_load_audio(jman.abspath(i)))

    zpath = wavs / "shard.zip"
    with zipfile.ZipFile(zpath, "w", compression=zipfile.ZIP_STORED) as z:
        z.write(wavs / "u1.wav", "u1.wav")
        info = z.getinfo("u1.wav")
    with open(zpath, "rb") as f:  # data starts after the member's local header
        f.seek(info.header_offset + 26)
        name_len, extra_len = struct.unpack("<HH", f.read(4))
    sliced = f"{zpath}:{info.header_offset + 30 + name_len + extra_len}:{info.file_size}"
    np.testing.assert_array_equal(load_audio(sliced), jax_load_audio(sliced))
    np.testing.assert_array_equal(load_audio(sliced), load_audio(str(wavs / "u1.wav")))


# ------------------------------------------------------------ CTC fine-tuning
CTC_TINY = dict(
    encoder_layers=2, encoder_embed_dim=96, encoder_ffn_embed_dim=192,
    encoder_attention_heads=4,
    conv_layers=[[64, 10, 5], [64, 3, 2], [64, 3, 2], [64, 2, 2], [64, 2, 2], [64, 2, 2]],
    conv_pos=16, conv_pos_groups=4, num_buckets=32, max_distance=64,
)
# each utterance's best path spells these words (letters, "|" after a word)
HYP_WORDS = ["AB BA", "CAB AB BE", "ACE BA CAB"]
REFS = ["A B | B A |", "C A B | A B | B A |", "A C E | C A B |"]
# spellings without the boundary: the decoder ends a word at "|" before it
# walks the trie, in both packages, so a spelling ending in "|" never completes
LEXICON = {"AB": "A B", "BA": "B A", "CAB": "C A B", "BE": "B E", "ACE": "A C E",
           "BEE": "B E E"}
CTC_ARPA = """\
\\data\\
ngram 1=7
ngram 2=2

\\1-grams:
-1.0\t<s>\t-0.3
-1.0\t</s>
-0.7\tAB\t-0.2
-0.8\tBA\t-0.2
-0.9\tCAB\t-0.2
-1.0\tBE\t-0.2
-1.1\tACE\t-0.2

\\2-grams:
-0.2\t<s> AB
-0.3\tAB BA

\\end\\
"""


def _ctc_enc(fn=base_encoder_config):
    return fn(relative_position_embedding=True, gru_rel_pos=True, dropout=0.0,
              attention_dropout=0.0, activation_dropout=0.0, encoder_layerdrop=0.0,
              **{k: tuple(map(tuple, v)) if k == "conv_layers" else v
                 for k, v in CTC_TINY.items()})


@pytest.fixture(scope="module")
def decode_setup(tmp_path_factory):
    """Three utterances, their transcripts, a lexicon and an ARPA LM, and
    two CTC checkpoints in the JAX package's layout whose heads make each
    utterance's best path spell HYP_WORDS by a wide margin: the encoder
    output h of the frames the decode CLI batches (fp32, from a JAX init)
    is mapped by a least-squares fit (fewer frames than features, so exact)
    to logits of M on the chosen unit and 0 elsewhere. bf16 moves h by
    ~1e-2 relative, far less than the margin, so the JAX and the port CLI
    must find the same paths."""
    from unispeech_tpu.models.ctc import CtcFinetuneConfig as JCtcConfig
    from unispeech_tpu.models.ctc import CtcFinetuneModel as JCtcModel
    from unispeech_tpu_torch.configs import base_encoder_config as port_base
    from unispeech_tpu_torch.convert.from_jax import ctc_state_dict_from_jax
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.data.manifest import Manifest, load_audio
    from unispeech_tpu_torch.decode.__main__ import bucket_grid, plan_eval_batches
    from unispeech_tpu_torch.models.ctc import CtcFinetuneConfig, CtcFinetuneModel

    d_path = tmp_path_factory.mktemp("decode")
    rng = np.random.default_rng(0)
    rows = []
    for i, n in enumerate((3000, 4200, 5100)):
        _write_wav(d_path / f"u{i}.wav", rng.standard_normal(n) * 0.1)
        rows.append(f"u{i}.wav\t{n}")
    (d_path / "test.tsv").write_text(f"{d_path}\n" + "\n".join(rows) + "\n")
    (d_path / "test.ltr").write_text("\n".join(REFS) + "\n")
    (d_path / "lexicon.txt").write_text("".join(f"{w}\t{u}\n" for w, u in LEXICON.items()))
    (d_path / "lm.arpa").write_text(CTC_ARPA)

    d = Dictionary.letters()
    jenc = _ctc_enc()
    jmodel = JCtcModel(JCtcConfig(encoder=jenc, vocab_size=len(d), apply_mask=False))
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4000)),
                         deterministic=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    enc = _ctc_enc(port_base)
    model = CtcFinetuneModel(CtcFinetuneConfig(encoder=enc, vocab_size=len(d),
                                               apply_mask=False))
    model.load_state_dict(ctc_state_dict_from_jax(params, enc), strict=True)

    man = Manifest.load(str(d_path / "test.tsv"))
    sizes = np.asarray(man.sizes)
    buckets = bucket_grid(sizes)
    feats, targets = [], []
    for batch_idx in plan_eval_batches(sizes, 1_280_000, 0, buckets):
        wavs = [load_audio(man.abspath(int(i)), 16_000) for i in batch_idx]
        lengths = np.asarray([len(w) for w in wavs], np.int32)
        source = np.zeros((len(wavs), int(buckets[np.searchsorted(buckets, lengths.max())])),
                          np.float32)
        for r, w in enumerate(wavs):
            source[r, :len(w)] = w
        with torch.no_grad():
            out = model.wavlm(torch.from_numpy(source), torch.from_numpy(lengths))
        n_frames = (~out.padding_mask).sum(-1)
        for r, i in enumerate(batch_idx):
            units = [d.index(u) for w in HYP_WORDS[i].split() for u in list(w) + ["|"]]
            path = np.zeros(int(n_frames[r]), np.int64)  # blank
            path[:2 * len(units)] = np.repeat(units, 2)
            feats.append(out.x[r, :int(n_frames[r])].numpy())
            targets.append(path)
    H = np.concatenate(feats).astype(np.float64)
    H = np.concatenate([H, np.ones((len(H), 1))], axis=1)
    assert H.shape[0] < H.shape[1]  # an exact fit
    onehot = np.eye(len(d))[np.concatenate(targets)]
    for name, margin in (("ctc_a.npz", 8.0), ("ctc_b.npz", 6.0)):
        w = np.linalg.lstsq(H, margin * onehot, rcond=None)[0].astype(np.float32)
        ckpt = dict(params, proj={"kernel": w[:-1], "bias": w[-1]})
        save_params_npz(str(d_path / name), ckpt)

    # a word-level TransformerLM (JAX init, seed 5) over the lexicon's words,
    # with its config beside the export, for --decoder neural
    from unispeech_tpu.models.lm import TransformerLM as JLM
    from unispeech_tpu.models.lm import TransformerLMConfig as JLMConfig

    words = Dictionary()
    for w in LEXICON:
        words.add_symbol(w)
    words.save(str(d_path / "words.txt"))
    lm_cfg = dict(vocab_size=len(words), embed_dim=32, ffn_dim=64, layers=2, heads=2,
                  dropout=0.0, padding_idx=1, max_positions=256, learned_pos=False,
                  normalize_before=True, share_input_output_embed=True)
    lm_params = JLM(JLMConfig(**lm_cfg)).init(jax.random.PRNGKey(5),
                                             jnp.zeros((1, 8), jnp.int32))["params"]
    save_params_npz(str(d_path / "lm.npz"), lm_params)
    (d_path / "lm.json").write_text(json.dumps(lm_cfg))
    return d_path


def _decode_args(d, decoder, out, *extra):
    args = ["--manifest", str(d / "test.tsv"), "--transcripts", str(d / "test.ltr"),
            "--encoder-json", json.dumps(CTC_TINY), "--results-path", str(d / out),
            "--decoder", decoder, *extra]
    if decoder != "viterbi":
        args += ["--lexicon", str(d / "lexicon.txt"), "--beam", "8"]
    if decoder == "kenlm":
        args += ["--lm-model", str(d / "lm.arpa")]
    return args


@pytest.mark.parametrize("lm_weight", ["0.5", "2.0"])
def test_neural_decode_cli_matches_jax(decode_setup, lm_weight):
    """decode --decoder neural (the lexicon beam with the TransformerLM
    fused) against the JAX decode CLI on the same CTC checkpoint and LM
    export: the same hypothesis and reference files and WER/UER."""
    from unispeech_tpu.decode.__main__ import main as jax_decode
    from unispeech_tpu_torch.decode.__main__ import main as torch_decode

    d = decode_setup
    extra = ["--checkpoint", str(d / "ctc_a.npz"), "--lm-model", str(d / "lm.npz"),
             "--lm-dict", str(d / "words.txt"), "--lm-weight", lm_weight]
    tag = f"neural_{lm_weight}"
    jax_decode(_decode_args(d, "neural", f"jax_{tag}", *extra))
    torch_decode(_decode_args(d, "neural", f"port_{tag}", *extra, "--device", "cpu"))
    for name in ("hypo.units", "hypo.word", "ref.units", "ref.word"):
        assert (d / f"port_{tag}" / name).read_text() == (d / f"jax_{tag}" / name).read_text()
    rep = json.loads((d / f"port_{tag}" / "wer_report.json").read_text())
    jrep = json.loads((d / f"jax_{tag}" / "wer_report.json").read_text())
    assert (rep["utterances"], rep["wer"], rep["uer"]) == (
        jrep["utterances"], jrep["wer"], jrep["uer"])


S2S_DEC = dict(embed_dim=64, ffn_embed_dim=128, layers=2, heads=4, learned_pos=True)
S2S_HYPS = ["AAAA", "BBBB", "CCCC"]  # the planted hypotheses, one letter per utterance


def _s2s_args(d):
    return ["--checkpoint", str(d / "s2s.npz"), "--decoder-json", json.dumps(S2S_DEC),
            "--seq2seq-beam", "3", "--max-decode-len", "8"]


@pytest.fixture(scope="module")
def seq2seq_export(decode_setup):
    """A seq2seq export in the JAX layout (JAX init, CTC_TINY's encoder 96
    wide, a decoder 64 wide with learned positions, so enc_proj) planted to
    decode utterance u as its letter of S2S_HYPS four times, then eos, by a
    wide margin. A random decoder's last hidden state is led by the current
    token; position and audio reach it weakly. So the export carries
    N(0, 1) position embeddings, identity cross-attention value and output
    projections, and an ``enc_proj`` fitted by least squares (exact: fewer
    frames than features) to map every valid frame of utterance u to one
    code vector c_u (orthogonal, norm 8): the cross-attention then returns
    c_u whatever its weights. The planted next token is a sum of a per
    utterance term and a per position term (the letter, then eos at
    position 4), which a ridge fit (lambda 0.1) of the output embedding to
    the fp32 hidden states realises with logit margins of ~9 and small
    weights: bf16 moves the logits far less, so the JAX and the port CLI
    must find the same beams."""
    from unispeech_tpu.models.seq2seq import Seq2SeqConfig as JConfig
    from unispeech_tpu.models.seq2seq import Seq2SeqDecoderConfig as JDecConfig
    from unispeech_tpu.models.seq2seq import Seq2SeqModel as JModel
    from unispeech_tpu_torch.configs import base_encoder_config as port_base
    from unispeech_tpu_torch.convert.from_jax import seq2seq_state_dict_from_jax
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.data.manifest import Manifest, load_audio
    from unispeech_tpu_torch.decode.__main__ import bucket_grid, plan_eval_batches
    from unispeech_tpu_torch.models import seq2seq

    d_path = decode_setup
    d = Dictionary.letters()
    dec = dict(S2S_DEC, vocab_size=len(d), padding_idx=d.pad())
    D = dec["embed_dim"]
    jmodel = JModel(JConfig(encoder=_ctc_enc(), decoder=JDecConfig(**dec), apply_mask=False))
    params = jmodel.init({"params": jax.random.PRNGKey(6)}, jnp.zeros((1, 4000)),
                         jnp.zeros((1, 8), jnp.int32), deterministic=True)["params"]
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(7)
    dp = params["decoder"]
    dp["embed_positions"]["embedding"] = rng.standard_normal(
        dp["embed_positions"]["embedding"].shape).astype(np.float32)
    for i in range(dec["layers"]):
        for proj in ("v_proj", "out_proj"):
            dp[f"layer_{i}"]["encoder_attn"][proj] = {"kernel": np.eye(D, dtype=np.float32),
                                                      "bias": np.zeros(D, np.float32)}
    enc = _ctc_enc(port_base)
    cfg = seq2seq.Seq2SeqConfig(encoder=enc, decoder=seq2seq.Seq2SeqDecoderConfig(**dec),
                                apply_mask=False)

    def port_model():
        model = seq2seq.Seq2SeqModel(cfg)
        model.load_state_dict(seq2seq_state_dict_from_jax(params, enc), strict=True)
        model.decoder.output_layer = lambda x: x.float()  # the last hidden state
        return model

    man = Manifest.load(str(d_path / "test.tsv"))
    sizes = np.asarray(man.sizes)
    buckets = bucket_grid(sizes)
    batches = []
    for batch_idx in plan_eval_batches(sizes, 1_280_000, 0, buckets):
        wavs = [load_audio(man.abspath(int(i)), 16_000) for i in batch_idx]
        lengths = np.asarray([len(w) for w in wavs], np.int32)
        source = np.zeros((len(wavs), int(buckets[np.searchsorted(buckets, lengths.max())])),
                          np.float32)
        for r, w in enumerate(wavs):
            source[r, :len(w)] = w
        batches.append((batch_idx, torch.from_numpy(source), torch.from_numpy(lengths)))
    codes = np.linalg.qr(rng.standard_normal((D, len(S2S_HYPS))))[0].T * 8.0
    model = port_model()
    H, C = [], []
    for batch_idx, source, lengths in batches:
        with torch.no_grad():
            out = model.wavlm(source, lengths)
        n_frames = (~out.padding_mask).sum(-1)
        for r, i in enumerate(batch_idx):
            H.append(out.x[r, :int(n_frames[r])].numpy())
            C += [codes[i]] * int(n_frames[r])
    H = np.concatenate(H).astype(np.float64)
    H = np.concatenate([H, np.ones((len(H), 1))], axis=1)
    assert H.shape[0] < H.shape[1]  # an exact fit
    P = np.linalg.lstsq(H, np.asarray(C), rcond=None)[0].astype(np.float32)
    params["enc_proj"] = {"kernel": P[:-1], "bias": P[-1]}
    model = port_model()
    X, Y = [], []
    for batch_idx, source, lengths in batches:
        with torch.no_grad():
            h, pad, _ = model.encode(source, lengths)
            for r, i in enumerate(batch_idx):
                units = [d.index(S2S_HYPS[i][0])] * 4 + [d.eos()]
                prev = torch.tensor([[d.eos()] + units[:-1]])
                X.append(model.decoder(prev, h[r:r + 1], pad[r:r + 1])[0].numpy())
                Y += units
    X = np.concatenate(X).astype(np.float64)
    target = 20.0 * np.eye(len(d))[Y]
    w = np.linalg.solve(X.T @ X + 0.1 * np.eye(D), X.T @ target)
    logits = X @ w
    margin = logits[np.arange(len(Y)), Y] - np.where(np.eye(len(d))[Y] > 0, -np.inf,
                                                     logits).max(1)
    assert margin.min() > 5.0, margin
    dp["embed_out"] = np.ascontiguousarray(w.T.astype(np.float32))
    save_params_npz(str(d_path / "s2s.npz"), params)
    return d_path


@pytest.mark.parametrize("ngram", ["0", "4"])
def test_seq2seq_decode_cli_matches_jax(seq2seq_export, ngram):
    """decode --decoder seq2seq (beam 3; no-repeat-ngram 0, or 4, which
    bans a fifth repeat of a letter but not the planted eos) of a
    JAX-written export: the port's CLI gives the JAX CLI's hypotheses,
    the planted ones, and its WER report."""
    from unispeech_tpu.decode.__main__ import main as jax_decode
    from unispeech_tpu_torch.decode.__main__ import main as torch_decode

    d = seq2seq_export
    extra = [*_s2s_args(d), "--no-repeat-ngram", ngram]
    tag = f"s2s_{ngram}"
    jax_decode(_decode_args(d, "seq2seq", f"jax_{tag}", *extra))
    torch_decode(_decode_args(d, "seq2seq", f"port_{tag}", *extra, "--device", "cpu"))
    got = (d / f"port_{tag}" / "hypo.word").read_text()
    assert got == (d / f"jax_{tag}" / "hypo.word").read_text()
    hyps = sorted(got.splitlines(), key=lambda l: int(l.rsplit("(", 1)[1][:-1]))
    assert [h.rsplit(" (", 1)[0] for h in hyps] == S2S_HYPS
    rep = json.loads((d / f"port_{tag}" / "wer_report.json").read_text())
    jrep = json.loads((d / f"jax_{tag}" / "wer_report.json").read_text())
    assert (rep["utterances"], rep["wer"], rep["uer"]) == (
        jrep["utterances"], jrep["wer"], jrep["uer"])
    assert rep["wer"] == 100.0  # one word against each reference's 2-3




@pytest.mark.parametrize("decoder,ensemble", [("viterbi", False), ("beam", False),
                                              ("kenlm", False), ("viterbi", True)],
                         ids=["viterbi", "beam_lexicon", "kenlm_arpa", "ensemble"])
def test_decode_cli_matches_jax(decode_setup, decoder, ensemble, capsys):
    """``python -m unispeech_tpu_torch.decode --device cpu`` against the JAX
    decode CLI on the same checkpoint(s): the same hypothesis and reference
    files, line for line, and the same WER/UER."""
    from unispeech_tpu.decode.__main__ import main as jax_decode
    from unispeech_tpu_torch.decode.__main__ import main as torch_decode

    d = decode_setup
    ckpts = [str(d / "ctc_a.npz")] + ([str(d / "ctc_b.npz")] if ensemble else [])
    tag = f"{decoder}{'_ens' if ensemble else ''}"
    jax_decode(_decode_args(d, decoder, f"jax_{tag}", "--checkpoint", *ckpts))
    torch_decode(_decode_args(d, decoder, f"port_{tag}", "--checkpoint", *ckpts,
                              "--device", "cpu"))
    for name in ("hypo.units", "hypo.word", "ref.units", "ref.word"):
        assert (d / f"port_{tag}" / name).read_text() == (d / f"jax_{tag}" / name).read_text()
    hyps = sorted((d / f"port_{tag}" / "hypo.word").read_text().splitlines(),
                  key=lambda l: int(l.rsplit("(", 1)[1][:-1]))
    assert [h.rsplit(" (", 1)[0] for h in hyps] == HYP_WORDS  # the planted best paths
    rep = json.loads((d / f"port_{tag}" / "wer_report.json").read_text())
    jrep = json.loads((d / f"jax_{tag}" / "wer_report.json").read_text())
    assert (rep["utterances"], rep["wer"], rep["uer"]) == (
        jrep["utterances"], jrep["wer"], jrep["uer"])
    # one substitution and one insertion against 7 reference words
    assert rep["utterances"] == 3 and rep["wer"] == round(200 / 7, 4) and rep["uer"] > 0


def test_decode_cli_not_ported_and_device(decode_setup, seq2seq_export):
    """The neural-LM and seq2seq decoders run with --device cpu (one
    hypothesis per utterance and a WER report); every decoder without
    --device needs a CUDA device."""
    from unispeech_tpu_torch.decode.__main__ import main as torch_decode

    d = decode_setup
    for dec, extra in (("neural", ["--checkpoint", str(d / "ctc_a.npz"), "--lm-model",
                                   str(d / "lm.npz"), "--lm-dict", str(d / "words.txt")]),
                       ("seq2seq", _s2s_args(d))):
        torch_decode(_decode_args(d, dec, f"port_run_{dec}", *extra, "--device", "cpu"))
        hyps = (d / f"port_run_{dec}" / "hypo.word").read_text().splitlines()
        rep = json.loads((d / f"port_run_{dec}" / "wer_report.json").read_text())
        assert len(hyps) == rep["utterances"] == 3 and "wer" in rep
    if not torch.cuda.is_available():
        for dec in ("viterbi", "neural", "seq2seq"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                torch_decode(_decode_args(d, dec, "x", "--checkpoint", str(d / "ctc_a.npz")))


def _ft_corpus(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for i, n in enumerate([2000, 2100, 2200, 2300, 2000, 2100, 2200, 2300]):
        _write_wav(tmp_path / f"u{i}.wav", rng.standard_normal(n) * 0.1)
        rows.append(f"u{i}.wav\t{n}")
    (tmp_path / "train.tsv").write_text(f"{tmp_path}\n" + "\n".join(rows) + "\n")
    (tmp_path / "train.ltr").write_text("A |\nB A |\nA B |\nB |\nA |\nB A |\nA B |\nB |\n")
    return tmp_path


FT_TINY = dict(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
               encoder_attention_heads=4, conv_layers=[[32, 10, 5], [32, 3, 2]], conv_pos=16,
               conv_pos_groups=4, num_buckets=32, max_distance=64)


def _ft_args(d, *extra):
    return ["finetune-ctc", "--manifest", str(d / "train.tsv"), "--transcripts",
            str(d / "train.ltr"), "--max-tokens", "30000", "--min-sample-size", "1000",
            "--num-buckets", "2", "--warmup-steps", "2", "--log-interval", "1",
            "--encoder-json", json.dumps(FT_TINY), "--checkpoint-dir", str(d / "ckpt"),
            "--device", "cpu", *extra]


def test_finetune_ctc_cli_valid_wer_drives_best_checkpoint(tmp_path, capsys):
    """finetune-ctc --device cpu with a valid set: WER/UER at each
    validation, --best-metric wer picks the checkpoint (the update-3 save
    carries the update-2 validation's WER), a second call resumes at the
    update-3 checkpoint, and its --export-params file loads into the JAX
    decode CLI."""
    from unispeech_tpu.decode.__main__ import main as jax_decode
    from unispeech_tpu_torch.train.__main__ import main as train_cli
    from unispeech_tpu_torch.train.checkpoint import CheckpointManager

    d = _ft_corpus(tmp_path)
    argv = _ft_args(d, "--valid-manifest", str(d / "train.tsv"), "--valid-transcripts",
                    str(d / "train.ltr"), "--best-metric", "wer", "--save-interval-updates",
                    "3", "--validate-interval-updates", "2", "--freeze-finetune-updates", "1",
                    "--export-params", str(d / "ctc.npz"))
    train_cli(argv + ["--max-updates", "3"])
    train_cli(argv + ["--max-updates", "4"])
    err = capsys.readouterr().err.splitlines()
    train = [json.loads(l) for l in err if l.startswith('{"tag": "train"')]
    valid = [json.loads(l) for l in err if l.startswith('{"tag": "valid"')]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss_avg"]) for r in train)
    assert [r["step"] for r in valid] == [2, 4]
    assert all(0.0 <= r["wer"] and 0.0 <= r["uer"] for r in valid)
    mgr = CheckpointManager(str(d / "ckpt"), best_metric="wer")
    assert mgr.best_step() in (3, 4)
    assert mgr._metrics[3]["wer"] == valid[0]["wer"]

    jax_decode(["--manifest", str(d / "train.tsv"), "--checkpoint", str(d / "ctc.npz"),
                "--encoder-json", json.dumps(FT_TINY), "--results-path", str(d / "dec")])
    assert len((d / "dec" / "hypo.word").read_text().splitlines()) == 8


def test_finetune_ctc_cli_grafts_the_pretrained_export(tmp_path):
    """--w2v-path: the backbone of a pretraining export (JAX layout) is
    grafted before training; with --max-updates 0 the export holds it
    unchanged beside a fresh head."""
    from unispeech_tpu.configs import HubertPretrainConfig as JHubertConfig
    from unispeech_tpu.models.hubert import HubertPretrainModel as JHubert
    from unispeech_tpu_torch.convert.from_jax import load_params_npz
    from unispeech_tpu_torch.train.__main__ import main as train_cli

    d = _ft_corpus(tmp_path)
    jenc = base_encoder_config(relative_position_embedding=True, gru_rel_pos=True,
                               **{k: tuple(map(tuple, v)) if k == "conv_layers" else v
                                  for k, v in FT_TINY.items()})
    jh = JHubert(JHubertConfig(encoder=jenc, num_classes=(10,), final_dim=16))
    k = jax.random.PRNGKey(3)
    pre = jh.init({"params": k, "mask": k}, jnp.zeros((1, 2000)),
                  jnp.zeros((1, jenc.num_frames(2000), 1), jnp.int32), mask=True)["params"]
    save_params_npz(str(d / "pre.npz"), pre)
    train_cli(_ft_args(d, "--w2v-path", str(d / "pre.npz"), "--max-updates", "0",
                       "--export-params", str(d / "ctc.npz")))
    got = load_params_npz(str(d / "ctc.npz"))
    want = load_params_npz(str(d / "pre.npz"))["wavlm"]
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got["wavlm"]))
    assert flat_w.keys() == flat_g.keys()
    for path, leaf in flat_w.items():
        np.testing.assert_array_equal(flat_g[path], leaf)
    assert set(got) == {"wavlm", "proj"} and got["proj"]["kernel"].shape == (64, 32)


# ------------------------------------------------- pretrain-wav2vec2, --sat
@pytest.fixture
def one_torch_thread():
    """The tiny models gain nothing from intra-op threads, and under a
    parallel test run (several worker processes on few cores) OpenMP's
    spinning threads slow these training runs tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W2V_TINY = dict(encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
                encoder_attention_heads=2, conv_layers=[[32, 10, 5], [32, 3, 2], [32, 2, 2]],
                conv_pos=8, conv_pos_groups=2)


def _speech_corpus(d, n, seed):
    """n wav files of 0.5-1.2 s, their manifest and letter transcripts."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows, texts = [], []
    for i in range(n):
        m = int(rng.integers(8000, 19000))
        _write_wav(d / f"u{i}.wav", rng.standard_normal(m) * 0.1)
        rows.append(f"u{i}.wav\t{m}")
        texts.append(" ".join(rng.choice(list("ABCDE"), 6)) + " |")
    (d / "train.tsv").write_text(f"{d}\n" + "\n".join(rows) + "\n")
    (d / "train.ltr").write_text("\n".join(texts) + "\n")
    return d


def _train_records(capsys):
    return [json.loads(line) for line in capsys.readouterr().err.splitlines()
            if line.startswith('{"tag": "train"')]


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("unispeech", [False, True], ids=["wav2vec2", "unispeech_two_langs"])
def test_pretrain_wav2vec2_cli(tmp_path, capsys, unispeech):
    """pretrain-wav2vec2 --device cpu, a tiny --encoder-json: plain
    wav2vec 2.0 on one manifest, and UniSpeech (--mtlalpha 0.5, a letter
    dictionary) on two comma-separated per-language manifests resampled
    with --multilang-alpha 0.5. Every update draws (masks, negatives, Gumbel
    noise), so the run is held by finite losses and the resume: 2 updates,
    then a second call to 3 that starts from the update-2 checkpoint. The
    --export-params file loads into the JAX Wav2Vec2PretrainModel and gives
    the port's encoder output (and CTC logits) at rtol/atol 1e-5, fp32."""
    from unispeech_tpu.configs import Wav2Vec2PretrainConfig as JW2VConfig
    from unispeech_tpu.configs import base_encoder_config as jax_base
    from unispeech_tpu.models.wav2vec2 import Wav2Vec2PretrainModel as JW2V
    from unispeech_tpu.train.checkpoint import load_params_npz
    from unispeech_tpu_torch.configs import Wav2Vec2PretrainConfig
    from unispeech_tpu_torch.configs import base_encoder_config as port_base
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModel
    from unispeech_tpu_torch.train.__main__ import main as train_cli

    langs = [_speech_corpus(tmp_path / f"lang{i}", n, i) for i, n in enumerate((5, 2))]
    argv = ["pretrain-wav2vec2", "--encoder-json", json.dumps(W2V_TINY), "--max-tokens",
            "40000", "--max-sample-size", "20000", "--min-sample-size", "8000",
            "--log-interval", "1", "--save-interval-updates", "2", "--checkpoint-dir",
            str(tmp_path / "ckpt"), "--export-params", str(tmp_path / "export.npz"),
            "--device", "cpu"]
    if unispeech:
        Dictionary.letters().save(str(tmp_path / "dict.txt"))
        argv += ["--manifest", ",".join(str(d / "train.tsv") for d in langs),
                 "--transcripts", ",".join(str(d / "train.ltr") for d in langs),
                 "--mtlalpha", "0.5", "--dict", str(tmp_path / "dict.txt"),
                 "--multilang-alpha", "0.5"]
    else:
        argv += ["--manifest", str(langs[0] / "train.tsv")]
    train_cli(argv + ["--max-updates", "2"])
    train_cli(argv + ["--max-updates", "3"])
    records = _train_records(capsys)
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["loss_avg"]) for r in records)
    assert all(("loss_ctc" in r) == unispeech for r in records)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "3"]

    enc_kw = dict(W2V_TINY, conv_layers=tuple(map(tuple, W2V_TINY["conv_layers"])), dropout=0.0,
                  attention_dropout=0.0)
    vocab = len(Dictionary.letters()) if unispeech else 0
    kw = dict(transpose=unispeech, ctc_vocab_size=vocab)
    cfg = Wav2Vec2PretrainConfig(encoder=port_base(**enc_kw), **kw)
    model = Wav2Vec2PretrainModel(cfg)
    model.load_state_dict(torch.load(tmp_path / "ckpt" / "3" / "state.pt",
                                     weights_only=True)["model"])
    jmodel = JW2V(JW2VConfig(encoder=jax_base(**enc_kw), **kw))
    params = load_params_npz(str(tmp_path / "export.npz"))
    source = np.random.default_rng(9).standard_normal((2, 12000)).astype(np.float32)
    lengths = np.asarray([12000, 9000], np.int32)
    jout = jmodel.apply({"params": params}, jnp.asarray(source), jnp.asarray(lengths),
                        mask=False, deterministic=True, rngs={"negatives": jax.random.PRNGKey(0)})
    with torch.no_grad():
        out = model(torch.from_numpy(source), torch.from_numpy(lengths), mask=False,
                    generator=torch.Generator())
    np.testing.assert_allclose(out.x.numpy(), np.asarray(jout.x), rtol=1e-5, atol=1e-5)
    if unispeech:
        np.testing.assert_allclose(out.ctc_logits.numpy(), np.asarray(jout.ctc_logits),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.usefixtures("one_torch_thread")
def test_pretrain_hubert_sat_cli(tmp_path, capsys):
    """pretrain-hubert --sat --device cpu (one same-utterance and 100
    cross-utterance instances, spk loss weight 0.1, the tap at layer 6 of a
    tiny 6-layer encoder): finite losses with the speaker terms, the resume
    at update 2, and the export in the JAX UniSpeech-SAT model gives the
    port's prediction logits (rtol/atol 1e-5, fp32)."""
    from unispeech_tpu.configs import HubertPretrainConfig as JHubertConfig
    from unispeech_tpu.configs import base_encoder_config as jax_base
    from unispeech_tpu.models.hubert import HubertPretrainModel as JHubert
    from unispeech_tpu.train.checkpoint import load_params_npz
    from unispeech_tpu_torch.configs import HubertPretrainConfig
    from unispeech_tpu_torch.configs import base_encoder_config as port_base
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.train.__main__ import main as train_cli

    d = _speech_corpus(tmp_path / "c", 5, 0)
    sizes = [int(r.split("\t")[1]) for r in (d / "train.tsv").read_text().splitlines()[1:]]
    rng = np.random.default_rng(1)
    (d / "train.km").write_text("\n".join(
        " ".join(map(str, rng.integers(0, 10, 1 + (n - 400) // 320))) for n in sizes) + "\n")
    tiny = dict(W2V_TINY, encoder_layers=6, num_buckets=16, max_distance=32)
    argv = ["pretrain-hubert", "--sat", "--manifest", str(d / "train.tsv"), "--labels",
            str(d / "train.km"), "--num-classes", "10", "--encoder-json", json.dumps(tiny),
            "--max-tokens", "40000", "--max-sample-size", "20000", "--min-sample-size",
            "8000", "--log-interval", "1", "--save-interval-updates", "2",
            "--checkpoint-dir", str(tmp_path / "ckpt"), "--export-params",
            str(tmp_path / "export.npz"), "--device", "cpu"]
    train_cli(argv + ["--max-updates", "2"])
    train_cli(argv + ["--max-updates", "3"])
    records = _train_records(capsys)
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["loss_avg"]) and np.isfinite(r["loss_spk_m"])
               and 0 <= r["contrastive_acc"] <= 1 for r in records)

    enc_kw = dict(tiny, conv_layers=tuple(map(tuple, tiny["conv_layers"])), dropout=0.0,
                  attention_dropout=0.0, encoder_layerdrop=0.0,
                  relative_position_embedding=True, gru_rel_pos=True)
    kw = dict(num_classes=(10,), utterance_contrastive_loss=True, num_instances=1)
    cfg = HubertPretrainConfig(encoder=port_base(**enc_kw), **kw)
    model = HubertPretrainModel(cfg)
    model.load_state_dict(torch.load(tmp_path / "ckpt" / "3" / "state.pt",
                                     weights_only=True)["model"])
    jmodel = JHubert(JHubertConfig(encoder=jax_base(**enc_kw), **kw))
    params = load_params_npz(str(tmp_path / "export.npz"))
    source = np.random.default_rng(9).standard_normal((2, 12000)).astype(np.float32)
    T = cfg.encoder.num_frames(12000)
    targets = np.zeros((2, T, 1), np.int32)
    jout = jmodel.apply({"params": params}, jnp.asarray(source), jnp.asarray(targets),
                        mask=False, deterministic=True, rngs={"instances": jax.random.PRNGKey(0)})
    with torch.no_grad():
        out = model(torch.from_numpy(source), torch.from_numpy(targets), mask=False,
                    generator=torch.Generator())
    for key in jout.logits:
        np.testing.assert_allclose(out.logits[key].numpy(), np.asarray(jout.logits[key]),
                                   rtol=1e-5, atol=1e-5)


def test_pretrain_wav2vec2_default_device_needs_cuda(tmp_path):
    """Without --device cpu the CLI runs on the card, and without one it
    raises rather than fall back to the CPU."""
    from unispeech_tpu_torch.train.__main__ import main as train_cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    d = _speech_corpus(tmp_path / "c", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli(["pretrain-wav2vec2", "--manifest", str(d / "train.tsv"),
                   "--encoder-json", json.dumps(W2V_TINY), "--min-sample-size", "8000",
                   "--checkpoint-dir", str(tmp_path / "ckpt")])


# ------------------------------------------------ finetune-seq2seq, train-lm
@pytest.mark.usefixtures("one_torch_thread")
def test_finetune_seq2seq_cli(tmp_path, capsys):
    """finetune-seq2seq --device cpu from a pretraining export (--w2v-path,
    JAX layout), a decoder narrower than the encoder (enc_proj), a valid set
    scored by greedy WER, --best-metric wer, freeze 1: to update 2, then
    resumed to 4. The export (JAX layout) decodes through the port's and the
    JAX package's decode --decoder seq2seq to the same hypotheses."""
    from unispeech_tpu.configs import HubertPretrainConfig as JHubertConfig
    from unispeech_tpu.decode.__main__ import main as jax_decode
    from unispeech_tpu.models.hubert import HubertPretrainModel as JHubert
    from unispeech_tpu_torch.convert.from_jax import load_params_npz
    from unispeech_tpu_torch.decode.__main__ import main as torch_decode
    from unispeech_tpu_torch.train.__main__ import main as train_cli
    from unispeech_tpu_torch.train.checkpoint import CheckpointManager

    d = _ft_corpus(tmp_path)
    jenc = base_encoder_config(relative_position_embedding=True, gru_rel_pos=True,
                               **{k: tuple(map(tuple, v)) if k == "conv_layers" else v
                                  for k, v in FT_TINY.items()})
    jh = JHubert(JHubertConfig(encoder=jenc, num_classes=(10,), final_dim=16))
    k = jax.random.PRNGKey(3)
    pre = jh.init({"params": k, "mask": k}, jnp.zeros((1, 2000)),
                  jnp.zeros((1, jenc.num_frames(2000), 1), jnp.int32), mask=True)["params"]
    save_params_npz(str(d / "pre.npz"), pre)
    dec_json = json.dumps(dict(embed_dim=48, ffn_embed_dim=96, layers=2, heads=4))
    argv = ["finetune-seq2seq", "--manifest", str(d / "train.tsv"), "--transcripts",
            str(d / "train.ltr"), "--valid-manifest", str(d / "train.tsv"),
            "--valid-transcripts", str(d / "train.ltr"), "--best-metric", "wer",
            "--save-interval-updates", "2", "--validate-interval-updates", "2",
            "--freeze-finetune-updates", "1", "--valid-decode-max-len", "6",
            "--max-tokens", "30000", "--min-sample-size", "1000", "--num-buckets", "2",
            "--warmup-steps", "2", "--log-interval", "1", "--encoder-json",
            json.dumps(FT_TINY), "--decoder-json", dec_json, "--w2v-path",
            str(d / "pre.npz"), "--checkpoint-dir", str(d / "ckpt"), "--export-params",
            str(d / "s2s.npz"), "--device", "cpu"]
    train_cli(argv + ["--max-updates", "2"])
    train_cli(argv + ["--max-updates", "4"])
    err = capsys.readouterr().err.splitlines()
    train = [json.loads(l) for l in err if l.startswith('{"tag": "train"')]
    valid = [json.loads(l) for l in err if l.startswith('{"tag": "valid"')]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss_avg"]) for r in train + valid)
    assert [r["step"] for r in valid] == [2, 4]
    assert all(0.0 <= r["wer"] and 0.0 <= r["uer"] for r in valid)
    assert CheckpointManager(str(d / "ckpt"), best_metric="wer").best_step() in (2, 4)
    got = load_params_npz(str(d / "s2s.npz"))
    assert set(got) == {"wavlm", "decoder", "enc_proj"}
    assert got["enc_proj"]["kernel"].shape == (64, 48)

    args = ["--manifest", str(d / "train.tsv"), "--transcripts", str(d / "train.ltr"),
            "--checkpoint", str(d / "s2s.npz"), "--decoder", "seq2seq", "--encoder-json",
            json.dumps(FT_TINY), "--decoder-json", dec_json, "--seq2seq-beam", "2",
            "--max-decode-len", "6", "--results-path"]
    jax_decode(args + [str(d / "jax_dec")])
    torch_decode(args + [str(d / "port_dec"), "--device", "cpu"])
    hyps = (d / "port_dec" / "hypo.word").read_text()
    assert len(hyps.splitlines()) == 8
    rep = json.loads((d / "port_dec" / "wer_report.json").read_text())
    assert rep["utterances"] == 8 and "wer" in rep and "uer" in rep


@pytest.mark.usefixtures("one_torch_thread")
def test_binarize_train_lm_and_neural_decode_cli(decode_setup, tmp_path, capsys):
    """data binarize-text on a word corpus, then train-lm --device cpu on
    the .bin (3 updates, resumed to 4, --export-params): finite losses, the
    resume, lm_config.json in the checkpoint directory and <stem>.json
    beside the export; the export then drives decode --decoder neural in
    the port and in the JAX package to the same hypotheses."""
    from unispeech_tpu.decode.__main__ import main as jax_decode
    from unispeech_tpu_torch.data.__main__ import main as data_cli
    from unispeech_tpu_torch.decode.__main__ import main as torch_decode
    from unispeech_tpu_torch.train.__main__ import main as train_cli

    d = decode_setup
    rng = np.random.default_rng(8)
    words = list(LEXICON)
    lines = [" ".join(rng.choice(words, int(rng.integers(2, 7)))) for _ in range(120)]
    (tmp_path / "corpus.txt").write_text("\n".join(lines) + "\n")
    data_cli(["binarize-text", "--corpus", str(tmp_path / "corpus.txt"), "--dict",
              str(d / "words.txt"), "--out", str(tmp_path / "bin" / "corpus")])
    argv = ["train-lm", "--corpus", str(tmp_path / "bin" / "corpus.bin"), "--dict",
            str(d / "words.txt"), "--block-size", "16", "--batch-size", "4", "--embed-dim",
            "32", "--ffn-dim", "64", "--layers", "2", "--heads", "2", "--warmup-steps", "2",
            "--lr", "1e-3", "--log-interval", "1", "--save-interval-updates", "3",
            "--checkpoint-dir", str(tmp_path / "ckpt"), "--export-params",
            str(tmp_path / "lm.npz"), "--device", "cpu"]
    train_cli(argv + ["--max-updates", "3"])
    train_cli(argv + ["--max-updates", "4"])
    train = _train_records(capsys)
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss_avg"]) for r in train)
    cfg = json.loads((tmp_path / "lm.json").read_text())
    assert cfg == json.loads((tmp_path / "ckpt" / "lm_config.json").read_text())
    assert cfg["vocab_size"] == len(LEXICON) + 4 and cfg["max_positions"] == 2048

    extra = ["--checkpoint", str(d / "ctc_a.npz"), "--lm-model", str(tmp_path / "lm.npz"),
             "--lm-dict", str(d / "words.txt")]
    jax_decode(_decode_args(d, "neural", str(tmp_path / "jax"), *extra))
    torch_decode(_decode_args(d, "neural", str(tmp_path / "port"), *extra, "--device", "cpu"))
    for name in ("hypo.word", "hypo.units"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert len((tmp_path / "port" / "hypo.word").read_text().splitlines()) == 3
