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


def test_decode_cli_not_ported_and_device(decode_setup):
    from unispeech_tpu_torch.decode.__main__ import main as torch_decode

    d = decode_setup
    for dec in ("neural", "seq2seq"):
        with pytest.raises(NotImplementedError):
            torch_decode(_decode_args(d, "viterbi", "x", "--checkpoint",
                                      str(d / "ctc_a.npz"), "--decoder", dec, "--device",
                                      "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_decode(_decode_args(d, "viterbi", "x", "--checkpoint",
                                      str(d / "ctc_a.npz")))


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
