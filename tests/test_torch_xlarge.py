"""HuBERT X-Large's structure (head dim 80) in the port against the JAX
package, on the CPU: the CTC fine-tuning model at a narrow width, its train
step, the converters at X-Large's full width, and the finetune-ctc and
decode CLIs through ``--arch large --encoder-json``.

HuBERT X-Large (fairseq ``hubert_xlarge_lv60k.yaml``, the
``hubert_xlarge_ll60k_finetune_ls960`` release) is WavLM-Large's structure
(layer_norm extractor, pre-LN, normalized input) at 48 layers, width 1280,
FFN 5120 and 16 heads of 80, without the relative position bias. The narrow
model keeps the head dim and the structure: width 160 in 2 heads of 80, FFN
320, 2 layers, the positional conv in groups of 80 channels.

Tolerances: fp32 model outputs and a train step as tests/test_torch_ctc.py
states them (logits rtol/atol 1e-5; loss rtol 1e-5, gradient norm rtol
1e-4, each tensor's gradient relative L2 1e-4 + 1e-6 of the global norm).
The CLIs run in bf16 on both sides: the decode CLI's hypotheses are planted
far beyond bf16 noise (as tests/test_torch_cli.py plants them), so they
must agree exactly; the fine-tuning CLI's valid loss is held at relative
2e-2 (bf16 rounds at other places in the two packages, 8 significant bits
through 2 layers, the CTC loss summed over the frames of 8 utterances).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.configs import large_encoder_config as jax_large
from unispeech_tpu.models.ctc import CtcFinetuneConfig as JCtcConfig
from unispeech_tpu.models.ctc import CtcFinetuneModel as JCtcModel
from unispeech_tpu.train import optim as joptim
from unispeech_tpu.train.checkpoint import save_params_npz
from unispeech_tpu.train.state import create_train_state as jax_create_state
from unispeech_tpu.train.state import make_train_step as jax_make_step
from unispeech_tpu.train.tasks import make_ctc_finetune_loss_fn as jax_make_loss_fn
from unispeech_tpu_torch.configs import large_encoder_config
from unispeech_tpu_torch.convert.from_jax import (
    ctc_state_dict_from_jax,
    jax_params_from_ctc_state_dict,
)
from unispeech_tpu_torch.models.ctc import CtcFinetuneConfig, CtcFinetuneModel
from unispeech_tpu_torch.train import optim
from unispeech_tpu_torch.train.state import create_train_state, make_train_step
from unispeech_tpu_torch.train.tasks import make_ctc_finetune_loss_fn

# the --encoder-json of HuBERT X-Large, and of its narrow stand-in (the conv
# stack of tests/test_torch_cli.py's CTC models: 160 samples per frame)
XLARGE = dict(encoder_layers=48, encoder_embed_dim=1280, encoder_ffn_embed_dim=5120,
              encoder_attention_heads=16, relative_position_embedding=False,
              gru_rel_pos=False)
XL_NARROW = dict(
    XLARGE, encoder_layers=2, encoder_embed_dim=160, encoder_ffn_embed_dim=320,
    encoder_attention_heads=2, conv_pos=16, conv_pos_groups=2,
    conv_layers=[[64, 10, 5], [64, 3, 2], [64, 3, 2], [64, 2, 2], [64, 2, 2], [64, 2, 2]])
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                  encoder_layerdrop=0.0)
VOCAB = 12
B, NS = 3, 4000
LENGTHS = np.asarray([4000, 3100, 2300], np.int32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny models gain nothing from intra-op threads (see test_torch_train)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _over(d):
    return {k: tuple(map(tuple, v)) if k == "conv_layers" else v for k, v in d.items()}


def to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def build_pair(**over):
    """The narrow X-Large CTC model, JAX-initialised (seed 0, fp32) and
    carried into the port by the converter with a strict load."""
    enc_kw = dict(_over(XL_NARROW), **NO_DROPOUT)
    kw = {"vocab_size": VOCAB, "apply_mask": False, **over}
    jcfg = JCtcConfig(encoder=jax_large(**enc_kw), **kw)
    cfg = CtcFinetuneConfig(encoder=large_encoder_config(**enc_kw), **kw)
    assert cfg.encoder.encoder_embed_dim // cfg.encoder.encoder_attention_heads == 80
    jmodel = JCtcModel(jcfg)
    k = jax.random.PRNGKey(0)
    params = to_numpy(jmodel.init({"params": k, "mask": k, "dropout": k},
                                  jnp.zeros((1, NS)), deterministic=True)["params"])
    model = CtcFinetuneModel(cfg)
    model.load_state_dict(ctc_state_dict_from_jax(params, cfg.encoder), strict=True)
    return jmodel, params, cfg, model


def batch(seed=0, S=6):
    rng = np.random.RandomState(seed)
    return {"source": rng.randn(B, NS).astype(np.float32), "lengths": LENGTHS,
            "labels": rng.randint(4, VOCAB, (B, S)).astype(np.int32),
            "label_lengths": np.asarray([S, 4, 3], np.int32)}


def test_xlarge_narrow_logits_match_jax():
    jmodel, params, cfg, model = build_pair()
    b = batch()
    jout = jmodel.apply({"params": params}, jnp.asarray(b["source"]),
                        jnp.asarray(b["lengths"]), deterministic=True)
    with torch.no_grad():
        out = model(torch.from_numpy(b["source"]), torch.from_numpy(b["lengths"]))
    np.testing.assert_array_equal(out.frame_lengths.numpy(), np.asarray(jout.frame_lengths))
    assert len(set(out.frame_lengths.tolist())) == B  # the batch is padded
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits), rtol=1e-5,
                               atol=1e-5)


def test_xlarge_narrow_train_step_matches_jax():
    """One unfrozen make_train_step step against JAX's: loss, gradient norm
    and every tensor's gradient."""
    jmodel, params, cfg, model = build_pair(freeze_finetune_updates=0)
    opt = dict(lr=1e-3, schedule="fixed")
    tx = joptim.make_optimizer(joptim.OptimConfig(**opt))
    jstate = jax_create_state(params, tx)
    jstep = jax_make_step(jax_make_loss_fn(jmodel), tx, donate_state=False)
    state = create_train_state(model, optim.OptimConfig(**opt), device="cpu")
    step = make_train_step(make_ctc_finetune_loss_fn(model))
    b = batch(2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloss = jax_make_loss_fn(jmodel)
    grads = jax.grad(lambda p: (lambda l, ss, _: l / ss)(
        *jloss(p, jb, jax.random.PRNGKey(0), 0)))(jstate.params)
    jgrad = ctc_state_dict_from_jax(to_numpy(grads), cfg.encoder)
    total = np.sqrt(sum(float((v.double() ** 2).sum()) for v in jgrad.values()))
    jstate, jmet = jstep(jstate, jb, jax.random.PRNGKey(0))
    met = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
               torch.Generator().manual_seed(0))
    for k, rtol in (("loss_per_sample", 1e-5), ("grad_norm", 1e-4), ("sample_size", 0)):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=rtol, err_msg=k)
    live = 0
    for name, p in model.named_parameters():
        if p.grad is None:  # the conv frontend: feature_grad_mult 0
            assert not np.abs(jgrad[name].numpy()).any(), name
            continue
        g, wg = p.grad.numpy(), jgrad[name].numpy()
        assert np.linalg.norm(g - wg) <= 1e-4 * np.linalg.norm(wg) + 1e-6 * total, name
        live += ".self_attn." in name
    assert live == 2 * 8  # q/k/v/out weights and biases of both layers


def test_converter_at_xlarge_width():
    """The converters at X-Large's full width (one layer of 1280 in 16 heads
    of 80, FFN 5120, the positional conv in 16 groups of 80): the port's
    state dict in the JAX layout has the JAX model's tree and shapes (from
    jax.eval_shape, no JAX weights made), and comes back through
    ctc_state_dict_from_jax with a strict load, every tensor equal."""
    enc_kw = dict(XLARGE, encoder_layers=1, **NO_DROPOUT)
    kw = dict(vocab_size=32, apply_mask=False)
    cfg = CtcFinetuneConfig(encoder=large_encoder_config(**enc_kw), **kw)
    model = CtcFinetuneModel(cfg, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert tuple(sd["wavlm.encoder.layers.0.self_attn.q_proj.weight"].shape) == (1280, 1280)
    assert tuple(sd["wavlm.encoder.pos_conv.0.weight_v"].shape) == (1280, 80, 128)
    params = jax_params_from_ctc_state_dict(sd, cfg.encoder)
    jmodel = JCtcModel(JCtcConfig(encoder=jax_large(**enc_kw), **kw))
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": k, "mask": k, "dropout": k},
                                                jnp.zeros((1, 16000)),
                                                deterministic=True)["params"])
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(p): tuple(np.shape(v))
           for p, v in jax.tree_util.tree_leaves_with_path(params)}
    assert got == want
    back = CtcFinetuneModel(cfg)
    back.load_state_dict(ctc_state_dict_from_jax(params, cfg.encoder), strict=True)
    for name, v in back.state_dict().items():
        assert torch.equal(v, sd[name]), name


# ---------------------------------------------------------------- the CLIs

def _write_wav(path, samples, rate=16000):
    import wave

    pcm = np.clip(samples * 32767, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


HYP_WORDS = ["AB BA", "CAB AB BE", "ACE BA CAB"]
REFS = ["A B | B A |", "C A B | A B | B A |", "A C E | C A B |"]


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """Three utterances and a CTC checkpoint of the narrow X-Large model in
    the JAX layout (JAX init) whose head makes each utterance's best path
    spell HYP_WORDS by a wide margin: a least-squares map (fewer frames than
    features, so exact) from the encoder output the decode CLI computes to
    logits of 8 on the chosen unit and 0 elsewhere."""
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.data.manifest import Manifest, load_audio
    from unispeech_tpu_torch.decode.__main__ import bucket_grid, plan_eval_batches

    d_path = tmp_path_factory.mktemp("xlarge_decode")
    rng = np.random.default_rng(0)
    rows = []
    for i, n in enumerate((3000, 4200, 5100)):
        _write_wav(d_path / f"u{i}.wav", rng.standard_normal(n) * 0.1)
        rows.append(f"u{i}.wav\t{n}")
    (d_path / "test.tsv").write_text(f"{d_path}\n" + "\n".join(rows) + "\n")
    (d_path / "test.ltr").write_text("\n".join(REFS) + "\n")

    d = Dictionary.letters()
    # what decode --arch large --encoder-json XL_NARROW builds
    enc_kw = dict(_over(XL_NARROW), **NO_DROPOUT)
    jmodel = JCtcModel(JCtcConfig(encoder=jax_large(**enc_kw), vocab_size=len(d),
                                  apply_mask=False))
    params = to_numpy(jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4000)),
                                  deterministic=True)["params"])
    enc = large_encoder_config(**enc_kw)
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
    w = np.linalg.lstsq(H, 8.0 * onehot, rcond=None)[0].astype(np.float32)
    save_params_npz(str(d_path / "ctc.npz"), dict(params, proj={"kernel": w[:-1], "bias": w[-1]}))
    return d_path


def test_decode_cli_xlarge_matches_jax(planted):
    """decode --arch large --encoder-json <narrow X-Large> --decoder
    viterbi, the port (--device cpu) against the JAX CLI on the same
    checkpoint: the same hypothesis and reference files and WER report."""
    from unispeech_tpu.decode.__main__ import main as jax_decode
    from unispeech_tpu_torch.decode.__main__ import main as torch_decode

    d = planted

    def argv(out):
        return ["--manifest", str(d / "test.tsv"), "--transcripts", str(d / "test.ltr"),
                "--arch", "large", "--encoder-json", json.dumps(XL_NARROW),
                "--checkpoint", str(d / "ctc.npz"), "--decoder", "viterbi",
                "--results-path", str(d / out)]

    jax_decode(argv("jax"))
    torch_decode(argv("port") + ["--device", "cpu"])
    for name in ("hypo.units", "hypo.word", "ref.units", "ref.word"):
        assert (d / "port" / name).read_text() == (d / "jax" / name).read_text()
    hyps = sorted((d / "port" / "hypo.word").read_text().splitlines(),
                  key=lambda l: int(l.rsplit("(", 1)[1][:-1]))
    assert [h.rsplit(" (", 1)[0] for h in hyps] == HYP_WORDS
    rep = json.loads((d / "port" / "wer_report.json").read_text())
    jrep = json.loads((d / "jax" / "wer_report.json").read_text())
    assert (rep["utterances"], rep["wer"], rep["uer"]) == (
        jrep["utterances"], jrep["wer"], jrep["uer"])
    assert rep["utterances"] == 3 and rep["wer"] == round(200 / 7, 4)


def test_finetune_ctc_cli_xlarge_matches_jax(tmp_path, capsys, monkeypatch):
    """finetune-ctc --arch large --encoder-json <narrow X-Large> --w2v-path,
    2 updates with a valid pass at update 2, the port (--device cpu)
    against the JAX CLI. Both start from the JAX CLI's initial weights (its
    graft of the export and its head, handed to the port's graft) and train
    at lr 0, so the valid loss at update 2 is the same function of the same
    weights on both sides; each CLI's training losses are finite (the time
    masks and the head's dropout draw from each package's own generator)
    and the port's params export loads into the JAX decode CLI."""
    import unispeech_tpu.models.ctc as jax_ctc
    import unispeech_tpu_torch.models.ctc as port_ctc
    from unispeech_tpu.decode.__main__ import main as jax_decode
    from unispeech_tpu.train.__main__ import main as jax_train
    from unispeech_tpu_torch.train.__main__ import main as torch_train

    rng = np.random.default_rng(0)
    rows = []
    for i, n in enumerate([3000, 3100, 3200, 3300, 3000, 3100, 3200, 3300]):
        _write_wav(tmp_path / f"u{i}.wav", rng.standard_normal(n) * 0.1)
        rows.append(f"u{i}.wav\t{n}")
    (tmp_path / "train.tsv").write_text(f"{tmp_path}\n" + "\n".join(rows) + "\n")
    (tmp_path / "train.ltr").write_text("A |\nB A |\nA B |\nB |\nA |\nB A |\nA B |\nB |\n")
    # the pretrained backbone: a JAX-initialised narrow X-Large CTC model's
    _, params, cfg, _ = build_pair(vocab_size=32)
    save_params_npz(str(tmp_path / "w2v.npz"), {"wavlm": params["wavlm"]})

    init = {}
    graft = jax_ctc.load_pretrained_into

    def recording_graft(ft, pre):
        init["params"] = to_numpy(graft(ft, pre))
        return graft(ft, pre)

    def jax_init_graft(model, _path):
        model.load_state_dict(ctc_state_dict_from_jax(init["params"], model.cfg.encoder),
                              strict=True)

    monkeypatch.setattr(jax_ctc, "load_pretrained_into", recording_graft)
    monkeypatch.setattr(port_ctc, "load_pretrained_into", jax_init_graft)

    def argv(tag):
        return ["finetune-ctc", "--manifest", str(tmp_path / "train.tsv"), "--transcripts",
                str(tmp_path / "train.ltr"), "--valid-manifest", str(tmp_path / "train.tsv"),
                "--valid-transcripts", str(tmp_path / "train.ltr"), "--max-tokens", "30000",
                "--min-sample-size", "1000", "--num-buckets", "2", "--warmup-steps", "2",
                "--log-interval", "1", "--lr", "0", "--max-updates", "2",
                "--validate-interval-updates", "2", "--save-interval-updates", "2",
                "--freeze-finetune-updates", "1", "--arch", "large",
                "--encoder-json", json.dumps(XL_NARROW), "--w2v-path",
                str(tmp_path / "w2v.npz"), "--checkpoint-dir", str(tmp_path / f"ckpt_{tag}"),
                "--export-params", str(tmp_path / f"{tag}.npz")]

    jax_train(argv("jax"))
    jerr = capsys.readouterr().err.splitlines()
    torch_train(argv("port") + ["--device", "cpu"])
    err = capsys.readouterr().err.splitlines()

    def records(lines, tag):
        return [json.loads(l) for l in lines if l.startswith(f'{{"tag": "{tag}"')]

    for lines in (jerr, err):
        train = records(lines, "train")
        assert [r["step"] for r in train] == [1, 2]
        assert all(np.isfinite(r["loss_avg"]) for r in train)
    (jv,), (pv,) = records(jerr, "valid"), records(err, "valid")
    assert jv["step"] == pv["step"] == 2
    np.testing.assert_allclose(pv["loss_avg"], jv["loss_avg"], rtol=2e-2)
    assert np.isfinite(pv["wer"]) and np.isfinite(pv["uer"])

    jax_decode(["--manifest", str(tmp_path / "train.tsv"), "--checkpoint",
                str(tmp_path / "port.npz"), "--arch", "large", "--encoder-json",
                json.dumps(XL_NARROW), "--results-path", str(tmp_path / "dec")])
    assert len((tmp_path / "dec" / "hypo.word").read_text().splitlines()) == 8
