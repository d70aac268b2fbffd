"""The port's downstream heads and CLIs against the JAX package's (CPU).

ECAPA-TDNN and the EEND head are initialised by JAX from a seed, carried
into the port with ``ecapa_state_dict_from_jax`` /
``diarization_state_dict_from_jax`` and loaded with ``strict=True``; the
same numpy inputs go through both, fp32: embeddings, logits, speaker
vectors, losses and running statistics rtol 1e-5 (atol 1e-5 at unit
scale). The numpy inference and scoring code is held to its JAX original
exactly. The two CLIs run against the JAX CLIs on a tiny backbone with the
same ``.npz`` files: the same EER with scores within 1e-4, and the same
RTTM lines and DER, the diarization head planted so that bf16 noise
cannot flip a frame or a clustering decision.
"""

import contextlib
import io
import itertools
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unispeech_tpu.downstream import diarization as jdia
from unispeech_tpu.downstream import ecapa_tdnn as jecapa
from unispeech_tpu.downstream.diarize import main as jax_diarize
from unispeech_tpu.downstream.verification import main as jax_verify
from unispeech_tpu.downstream.verification import parse_trials as jax_parse_trials
from unispeech_tpu.train.checkpoint import save_params_npz
from unispeech_tpu_torch.convert.from_jax import (
    diarization_state_dict_from_jax,
    ecapa_state_dict_from_jax,
    jax_params_from_diarization_state_dict,
    jax_params_from_ecapa_state_dict,
    jax_params_of,
)
from unispeech_tpu_torch.downstream import diarization as dia
from unispeech_tpu_torch.downstream import ecapa_tdnn as ecapa
from unispeech_tpu_torch.downstream.diarize import main as torch_diarize
from unispeech_tpu_torch.downstream.verification import main as torch_verify
from unispeech_tpu_torch.downstream.verification import parse_trials

RTOL = ATOL = 1e-5
ECFG = dict(channels=64, emb_dim=32, scale=4, num_layer_feats=3)
DCFG = dict(num_speakers=2, hidden_dim=32, num_layers=2, num_heads=4, ffn_dim=64, emb_dim=16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models gain nothing from intra-op threads, and under a
    parallel test run OpenMP's spinning threads slow them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def np_tree(tree):
    return {k: np_tree(v) if hasattr(v, "items") else np.array(v) for k, v in tree.items()}


# ------------------------------------------------------------------ ECAPA
def ecapa_pair(seed=0, T=50, D=16):
    """A JAX-initialised ECAPA head with random running statistics, the port
    head with the same weights, and (L, B, T, D) features with row 1 padded
    from frame 37 on."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((ECFG["num_layer_feats"], 2, T, D)).astype(np.float32)
    pad = np.zeros((2, T), bool)
    pad[1, 37:] = True
    variables = np_tree(jecapa.EcapaTdnn(jecapa.EcapaConfig(**ECFG)).init(
        jax.random.PRNGKey(seed), jnp.asarray(feats), jnp.asarray(pad)))
    params = variables["params"]
    params["featurizer"]["weights"] = rng.standard_normal(ECFG["num_layer_feats"]).astype(
        np.float32)
    stats = jax.tree.map(lambda x: x, variables["batch_stats"])
    for bn in jax.tree_util.tree_leaves(stats, is_leaf=lambda n: "mean" in n):
        bn["mean"] = (rng.standard_normal(bn["mean"].shape) * 0.1).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    model = ecapa.EcapaTdnn(ecapa.EcapaConfig(**ECFG), D)
    model.load_state_dict(ecapa_state_dict_from_jax(params, stats), strict=True)
    return {"params": params, "batch_stats": stats}, model, feats, pad


def test_ecapa_eval_forward_matches_jax():
    variables, model, feats, pad = ecapa_pair()
    want = jecapa.EcapaTdnn(jecapa.EcapaConfig(**ECFG)).apply(
        variables, jnp.asarray(feats), jnp.asarray(pad))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(feats), torch.from_numpy(pad))
    close(got, want)
    # the params (and running statistics) round trip
    params, stats = jax_params_from_ecapa_state_dict(model.state_dict())
    jax.tree.map(np.testing.assert_array_equal, params, variables["params"])
    jax.tree.map(np.testing.assert_array_equal, stats, variables["batch_stats"])
    jax.tree.map(np.testing.assert_array_equal, jax_params_of(model), variables["params"])


def _torch_default_batch_norm(self, x):
    """torch.nn.BatchNorm1d's update: the running variance moves toward the
    unbiased batch variance."""
    return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                        training=self.training, momentum=self.momentum, eps=self.eps)


@pytest.mark.parametrize("update", ["flax", "torch_default"])
def test_ecapa_train_mode_running_stats_match_jax(update, monkeypatch):
    """A train-mode forward normalises by the batch statistics and moves the
    running averages as flax does (momentum 0.1 toward the biased batch
    variance, padded frames included). torch's default BatchNorm update,
    unbiased, misses JAX's variance by more than the tolerance."""
    variables, model, feats, pad = ecapa_pair(seed=1)
    want, updated = jecapa.EcapaTdnn(jecapa.EcapaConfig(**ECFG), train=True).apply(
        variables, jnp.asarray(feats), jnp.asarray(pad), mutable=["batch_stats"])
    if update == "torch_default":
        monkeypatch.setattr(ecapa.BatchNorm, "forward", _torch_default_batch_norm)
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.from_numpy(pad))
    close(got, want)  # the batch's own statistics normalise either way
    _, stats = jax_params_from_ecapa_state_dict(model.state_dict())

    def flat(tree):
        return {jax.tree_util.keystr(p): v
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    got_f, want_f = flat(stats), flat(np_tree(updated["batch_stats"]))
    assert sorted(got_f) == sorted(want_f) and len(want_f) == 2 * 7
    for k in want_f:
        if k.endswith("['mean']"):
            close(got_f[k], want_f[k])
    var_ok = all(np.allclose(got_f[k], want_f[k], rtol=RTOL, atol=0)
                 for k in want_f if k.endswith("['var']"))
    assert var_ok == (update == "flax")


def test_ecapa_padding_and_scoring():
    """tests/test_downstream.py::test_ecapa_forward_and_scoring on the port:
    shape, finite, a self-score of 1, and padded frames masked out."""
    torch.manual_seed(0)
    model = ecapa.EcapaTdnn(ecapa.EcapaConfig(**ECFG), 16,
                            generator=torch.Generator().manual_seed(0)).eval()
    feats = torch.randn(3, 2, 50, 16, generator=torch.Generator().manual_seed(1))
    pad = torch.zeros(2, 50, dtype=torch.bool)
    with torch.no_grad():
        emb = model(feats, pad)
        assert emb.shape == (2, 32) and torch.isfinite(emb).all()
        assert abs(float(ecapa.cosine_score(emb[0], emb[0])) - 1.0) < 1e-5
        pad2 = pad.clone()
        pad2[:, 40:] = True
        zeroed, loud = feats.clone(), feats.clone()
        zeroed[:, :, 40:] = 0.0
        loud[:, :, 40:] = 99.0
        close(model(loud, pad2), model(zeroed, pad2).numpy(), rtol=1e-4, atol=0)


def test_ecapa_batchnorm_running_stats_move_in_train_mode_only():
    """tests/test_downstream.py::test_ecapa_batchnorm_running_stats on the
    port."""
    model = ecapa.EcapaTdnn(ecapa.EcapaConfig(**ECFG), 16,
                            generator=torch.Generator().manual_seed(0))
    feats = torch.randn(3, 2, 50, 16, generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    assert before, "BatchNorm must track running statistics"
    with torch.no_grad():
        model.train()(feats)
        after = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        assert any(not torch.allclose(before[k], after[k]) for k in before)
        model.eval()
        e1, e2 = model(feats), model(feats)
    assert torch.equal(e1, e2)
    assert all(torch.equal(after[k], v) for k, v in model.state_dict().items() if k in after)


def test_eer_matches_jax():
    """tests/test_downstream.py::test_eer_perfect_and_random, and random
    trials with ties, against the JAX original."""
    scores = np.asarray([0.9, 0.8, 0.1, 0.2])
    labels = np.asarray([1, 1, 0, 0])
    assert ecapa.compute_eer(scores, labels) == 0.0
    assert ecapa.compute_eer(1 - scores, labels) >= 0.5
    rng = np.random.default_rng(0)
    for n in (5, 40, 333):
        s = np.round(rng.standard_normal(n), 1)
        lab = rng.integers(0, 2, n)
        assert ecapa.compute_eer(s, lab) == jecapa.compute_eer(s, lab)
    a, b = rng.standard_normal((2, 7, 24)).astype(np.float32)
    close(ecapa.cosine_score(torch.from_numpy(a), torch.from_numpy(b)),
          jecapa.cosine_score(jnp.asarray(a), jnp.asarray(b)))


# -------------------------------------------------------------- diarization
def diarization_pair(seed=0, T=40, D=24):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, T, D)).astype(np.float32)
    pad = np.zeros((2, T), bool)
    pad[1, 25:] = True
    jmodel = jdia.TransformerDiarization(jdia.DiarizationConfig(**DCFG))
    params = np_tree(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(feats))["params"])
    model = dia.TransformerDiarization(dia.DiarizationConfig(**DCFG), D)
    model.load_state_dict(diarization_state_dict_from_jax(params), strict=True)
    return jmodel, params, model.eval(), feats, pad


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_diarization_forward_matches_jax(padded):
    """Logits and speaker vectors against JAX, padded query rows included:
    such a row has no key, and flax's fp32-minimum fill makes it uniform and
    finite; the port gives the same finite values."""
    jmodel, params, model, feats, pad = diarization_pair()
    pm = pad if padded else None
    want = jmodel.apply({"params": params}, jnp.asarray(feats),
                        None if pm is None else jnp.asarray(pm))
    with torch.no_grad():
        got = model(torch.from_numpy(feats), None if pm is None else torch.from_numpy(pm))
    assert torch.isfinite(got.logits).all() and torch.isfinite(got.spk_vectors).all()
    close(got.logits, want.logits)
    close(got.spk_vectors, want.spk_vectors)
    if padded:  # the padded rows themselves
        close(got.logits[1, 25:], want.logits[1, 25:])
    back = jax_params_from_diarization_state_dict(model.state_dict(), DCFG["num_heads"])
    jax.tree.map(np.testing.assert_array_equal, back, params)
    jax.tree.map(np.testing.assert_array_equal, jax_params_of(model), params)


def test_diarization_shapes_and_pit():
    """tests/test_downstream.py::test_diarization_forward_and_pit on the
    port."""
    model = dia.TransformerDiarization(dia.DiarizationConfig(**DCFG), 24,
                                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(torch.randn(2, 40, 24, generator=torch.Generator().manual_seed(1)))
    assert out.logits.shape == (2, 40, 2) and out.spk_vectors.shape == (2, 2, 16)
    labels = torch.zeros(2, 40, 2)
    labels[:, :20, 0] = 1.0
    labels[:, 20:, 1] = 1.0
    good = (labels * 2 - 1) * 5.0
    l1, _ = dia.pit_bce_loss(good, labels)
    l2, _ = dia.pit_bce_loss(good.flip(-1), labels)
    assert abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1))
    # with a generator the attention dropout runs, drawn from it
    g = lambda: torch.Generator().manual_seed(5)
    x = torch.randn(2, 40, 24)
    a, b = model(x, generator=g()), model(x, generator=g())
    assert torch.equal(a.logits, b.logits) and not torch.equal(a.logits, model(x).logits)


@pytest.mark.parametrize("S", [2, 3])
def test_pit_bce_loss_matches_jax(S):
    rng = np.random.default_rng(S)
    logits = (rng.standard_normal((3, 30, S)) * 3).astype(np.float32)
    labels = (rng.random((3, 30, S)) < 0.4).astype(np.float32)
    pad = np.zeros((3, 30), bool)
    pad[1, 18:] = True
    pad[2, :] = True  # every frame padded: the loss's denominator floor
    for pm in (None, pad):
        want, wbest = jdia.pit_bce_loss(jnp.asarray(logits), jnp.asarray(labels),
                                        None if pm is None else jnp.asarray(pm))
        got, best = dia.pit_bce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                     None if pm is None else torch.from_numpy(pm))
        close(got, want, atol=0)
        np.testing.assert_array_equal(best.numpy(), np.asarray(wbest))


# --------------------------------------------------------------- numpy code
def test_ahc_median_filter_and_rttm():
    """tests/test_downstream.py::test_ahc_and_rttm on the port."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(8) + np.asarray([5.0] + [0.0] * 7)
    b = rng.standard_normal(8) + np.asarray([0.0] * 7 + [5.0])
    vectors = np.stack([a, a + 0.01, b, b + 0.01])
    ids = dia.ahc_cluster(vectors, threshold=0.5)
    assert ids[0] == ids[1] and ids[2] == ids[3] and ids[0] != ids[2]
    ids2 = dia.ahc_cluster(vectors, threshold=2.0, cannot_link=[(0, 1)])
    assert ids2[0] != ids2[1]
    act = np.zeros((10, 2))
    act[2:6, 0] = 1
    assert "SPEAKER utt 1 0.040 0.080" in dia.to_rttm(act, frame_shift_s=0.02)
    noisy = act.copy()
    noisy[3, 0] = 0
    assert dia.median_filter(noisy, width=3)[3, 0] == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_inference_matches_jax(seed):
    """AHC with cannot-links, the median filter, RTTM lines and their
    parser, and the DER of random segmentations, equal to the JAX
    originals."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, 12))
    vecs = centers[rng.integers(0, 4, 18)] + 0.4 * rng.standard_normal((18, 12))
    links = [tuple(rng.choice(18, 2, replace=False)) for _ in range(10)]
    for thr in (0.3, 0.6, 1.2):
        np.testing.assert_array_equal(dia.ahc_cluster(vecs, thr, links),
                                      jdia.ahc_cluster(vecs, thr, links))
    act = (rng.random((120, 3)) < 0.45).astype(np.float32)
    for w in (1, 4, 11):
        np.testing.assert_array_equal(dia.median_filter(act, w), jdia.median_filter(act, w))
    ref = dia.to_rttm(dia.median_filter(act, 5).astype(int), 0.02, uri="rec")
    hyp = dia.to_rttm(dia.median_filter(np.roll(act, 3, 0)[:, ::-1], 7).astype(int), 0.02,
                      uri="rec")
    assert ref == jdia.to_rttm(jdia.median_filter(act, 5).astype(int), 0.02, uri="rec")
    assert dia.parse_rttm(ref) == jdia.parse_rttm(ref) and dia.parse_rttm(ref)
    assert dia.compute_der(ref, hyp) == jdia.compute_der(ref, hyp)
    assert dia.compute_der(ref, "") == jdia.compute_der(ref, "")


def test_chunked_diarization_matches_jax():
    """tests/test_downstream.py::test_chunked_diarization_stitches_speakers
    on the port, and the same stitching equal to JAX's on a noisy input."""
    rng = np.random.default_rng(0)
    spk_a, spk_b = rng.standard_normal(8), rng.standard_normal(8)

    def infer_fn(chunk):
        logits = np.full((len(chunk), 2), -10.0, np.float32)
        logits[chunk[:, 0] > 0, 0] = 10.0
        logits[chunk[:, 1] > 0, 1] = 10.0
        return logits, np.stack([spk_a, spk_b]) + 0.1 * chunk[:2, :8]

    feats = np.zeros((200, 8), np.float32)
    feats[:80, 0] = 1.0
    feats[120:, 1] = 1.0
    act = dia.chunked_diarization(infer_fn, feats, chunk_size=50, threshold=0.5,
                                  median_width=1)
    assert act.shape[1] == 2
    on_a, on_b = act[:80].sum(0).argmax(), act[120:].sum(0).argmax()
    assert on_a != on_b and act[:80, on_a].mean() > 0.9 and act[120:, on_b].mean() > 0.9
    noisy = feats + 0.8 * rng.standard_normal(feats.shape).astype(np.float32)
    for kw in (dict(chunk_size=50, threshold=0.5, median_width=5),
               dict(chunk_size=64, threshold=1.5, median_width=1)):
        np.testing.assert_array_equal(dia.chunked_diarization(infer_fn, noisy, **kw),
                                      jdia.chunked_diarization(infer_fn, noisy, **kw))
    assert dia.chunked_diarization(lambda c: (np.full((len(c), 2), -9.0), np.ones((2, 8))),
                                   feats).shape == (200, 1)


def test_der_identical_and_disjoint():
    """tests/test_downstream.py::test_der_identical_and_disjoint on the
    port."""
    ref = "\n".join(["SPEAKER u 1 0.000 2.000 <NA> <NA> alice <NA> <NA>",
                     "SPEAKER u 1 3.000 1.000 <NA> <NA> bob <NA> <NA>"])
    assert dia.compute_der(ref, ref.replace("alice", "x").replace("bob", "y"))["der"] < 1e-6
    miss_all = dia.compute_der(ref, "")
    assert abs(miss_all["der"] - 1.0) < 1e-6 and abs(miss_all["miss"] - 1.0) < 1e-6
    half = dia.compute_der(ref, "SPEAKER u 1 0.000 1.000 <NA> <NA> spk0 <NA> <NA>")
    assert half["false_alarm"] < 1e-6 and abs(half["miss"] - 2.0 / 3.0) < 0.02


# ---------------------------------------------------------------------- CLIs
def _write_wav(path, samples, rate=16000):
    pcm = np.clip(samples * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _backbone(tmp_path, tiny, seed=0):
    """A JAX-initialised tiny backbone as the CLIs' ``--backbone`` .npz."""
    from unispeech_tpu.configs import EncoderConfig
    from unispeech_tpu.models.wavlm import WavLM, WavLMModelConfig

    over = {k: tuple(map(tuple, v)) if k == "conv_layers" else v for k, v in tiny.items()}
    enc = EncoderConfig(relative_position_embedding=True, gru_rel_pos=True, dropout=0.0,
                        attention_dropout=0.0, encoder_layerdrop=0.0, **over)
    model = WavLM(WavLMModelConfig(encoder=enc))
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 4000)))["params"]
    save_params_npz(str(tmp_path / "bb.npz"), params)
    return WavLM(WavLMModelConfig(encoder=enc), dtype=jnp.bfloat16), params


VER_TINY = dict(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                encoder_attention_heads=4, conv_layers=[[32, 10, 5], [32, 3, 2]],
                conv_pos=16, conv_pos_groups=4, num_buckets=32, max_distance=64)


def test_verification_cli_smoke(tmp_path):
    """tests/test_downstream.py::test_verification_cli_smoke on the port:
    a random head (no ``--head``), four trials, same-utterance scores 1."""
    _backbone(tmp_path, VER_TINY)
    rng = np.random.default_rng(0)
    for i in range(3):
        _write_wav(tmp_path / f"s{i}.wav", rng.standard_normal(4000) * 0.1)
    (tmp_path / "trials.txt").write_text(
        "1 s0.wav s0.wav\n0 s0.wav s1.wav\n1 s1.wav s1.wav\n0 s1.wav s2.wav\n")
    report = _run(torch_verify, [
        "--trials", str(tmp_path / "trials.txt"), "--wav-root", str(tmp_path),
        "--backbone", str(tmp_path / "bb.npz"), "--encoder-json", json.dumps(VER_TINY),
        "--scores-path", str(tmp_path / "scores.txt"), "--device", "cpu"])
    assert report["trials"] == 4 and 0.0 <= report["eer"] <= 100.0
    lines = (tmp_path / "scores.txt").read_text().splitlines()
    assert float(lines[0].split()[0]) > 0.999


def test_verification_cli_matches_jax(tmp_path):
    """The same backbone and ECAPA head ``.npz`` through both CLIs, six wavs
    of 0.25-0.8 s in batches of 4 (each padded to x320): the same EER, every
    score within 1e-4, and parse_trials equal."""
    _backbone(tmp_path, VER_TINY)
    rng = np.random.default_rng(1)
    names = [f"w{i}.wav" for i in range(6)]
    for name, n in zip(names, (4000, 12800, 9100, 6400, 5000, 11000)):
        _write_wav(tmp_path / name, rng.standard_normal(n) * 0.1)
    trials = [(1, a, a) for a in names[:3]] + [
        (int(i % 3 == 0), a, b) for i, (a, b) in enumerate(itertools.combinations(names, 2))]
    (tmp_path / "trials.txt").write_text(
        "".join(f"{l} {a} {b}\n" for l, a, b in trials) + "bad line\n")
    assert parse_trials(str(tmp_path / "trials.txt")) == jax_parse_trials(
        str(tmp_path / "trials.txt"))
    L = VER_TINY["encoder_layers"] + 1
    head = jecapa.EcapaTdnn(jecapa.EcapaConfig(num_layer_feats=L))
    hp = np_tree(head.init(jax.random.PRNGKey(3), jnp.zeros((L, 1, 40, 64)))["params"])
    hp["featurizer"]["weights"] = np.linspace(-1, 1, L).astype(np.float32)
    save_params_npz(str(tmp_path / "head.npz"), hp)
    common = ["--trials", str(tmp_path / "trials.txt"), "--wav-root", str(tmp_path),
              "--backbone", str(tmp_path / "bb.npz"), "--head", str(tmp_path / "head.npz"),
              "--encoder-json", json.dumps(VER_TINY), "--batch-size", "4"]
    want = _run(jax_verify, common + ["--scores-path", str(tmp_path / "jax.txt")])
    got = _run(torch_verify, common + ["--scores-path", str(tmp_path / "port.txt"),
                                       "--device", "cpu"])
    assert got == want and got["trials"] == len(trials)
    rows = [(l.split(), m.split()) for l, m in zip(
        (tmp_path / "port.txt").read_text().splitlines(),
        (tmp_path / "jax.txt").read_text().splitlines())]
    assert len(rows) == len(trials)
    for g, w in rows:
        assert g[1:] == w[1:]
        assert abs(float(g[0]) - float(w[0])) <= 1e-4, (g, w)


DIA_TINY = dict(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                encoder_attention_heads=4,
                conv_layers=[[32, 10, 5]] + [[32, 3, 2]] * 4 + [[32, 2, 2]] * 2,
                conv_pos=16, conv_pos_groups=4, num_buckets=32, max_distance=64)
# two "speakers" of distinct spectra, turns in seconds; 320 T + 80 samples
# give T = 200 and 150 frames, whole chunks of 50
TURNS = {"rec0": [("a", 0.0, 1.5), ("b", 1.5, 2.5), ("a", 2.5, 4.005)],
         "rec1": [("b", 0.0, 1.0), ("a", 1.0, 3.005)]}
CHUNK = 50


def _speaker(kind, n, rng):
    if kind == "a":  # white noise
        return 0.3 * rng.standard_normal(n)
    t = np.arange(n) / 16000  # a low tone and its harmonic
    return 0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 440 * t)


def _planted_head(feats_by_rec, turns, hidden=256, seed=0):
    """Default-sized JAX diarization params, planted: the layers add
    nothing (zero out-projections), so the hidden state is LN(in_proj(f));
    local speaker 0's logit is alpha * (u.z - c) for u the direction between
    the two speakers' mean states and c the middle of the widest gap of u.z
    over all frames between the two speakers' medians, speaker 1's its
    negative, speaker 2 off at -8; alpha puts the frames beside the gap at
    3 from 0. The speaker vectors are orthogonal per local speaker (bias)
    plus a small feature term."""
    rng = np.random.default_rng(seed)
    cfg = jdia.DiarizationConfig()
    D = next(iter(feats_by_rec.values())).shape[1]
    params = np_tree(jdia.TransformerDiarization(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, D)))["params"])
    for i in range(cfg.num_layers):
        lay = params[f"layer_{i}"]
        for node in (lay["MultiHeadDotProductAttention_0"]["out"], lay["Dense_1"]):
            node["kernel"][:] = 0.0
            node["bias"][:] = 0.0
    w_in, b_in = params["in_proj"]["kernel"], params["in_proj"]["bias"]

    def states(f):
        h = f @ w_in + b_in
        mu = h.mean(-1, keepdims=True)
        return (h - mu) / np.sqrt(h.var(-1, keepdims=True) + 1e-6)

    za, zb = [], []
    for uri, f in feats_by_rec.items():
        z = states(f)
        for spk, s, e in turns[uri]:
            (za if spk == "a" else zb).append(z[int(s * 50) + 5:int(e * 50) - 5])
    za, zb = np.concatenate(za), np.concatenate(zb)
    u = za.mean(0) - zb.mean(0)
    u /= np.linalg.norm(u)
    lo, hi = np.median(zb @ u), np.median(za @ u)
    p = np.sort(np.concatenate([states(f) @ u for f in feats_by_rec.values()]))
    p = np.concatenate([[lo], p[(p > lo) & (p < hi)], [hi]])
    gaps = np.diff(p)
    i = int(np.argmax(gaps))
    c = 0.5 * (p[i] + p[i + 1])
    alpha = 3.0 / (0.5 * gaps[i])
    kern = np.zeros((hidden, cfg.num_speakers), np.float32)
    kern[:, 0], kern[:, 1] = alpha * u, -alpha * u
    params["out_proj"]["kernel"] = kern
    params["out_proj"]["bias"] = np.asarray([-alpha * c, alpha * c, -8.0], np.float32)
    E = cfg.emb_dim
    bias = np.zeros((cfg.num_speakers, E), np.float32)
    for s in range(cfg.num_speakers):
        bias[s, s * E // 3:(s + 1) * E // 3] = 1.0
    params["spk_proj"]["bias"] = bias.reshape(-1)
    params["spk_proj"]["kernel"] = (rng.standard_normal((hidden, E * cfg.num_speakers))
                                    * 0.002).astype(np.float32)
    return params


# the sigmoid of a logit below -88 overflows np.exp in both packages' copy
# of chunked_diarization (to activity 0, as it should)
@pytest.mark.filterwarnings("ignore:overflow encountered in exp:RuntimeWarning")
def test_diarize_cli_matches_jax(tmp_path):
    """Two recordings (4 s and 3 s, turns of two synthetic speakers) through
    both CLIs with the same backbone and planted head ``.npz``, chunks of 50
    frames: the same RTTM lines and the same DER. The plant's margins are
    checked on JAX's side: every logit at least 2 from 0, every distance
    between chunk-speaker vectors at least 0.05 from the AHC threshold."""
    jbackbone, bb_params = _backbone(tmp_path, DIA_TINY)
    features = jax.jit(lambda p, x: jbackbone.apply({"params": p}, x).x)
    rng = np.random.default_rng(2)
    rows, ref = [], []
    feats = {}
    for uri, turns in TURNS.items():
        wav = np.concatenate([_speaker(spk, round((e - s) * 16000), rng)
                              for spk, s, e in turns])
        _write_wav(tmp_path / f"{uri}.wav", wav)
        rows.append(f"{uri}.wav\t{len(wav)}")
        ref += [f"SPEAKER {uri} 1 {s:.3f} {e - s:.3f} <NA> <NA> {spk} <NA> <NA>"
                for spk, s, e in turns]
        src = np.zeros((1, len(wav)), np.float32)
        src[0] = np.clip(wav * 32767, -32768, 32767).astype(np.int16) / 32768.0
        feats[uri] = np.asarray(features(bb_params, jnp.asarray(src))[0], np.float32)
    (tmp_path / "man.tsv").write_text(f"{tmp_path}\n" + "\n".join(rows) + "\n")
    (tmp_path / "ref.rttm").write_text("\n".join(ref) + "\n")
    params = _planted_head(feats, TURNS)
    save_params_npz(str(tmp_path / "head.npz"), params)

    chunk, thr = CHUNK, 0.6
    jhead = jax.jit(lambda x: jdia.TransformerDiarization(jdia.DiarizationConfig()).apply(
        {"params": params}, x))
    for f in feats.values():
        vecs = []
        for i in range(0, len(f), chunk):
            out = jhead(jnp.asarray(f[None, i:i + chunk]))
            logits = np.asarray(out.logits[0])
            assert np.abs(logits).min() >= 2.0, np.abs(logits).min()
            act = logits > 0
            vecs += [np.asarray(out.spk_vectors[0, s]) for s in range(3)
                     if act[:, s].mean() > 0.05]
        v = np.stack(vecs) / np.linalg.norm(np.stack(vecs), axis=-1, keepdims=True)
        assert np.abs((1.0 - v @ v.T) - thr).min() >= 0.05

    common = ["--manifest", str(tmp_path / "man.tsv"), "--backbone", str(tmp_path / "bb.npz"),
              "--head", str(tmp_path / "head.npz"), "--encoder-json", json.dumps(DIA_TINY),
              "--chunk-frames", str(chunk), "--median-width", "5",
              "--ref-rttm", str(tmp_path / "ref.rttm")]
    want = _run(jax_diarize, common + ["--rttm-dir", str(tmp_path / "jax")])
    got = _run(torch_diarize, common + ["--rttm-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert got == want and "der" in got and got["recordings"] == 2
    for uri in TURNS:
        lines = (tmp_path / "port" / f"{uri}.rttm").read_text()
        assert lines == (tmp_path / "jax" / f"{uri}.rttm").read_text()
        assert len(dia.parse_rttm(lines)) >= 2


def test_downstream_clis_need_cuda_without_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    _backbone(tmp_path, VER_TINY)
    (tmp_path / "t.txt").write_text("1 a.wav a.wav\n")
    (tmp_path / "m.tsv").write_text(f"{tmp_path}\n")
    for main, argv in ((torch_verify, ["--trials", str(tmp_path / "t.txt")]),
                       (torch_diarize, ["--manifest", str(tmp_path / "m.tsv")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--backbone", str(tmp_path / "bb.npz"),
                         "--encoder-json", json.dumps(VER_TINY)])
