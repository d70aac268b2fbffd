"""The port's remaining data modules against the JAX package's (CPU).

``data/s2t.py``, ``data/chunk_stream.py`` and ``data/feats.py`` are host
numpy: on the same synthetic files their entries, features and batches
must be identical to JAX's. The native packer and edit distance
(``native/``, built from the port's own source) must equal the port's
Python scans and JAX's results. ``mix_batch_device``'s math, fed the draws
JAX's keyed mixer makes (its own ``jax.random`` calls on the split keys),
must match JAX's output to 1e-6; its host sampler is held statistically.
``NoiseStore.precut`` must cut JAX's clips from the same numpy generator.
"""

import io
import struct
import wave
import zipfile

import numpy as np
import pytest
import torch


def _wav_bytes(wav, rate=16000):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((wav * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _zip_shard(path, wavs):
    """A stored zip of wav files; the (offset, length) of each payload."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for i, wav in enumerate(wavs):
            z.writestr(f"utt{i}.wav", _wav_bytes(wav))
    out = []
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            with open(path, "rb") as f:
                f.seek(info.header_offset)
                n_name, n_extra = struct.unpack("<HH", f.read(30)[26:30])
            out.append((info.header_offset + 30 + n_name + n_extra, info.file_size))
    return out


def _wavs(n, rng, lo, hi):
    return [rng.standard_normal(int(rng.integers(lo, hi))).astype(np.float32) * 0.1
            for _ in range(n)]


def _same_batches(a, b, n):
    ia, ib = iter(a), iter(b)
    for _ in range(n):
        x, y = next(ia), next(ib)
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_s2t_matches_jax(tmp_path):
    from unispeech_tpu.data.dictionary import Dictionary as JDictionary
    from unispeech_tpu.data import s2t as js2t
    from unispeech_tpu_torch.data import s2t
    from unispeech_tpu_torch.data.dictionary import Dictionary

    rng = np.random.default_rng(5)
    rows = []
    for i, wav in enumerate(_wavs(3, rng, 3000, 6000)):
        (tmp_path / f"u{i}.wav").write_bytes(_wav_bytes(wav))
        rows.append((f"u{i}", f"u{i}.wav", len(wav), f"hello w{i}"))
    zipped = _wavs(3, rng, 3000, 6000)
    for j, ((off, ln), wav) in enumerate(zip(_zip_shard(str(tmp_path / "s.zip"), zipped),
                                             zipped)):
        rows.append((f"z{j}", f"s.zip:{off}:{ln}", len(wav), "bye now"))
    with open(tmp_path / "train.tsv", "w") as f:
        f.write("id\taudio\tn_frames\ttgt_text\tspeaker\n")
        for r in rows:
            f.write("\t".join(map(str, r)) + "\tspk\n")
    ours, theirs = (s2t.load_s2t_tsv(str(tmp_path / "train.tsv")),
                    js2t.load_s2t_tsv(str(tmp_path / "train.tsv")))
    assert [vars(e) for e in ours] == [vars(e) for e in theirs]
    for e, je in zip(ours, theirs):
        np.testing.assert_array_equal(s2t.load_s2t_source(e), js2t.load_s2t_source(je))
    feats = rng.standard_normal((40, 13)).astype(np.float32)
    np.save(tmp_path / "f.npy", feats)
    np.testing.assert_array_equal(
        s2t.load_s2t_source(s2t.S2TEntry("f", str(tmp_path / "f.npy"), 40)), feats)

    d, jd = Dictionary(), JDictionary()
    for w in "hello w0 w1 w2 bye now".split():
        d.add_symbol(w)
        jd.add_symbol(w)
    kw = dict(batch_size=2, num_buckets=2, max_target_len=8, seed=3)
    _same_batches(s2t.S2TIterator(ours, tgt_dict=d, **kw),
                  js2t.S2TIterator(theirs, tgt_dict=jd, **kw), 7)


@pytest.mark.parametrize("num_shards", [1, 2])
def test_chunk_stream_matches_jax(tmp_path, num_shards):
    from unispeech_tpu.data import chunk_stream as jcs
    from unispeech_tpu_torch.data import chunk_stream as cs

    rng = np.random.default_rng(3)
    shards = []
    for s in range(4):
        shards.append(str(tmp_path / f"c{s}.zip"))
        _zip_shard(shards[-1], _wavs(4, rng, 800, 7000))
    kw = dict(max_sample_size=6000, min_sample_size=1000, max_tokens=16_000,
              buffer_utterances=5, num_buckets=4)
    for shard_id in range(num_shards):
        a = cs.StreamingChunkIterator(shards, cs.ChunkStreamConfig(**kw), seed=7,
                                      num_shards=num_shards, shard_id=shard_id)
        b = jcs.StreamingChunkIterator(shards, jcs.ChunkStreamConfig(**kw), seed=7,
                                       num_shards=num_shards, shard_id=shard_id)
        _same_batches(a, b, 8)
        assert a.state_dict() == b.state_dict()
        # a resumed walk re-enters after the last whole shard, as JAX's
        a2 = cs.StreamingChunkIterator(shards, cs.ChunkStreamConfig(**kw), seed=7,
                                       num_shards=num_shards, shard_id=shard_id)
        b2 = jcs.StreamingChunkIterator(shards, jcs.ChunkStreamConfig(**kw), seed=7,
                                        num_shards=num_shards, shard_id=shard_id)
        a2.load_state_dict(a.state_dict())
        b2.load_state_dict(b.state_dict())
        _same_batches(a2, b2, 3)


def test_feats_match_jax(tmp_path):
    from unispeech_tpu.data import feats as jfeats
    from unispeech_tpu.data.manifest import Manifest as JManifest
    from unispeech_tpu_torch.data import feats
    from unispeech_tpu_torch.data.manifest import Manifest

    rng = np.random.default_rng(4)
    wav = rng.standard_normal(9000).astype(np.float32) * 0.1
    for name in ("logmel_spectrogram", "fbank", "mfcc"):
        np.testing.assert_array_equal(getattr(feats, name)(wav), getattr(jfeats, name)(wav),
                                      err_msg=name)
    lines = [str(tmp_path)]
    for i, w in enumerate(_wavs(5, rng, 4000, 9000)):
        (tmp_path / f"u{i}.wav").write_bytes(_wav_bytes(w))
        lines.append(f"u{i}.wav\t{len(w)}")
    (tmp_path / "train.tsv").write_text("\n".join(lines) + "\n")
    for ftype in ("fbank", "mfcc", "logmel"):
        kw = dict(feature_type=ftype, batch_size=2, num_buckets=3)
        _same_batches(feats.FeatsIterator(Manifest.load(str(tmp_path / "train.tsv")),
                                          feats.FeatsConfig(**kw), seed=1),
                      jfeats.FeatsIterator(JManifest.load(str(tmp_path / "train.tsv")),
                                           jfeats.FeatsConfig(**kw), seed=1), 4)


def test_native_packer_matches_scan_and_jax():
    """The packer built from the port's source into its own build folder
    gives the Python scan's batches and JAX's."""
    from unispeech_tpu.data.batching import batch_by_size as jax_batch_by_size
    from unispeech_tpu_torch import native
    from unispeech_tpu_torch.data.batching import batch_by_size, batch_by_size_plain

    rng = np.random.default_rng(3)
    cases = [(np.sort(rng.integers(50, 5000, 333)), 20_000, 0, 4)]
    for _ in range(40):
        n = int(rng.integers(0, 300))
        cases.append((rng.integers(1, 2000, n), int(rng.integers(2000, 30_000)),
                      int(rng.integers(0, 12)), int(rng.integers(1, 9))))
    for sizes, mt, ms, mult in cases:
        idx = rng.permutation(len(sizes))
        ours = batch_by_size(idx, sizes, mt, ms, mult)
        for other in (batch_by_size_plain(idx, sizes, mt, ms, mult),
                      jax_batch_by_size(idx, sizes, mt, ms, mult)):
            assert len(ours) == len(other)
            for a, b in zip(ours, other):
                np.testing.assert_array_equal(a, b)
    lib = native.library_path()
    assert lib.exists() and lib.parent.name == "_build" \
        and lib.parent.parent.name == "unispeech_tpu_torch"
    with pytest.raises(AssertionError, match="exceeds"):
        batch_by_size(np.arange(3), np.asarray([5, 50, 5]), max_tokens=10)


def test_native_edit_distance_matches_scan_and_jax():
    from unispeech_tpu.decode.wer import edit_distance as jax_edit_distance
    from unispeech_tpu_torch.decode.wer import edit_distance, edit_distance_plain
    from unispeech_tpu_torch.native import edit_distance_batch_native

    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(60):
        a = rng.integers(0, 5, rng.integers(0, 25)).tolist()
        b = rng.integers(0, 5, rng.integers(0, 25)).tolist()
        d = edit_distance(a, b)
        assert d == edit_distance_plain(a, b) == jax_edit_distance(a, b)
        pairs.append((a, b))
    words = ("the", "cat", "sat", "on", "mat")
    a, b = list(rng.choice(words, 30)), list(rng.choice(words, 27))
    assert edit_distance(a, b) == edit_distance_plain(a, b) == jax_edit_distance(a, b)
    np.testing.assert_array_equal(edit_distance_batch_native(pairs),
                                  [edit_distance_plain(a, b) for a, b in pairs])


def _jax_draws(key, B, T, cfg, n_noise):
    """The draws JAX's ``mix_batch_device`` makes from ``key``, by name."""
    import jax

    k_sel, k_noise, k_part, k_len, k_cpos, k_spos, k_snr, k_nidx = jax.random.split(key, 8)
    d = {"u_sel": jax.random.uniform(k_sel, (B,)),
         "part": jax.random.randint(k_part, (B,), 0, B),
         "c_len": jax.random.randint(k_len, (B,), 0, cfg.max_overlap(T) + 1),
         "u_c": jax.random.uniform(k_cpos, (B,)), "u_s": jax.random.uniform(k_spos, (B,)),
         "snr_u": jax.random.uniform(k_snr, (B,))}
    if n_noise:
        d["u_noise"] = jax.random.uniform(k_noise, (B,))
        d["nidx"] = jax.random.randint(k_nidx, (B,), 0, n_noise)
    return {k: torch.as_tensor(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("noise,normalize", [(False, False), (True, True)])
def test_mix_batch_device_math_matches_jax(noise, normalize):
    import jax

    from unispeech_tpu.data.mixing import MixingConfig as JMixingConfig
    from unispeech_tpu.data.mixing import mix_batch_device as jax_mix
    from unispeech_tpu_torch.data.mixing import MixingConfig, mix_with_draws

    rng = np.random.default_rng(0)
    B, T = 16, 4000
    audio = rng.standard_normal((B, T)).astype(np.float32)
    audio[3] = 0.0  # a silent row: scale 0 as a partner
    clips = rng.standard_normal((5, T)).astype(np.float32) * 0.3 if noise else None
    kw = dict(mixing_prob=0.7, mixing_noise_prob=0.5 if noise else 0.0,
              normalize_after=normalize)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax_mix(key, audio, None, JMixingConfig(**kw), clips))
        draws = _jax_draws(key, B, T, JMixingConfig(**kw), 5 if noise else 0)
        out = mix_with_draws(torch.as_tensor(audio), draws, MixingConfig(**kw),
                             None if clips is None else torch.as_tensor(clips))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
        assert not np.array_equal(ref, audio)


def test_mix_batch_device_sampler():
    """The host draws follow their distributions (4 sigma on 8192 rows),
    and the mixer mixes exactly the rows its draws choose."""
    from unispeech_tpu_torch.data.mixing import MixingConfig, mix_batch_device, mixing_draws

    B, T = 8192, 1000
    cfg = MixingConfig(mixing_prob=0.3, mixing_noise_prob=0.4)
    d = mixing_draws(torch.Generator().manual_seed(0), B, T, cfg, n_noise=7)

    def near(x, mean, sd):
        assert abs(float(x) - mean) < 4 * sd / np.sqrt(B), (float(x), mean)

    near((d["u_sel"] < 0.3).float().mean(), 0.3, np.sqrt(0.3 * 0.7))
    near((d["u_noise"] < 0.4).float().mean(), 0.4, np.sqrt(0.4 * 0.6))
    m = cfg.max_overlap(T)
    near(d["c_len"].float().mean(), m / 2, np.sqrt(((m + 1) ** 2 - 1) / 12))
    assert int(d["c_len"].min()) == 0 and int(d["c_len"].max()) == m
    for k in ("u_c", "u_s", "snr_u"):
        near(d[k].mean(), 0.5, np.sqrt(1 / 12))
    counts = np.bincount(d["nidx"].numpy(), minlength=7)
    near(counts[0] / B, 1 / 7, np.sqrt(6 / 49))
    assert counts.min() > 0 and 0 <= int(d["part"].min()) and int(d["part"].max()) < B

    audio = torch.randn(64, T, generator=torch.Generator().manual_seed(1))
    out = mix_batch_device(torch.Generator().manual_seed(2), audio, None,
                           MixingConfig(mixing_prob=0.5))
    chosen = mixing_draws(torch.Generator().manual_seed(2), 64, T,
                          MixingConfig(mixing_prob=0.5))["u_sel"] < 0.5
    changed = (out != audio).any(-1)
    assert torch.equal(changed & ~chosen, torch.zeros_like(changed))
    assert changed.sum() > 16
    assert torch.equal(mix_batch_device(torch.Generator(), audio, None,
                                        MixingConfig(mixing_prob=0.0)), audio)


def test_noise_precut_matches_jax(tmp_path):
    from unispeech_tpu.data.mixing import NoiseStore as JNoiseStore
    from unispeech_tpu_torch.data.mixing import NoiseStore

    rng = np.random.default_rng(0)
    lines = [str(tmp_path)]
    for i, w in enumerate(_wavs(4, rng, 2000, 8000)):
        (tmp_path / f"n{i}.wav").write_bytes(_wav_bytes(w))
        lines.append(f"n{i}.wav\t{len(w)}")
    (tmp_path / "noise.tsv").write_text("\n".join(lines) + "\n")
    ours = NoiseStore(str(tmp_path / "noise.tsv")).precut(np.random.default_rng(9), 6, 5000)
    theirs = JNoiseStore(str(tmp_path / "noise.tsv")).precut(np.random.default_rng(9), 6, 5000)
    assert ours.shape == (6, 5000)
    np.testing.assert_array_equal(ours, theirs)


def test_data_package_exports_jax_names():
    import unispeech_tpu.data as jdata
    import unispeech_tpu_torch.data as data

    assert sorted(data.__all__) == sorted(jdata.__all__)
    for name in data.__all__:
        assert getattr(data, name).__module__.startswith("unispeech_tpu_torch."), name
