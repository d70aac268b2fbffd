"""The port's data pipeline against the JAX package's (host numpy, CPU).

Everything here is host code copied from the JAX package, so every
comparison is exact: equal arrays, equal batches bit for bit, equal files.
The JAX package's batch packer may run its native build; the port's Python
scan must give the same batches.
"""

import io
import struct
import time
import wave
import zipfile

import numpy as np
import pytest

from unispeech_tpu.data import batching as jbatching
from unispeech_tpu.data import labels as jlabels
from unispeech_tpu.data import prefetch as jprefetch
from unispeech_tpu.data.__main__ import main as jax_data_cli
from unispeech_tpu.data.dictionary import Dictionary as JDictionary
from unispeech_tpu.data.dataset import DataConfig as JDataConfig
from unispeech_tpu.data.dataset import FinetuneIterator as JFinetuneIterator
from unispeech_tpu.data.dataset import PretrainIterator as JPretrainIterator
from unispeech_tpu.data.labels import LabelFile as JLabelFile
from unispeech_tpu.data.manifest import Manifest as JManifest
from unispeech_tpu.data.manifest import create_manifest as jax_create_manifest
from unispeech_tpu.data.mixing import MixingConfig as JMixingConfig
from unispeech_tpu.data.mixing import NoiseStore as JNoiseStore
from unispeech_tpu.data.mixing import mix_batch_host as jax_mix
from unispeech_tpu.data import multilingual as jmultilingual
from unispeech_tpu_torch.data import batching, labels, prefetch
from unispeech_tpu_torch.data.__main__ import main as data_cli
from unispeech_tpu_torch.data.dataset import DataConfig, FinetuneIterator, PretrainIterator
from unispeech_tpu_torch.data.dictionary import Dictionary
from unispeech_tpu_torch.data.labels import LabelFile
from unispeech_tpu_torch.data.manifest import Manifest, create_manifest
from unispeech_tpu_torch.data.mixing import MixingConfig, NoiseStore, mix_batch_host
from unispeech_tpu_torch.data import multilingual

FRAME_HOP = 320


def frames(n):  # the default frontend's frame count
    for k, s in ((10, 5),) + ((3, 2),) * 4 + ((2, 2),) * 2:
        n = (n - k) // s + 1
    return n


def _wav_bytes(wav, rate=16000):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.clip(wav * 32767, -32768, 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _corpus(tmp_path, n=11, lo=8000, hi=40000, seed=0, zipped=False):
    """Wav files (or stored-zip slices in two archives) of random lengths,
    a manifest and a 50 Hz label file with a few labels short."""
    rng = np.random.default_rng(seed)
    rows = []
    wavs = [rng.standard_normal(int(rng.integers(lo, hi))) * 0.1 for _ in range(n)]
    if zipped:
        for s, part in enumerate((wavs[: n // 2], wavs[n // 2:])):
            path = tmp_path / f"s{s}.zip"
            with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
                for i, w in enumerate(part):
                    z.writestr(f"utt{i}.wav", _wav_bytes(w))
            with zipfile.ZipFile(path) as z, open(path, "rb") as f:
                for info, w in zip(z.infolist(), part):
                    f.seek(info.header_offset + 26)
                    n_name, n_extra = struct.unpack("<HH", f.read(4))
                    off = info.header_offset + 30 + n_name + n_extra
                    rows.append(f"s{s}.zip:{off}:{info.file_size}\t{len(w)}")
    else:
        for i, w in enumerate(wavs):
            (tmp_path / f"u{i:02d}.wav").write_bytes(_wav_bytes(w))
            rows.append(f"u{i:02d}.wav\t{len(w)}")
    (tmp_path / "train.tsv").write_text(f"{tmp_path}\n" + "\n".join(rows) + "\n")
    lab_lines = []
    for i, w in enumerate(wavs):
        n_lab = len(w) * 50 // 16000 - (3 if i % 4 == 1 else 0)
        lab_lines.append(" ".join(str(x) for x in rng.integers(0, 100, n_lab)))
    (tmp_path / "train.km").write_text("\n".join(lab_lines) + "\n")
    return tmp_path


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------- labels
def test_label_file_and_alignment_match_jax(tmp_path, caplog):
    d = _corpus(tmp_path)
    lf, jlf = LabelFile(str(d / "train.km"), 50.0), JLabelFile(str(d / "train.km"), 50.0)
    assert len(lf) == len(jlf) == 11 and lf.offsets == jlf.offsets
    rng = np.random.default_rng(3)
    for i in range(len(lf)):
        lab = lf.get(i)
        np.testing.assert_array_equal(lab, jlf.get(i))
        start, n = int(rng.integers(0, 4000)), int(rng.integers(2000, 30000))
        crop = labels.crop_labels(lab, start, n, 16000, 50.0)
        np.testing.assert_array_equal(crop, jlabels.crop_labels(lab, start, n, 16000, 50.0))
        for ratio, s0 in ((0.5, 0), (1.0, 3), (2.0, 1)):
            got = labels.align_labels_to_frames(crop, frames(n), ratio, start_frame=s0)
            want = jlabels.align_labels_to_frames(crop, frames(n), ratio, start_frame=s0)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
    sizes, lens = [16000, 32000, 8000], [50, 90, 25]
    caplog.set_level("WARNING")
    labels.verify_label_lengths(sizes, lens, 16000, 50.0)
    ours = [r.getMessage() for r in caplog.records]
    caplog.clear()
    jlabels.verify_label_lengths(sizes, lens, 16000, 50.0)
    assert ours == [r.getMessage() for r in caplog.records] and len(ours) == 2


# -------------------------------------------------------------- batching
@pytest.mark.parametrize("max_tokens,max_sentences,mult", [
    (40_000, 0, 1), (40_000, 3, 1), (100_000, 0, 4), (0, 5, 2)])
def test_batch_by_size_matches_jax(max_tokens, max_sentences, mult):
    rng = np.random.default_rng(max_tokens + max_sentences + mult)
    sizes = rng.integers(1000, 20000, 300)
    idx = rng.permutation(300)
    got = batching.batch_by_size(idx, sizes[idx], max_tokens, max_sentences, mult)
    want = jbatching.batch_by_size(idx, sizes[idx], max_tokens, max_sentences, mult)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(AssertionError, match="exceeds max_tokens"):
        batching.batch_by_size(idx, sizes[idx], max_tokens=999)


def test_buckets_orders_and_shards_match_jax():
    rng = np.random.default_rng(5)
    sizes = rng.integers(16000, 250000, 200)
    for args in ((250000,), (250000, 32000, 8, 320), (64000, 16000, 4, 160)):
        np.testing.assert_array_equal(batching.length_buckets(*args),
                                      jbatching.length_buckets(*args))
    b = batching.length_buckets(250000, 32000, 8)
    np.testing.assert_array_equal(batching.bucket_for(sizes, b), jbatching.bucket_for(sizes, b))
    for kw in (dict(), dict(shuffle=False), dict(chunk_size=16)):
        for epoch in (1, 2):
            np.testing.assert_array_equal(batching.ordered_indices(sizes, 7, epoch, **kw),
                                          jbatching.ordered_indices(sizes, 7, epoch, **kw))
    cids = np.where(np.arange(200) % 17 == 0, -1, np.repeat(np.arange(14), 15)[:200])
    for epoch in (1, 2):
        np.testing.assert_array_equal(
            batching.chunk_shuffled_indices(sizes, cids, 3, epoch, 100000, group=4),
            jbatching.chunk_shuffled_indices(sizes, cids, 3, epoch, 100000, group=4))
    batches = [np.arange(i, i + 2) for i in range(11)]
    for n, s in ((1, 0), (3, 1), (4, 3)):
        got, want = batching.shard_batches(batches, n, s), jbatching.shard_batches(batches, n, s)
        assert [b.tolist() for b in got] == [b.tolist() for b in want]


# -------------------------------------------------------------- prefetch
@pytest.mark.parametrize("mod", [prefetch, jprefetch], ids=["port", "jax"])
def test_prefetch_order_and_exceptions(mod):
    assert list(mod.prefetch(iter(range(100)), depth=3)) == list(range(100))

    def bad():
        yield 1
        yield 2
        raise ValueError("boom")

    it = mod.prefetch(bad(), depth=4)
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(ValueError, match="boom"):
        next(it)
    assert mod.parallel_map_io(lambda x: x * x, list(range(50)), workers=8) == [
        x * x for x in range(50)]
    assert mod.parallel_map_io(str, [3], workers=8) == ["3"]


def test_prefetch_close_stops_producer():
    produced = []

    def src():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = prefetch.PrefetchIterator(src(), depth=2)
    next(it)
    it.close()
    time.sleep(0.7)
    n = len(produced)
    time.sleep(0.7)
    assert len(produced) == n and n < 10


# ---------------------------------------------------------------- mixing
@pytest.mark.parametrize("over", [
    dict(), dict(mixing_prob=1.0, mixing_num=2, normalize_after=True),
    dict(mixing_prob=0.7, mixing_noise_prob=0.5, mixing_max_len=3)])
def test_mix_batch_host_equals_jax(tmp_path, over):
    d = _corpus(tmp_path, n=4)
    rng = np.random.default_rng(11)
    audio = (rng.standard_normal((6, 20000)) * 0.1).astype(np.float32)
    audio[2] = 0.0  # a silent row: scale 0
    cfg, jcfg = MixingConfig(**over), JMixingConfig(**over)
    noise, jnoise = NoiseStore(str(d / "train.tsv")), JNoiseStore(str(d / "train.tsv"))
    clips = [rng.standard_normal(9000).astype(np.float32) * 0.05 for _ in range(3)]
    for kw, jkw in ((dict(noise=noise), dict(noise=jnoise)),
                    (dict(noise_clips=clips), dict(noise_clips=clips)), ({}, {})):
        got = mix_batch_host(np.random.default_rng(4), audio, None, cfg, **kw)
        want = jax_mix(np.random.default_rng(4), audio, None, jcfg, **jkw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- iterator
def _iterators(d, over=None, mixing=None, noise=False, label_files=True):
    over = dict(dict(max_sample_size=32000, min_sample_size=9000, max_tokens=70000,
                     num_buckets=4, required_batch_size_multiple=2), **(over or {}))
    pair = []
    for Man, Cfg, LF, Mix, Noise, It in (
            (Manifest, DataConfig, LabelFile, MixingConfig, NoiseStore, PretrainIterator),
            (JManifest, JDataConfig, JLabelFile, JMixingConfig, JNoiseStore,
             JPretrainIterator)):
        man = Man.load(str(d / "train.tsv"))
        pair.append(It(man, Cfg(**over),
                       label_files=[LF(str(d / "train.km"), 50.0)] if label_files else (),
                       frame_hop=FRAME_HOP, frames_fn=frames,
                       mixing=None if mixing is None else Mix(**mixing),
                       noise=Noise(str(d / "train.tsv")) if noise else None, seed=3))
    return pair


@pytest.mark.parametrize("case", ["plain", "mixing", "noise_normalize", "batch_by_size",
                                  "zip", "no_labels"])
def test_pretrain_iterator_bit_identical_over_two_epochs(tmp_path, case):
    """Two epochs from __iter__, fixed-shape padding rows included."""
    kw = dict(plain={}, mixing=dict(mixing=dict(mixing_prob=0.5)),
              noise_normalize=dict(mixing=dict(mixing_prob=0.8, mixing_noise_prob=0.5),
                                   noise=True, over=dict(normalize=True)),
              batch_by_size=dict(over=dict(fixed_shapes=False)),
              zip={}, no_labels=dict(label_files=False))[case]
    d = _corpus(tmp_path, zipped=case == "zip")
    it, jit = _iterators(d, **kw)
    n_plan = len(jit._plan(1)) + len(jit._plan(2))
    padded = 0
    for got, want in zip(iter(it), iter(jit)):
        _assert_batches_equal(got, want)
        padded += int((want["lengths"] == 0).sum())
        n_plan -= 1
        if n_plan == 0:
            break
    assert n_plan == 0 and it.state_dict() == jit.state_dict() == dict(epoch=2,
                                                                        batch_offset=len(
                                                                            jit._plan(2)))
    if case in ("plain", "zip"):
        assert padded > 0  # fixed_shapes padded some batch with zero rows
    if case == "zip":
        assert it.manifest.chunk_ids() is not None
        np.testing.assert_array_equal(it.manifest.chunk_ids(), jit.manifest.chunk_ids())


def test_pretrain_iterator_targets_clamped_and_valid(tmp_path):
    it, _ = _iterators(_corpus(tmp_path))
    seen_invalid = False
    for b in it.epoch_batches(1):
        assert b["targets"].min() >= 0 and b["targets"].dtype == np.int32
        assert b["target_valid"].shape == b["targets"].shape
        assert b["source"].shape[0] == it.fixed_bsz(b["source"].shape[1])
        pad = b["lengths"] == 0
        assert not b["target_valid"][pad].any() and not b["source"][pad].any()
        seen_invalid |= bool((b["target_valid"][~pad] == 0).any())
    assert seen_invalid  # the short label lines leave frames without labels


def test_load_state_dict_resume_gives_the_same_next_batch(tmp_path):
    d = _corpus(tmp_path)
    it, _ = _iterators(d)
    stream = iter(it)
    n_first = len(it._plan(1))
    for _ in range(n_first + 1):  # into the second epoch
        next(stream)
    state = it.state_dict()
    want = next(stream)
    fresh, jfresh = _iterators(d)
    fresh.load_state_dict(state)
    jfresh.load_state_dict(state)
    _assert_batches_equal(next(iter(fresh)), want)
    _assert_batches_equal(next(iter(jfresh)), want)


@pytest.mark.parametrize("fixed_shapes", [True, False], ids=["fixed", "batch_by_size"])
def test_finetune_iterator_bit_identical_over_two_epochs(tmp_path, fixed_shapes):
    """FinetuneIterator's batches (audio, lengths, pad-filled labels, label
    lengths; under fixed shapes one label length S for the dataset and the
    zero-length padding rows) equal the JAX package's over two epochs. An
    utterance longer than max_sample_size is cropped and keeps its whole
    transcript, in both packages."""
    d = _corpus(tmp_path)
    man = Manifest.load(str(d / "train.tsv"))
    rng = np.random.default_rng(4)
    letters = Dictionary.letters().symbols[4:]
    texts = [" ".join(rng.choice(letters, max(1, int(n) * 15 // 16000)))
             for n in man.sizes]
    texts[2] = ""  # an empty transcript
    over = dict(max_sample_size=32000, min_sample_size=9000, max_tokens=70000, num_buckets=4,
                required_batch_size_multiple=2, fixed_shapes=fixed_shapes)
    it = FinetuneIterator(man, DataConfig(**over), texts, Dictionary.letters(),
                          frame_hop=FRAME_HOP, frames_fn=frames, seed=3)
    jit = JFinetuneIterator(JManifest.load(str(d / "train.tsv")), JDataConfig(**over), texts,
                            JDictionary.letters(), frame_hop=FRAME_HOP, frames_fn=frames,
                            seed=3)
    enc = [Dictionary.letters().encode_line(t) for t in texts]
    n_plan = len(jit._plan(1)) + len(jit._plan(2))
    padded = cropped = 0
    widths = set()
    for got, want in zip(iter(it), iter(jit)):
        _assert_batches_equal(got, want)
        assert sorted(want) == ["label_lengths", "labels", "lengths", "source"]
        widths.add(want["labels"].shape[1])
        pad = want["lengths"] == 0
        padded += int(pad.sum())
        assert not want["label_lengths"][pad].any()
        assert (want["labels"][pad] == Dictionary.letters().pad()).all()
        for r in np.flatnonzero(want["lengths"] == over["max_sample_size"]):
            row = [i for i in range(len(texts)) if len(enc[i]) == want["label_lengths"][r]
                   and man.sizes[i] > over["max_sample_size"]]
            cropped += bool(row)
        n_plan -= 1
        if n_plan == 0:
            break
    assert n_plan == 0 and it.state_dict() == jit.state_dict()
    assert cropped > 0  # cropped rows kept their whole transcripts
    if fixed_shapes:
        longest = max(len(e) for e in enc)
        assert padded > 0 and widths == {int(np.ceil(longest / 8) * 8)}
    with pytest.raises(ValueError):
        FinetuneIterator(man, DataConfig(**over), texts[:-1], Dictionary.letters())


# ----------------------------------------------------------- multilingual
def _languages(tmp_path):
    """Three per-language corpora of 6, 3 and 1 utterances (one too short to
    keep), each with its own root, manifest and letter transcripts."""
    mans, texts = [], []
    letters = Dictionary.letters().symbols[4:]
    for li, n in enumerate((6, 3, 2)):
        d = tmp_path / f"lang{li}"
        d.mkdir()
        _corpus(d, n=n, seed=li)
        if li == 2:  # a language with one row under min_sample_size
            lines = (d / "train.tsv").read_text().splitlines()
            (d / "train.tsv").write_text("\n".join(lines[:2] + [lines[2].split("\t")[0]
                                                                + "\t4000"]) + "\n")
        mans.append(str(d / "train.tsv"))
        rng = np.random.default_rng(li)
        texts += [" ".join(rng.choice(letters, 10)) for _ in range(n)]
    return mans, texts


def test_concat_manifests_and_ratios_match_jax(tmp_path):
    mans, _ = _languages(tmp_path)
    man, groups = multilingual.concat_manifests([Manifest.load(p) for p in mans])
    jman, jgroups = jmultilingual.concat_manifests([JManifest.load(p) for p in mans])
    assert man.root == jman.root and man.paths == jman.paths
    np.testing.assert_array_equal(man.sizes, jman.sizes)
    for g, jg in zip(groups, jgroups):
        np.testing.assert_array_equal(g, jg)
    for alpha in (1.0, 0.5, 0.2):
        lengths = np.asarray([6, 3, 1])
        np.testing.assert_array_equal(multilingual.multilang_sample_probs(lengths, alpha),
                                      jmultilingual.multilang_sample_probs(lengths, alpha))
        np.testing.assert_array_equal(multilingual.multilang_size_ratios(lengths, alpha),
                                      jmultilingual.multilang_size_ratios(lengths, alpha))
        for r in multilingual.multilang_size_ratios(lengths, alpha):
            np.testing.assert_array_equal(
                multilingual.resampled_rows(np.arange(10, 16), r, 3, 2, 1),
                jmultilingual.resampled_rows(np.arange(10, 16), r, 3, 2, 1))


@pytest.mark.parametrize("kind", ["pretrain", "finetune"])
def test_multilingual_iterators_bit_identical_over_two_epochs(tmp_path, kind):
    """lang_groups with multilang_alpha 0.5 (the low-resource languages
    upsampled, with replacement): the same batches as the JAX iterators over
    two epochs, and the epochs' row multisets differ."""
    mans, texts = _languages(tmp_path)
    over = dict(max_sample_size=32000, min_sample_size=9000, max_tokens=70000, num_buckets=4,
                required_batch_size_multiple=2)
    its = []
    for mod, Man, Cfg, It, Dic in (
            (multilingual, Manifest, DataConfig,
             PretrainIterator if kind == "pretrain" else FinetuneIterator, Dictionary),
            (jmultilingual, JManifest, JDataConfig,
             JPretrainIterator if kind == "pretrain" else JFinetuneIterator, JDictionary)):
        man, groups = mod.concat_manifests([Man.load(p) for p in mans])
        kw = dict(frame_hop=FRAME_HOP, frames_fn=frames, seed=3, lang_groups=groups,
                  multilang_alpha=0.5)
        its.append(It(man, Cfg(**over), **kw) if kind == "pretrain"
                   else It(man, Cfg(**over), texts, Dic.letters(), **kw))
    it, jit = its
    assert sorted(it._epoch_rows(1).tolist()) != sorted(it._epoch_rows(2).tolist())
    n_plan = len(jit._plan(1)) + len(jit._plan(2))
    for got, want in zip(iter(it), iter(jit)):
        _assert_batches_equal(got, want)
        n_plan -= 1
        if n_plan == 0:
            break
    assert n_plan == 0 and it.state_dict() == jit.state_dict()


@pytest.mark.parametrize("kind", ["pretrain", "finetune"])
def test_iterator_without_rows_raises(tmp_path, kind):
    """No row reaches min_sample_size: iterating raises ValueError, where the
    JAX package plans empty epochs forever. SIGALRM bounds the test at 20 s,
    so a regression fails instead of hanging the suite."""
    import signal

    d = _corpus(tmp_path, n=3)
    man = Manifest.load(str(d / "train.tsv"))
    cfg = DataConfig(min_sample_size=10 ** 6)
    it = (PretrainIterator(man, cfg) if kind == "pretrain"
          else FinetuneIterator(man, cfg, ["A B"] * 3, Dictionary.letters()))

    def hung(*_):
        raise TimeoutError("the iterator plans empty epochs without end")

    old = signal.signal(signal.SIGALRM, hung)
    signal.alarm(20)
    try:
        with pytest.raises(ValueError, match="min_sample_size"):
            next(iter(it))
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# -------------------------------------------------------------- manifests
def test_create_manifest_and_save_match_jax(tmp_path):
    (tmp_path / "c").mkdir()
    d = _corpus(tmp_path / "c", n=9)
    (d / "sub").mkdir()
    (d / "sub" / "x.wav").write_bytes(_wav_bytes(np.zeros(5000)))
    for pct in (0.0, 0.4):
        got, jgot = create_manifest(str(d), ext="wav", valid_percent=pct, seed=5), \
            jax_create_manifest(str(d), ext="wav", valid_percent=pct, seed=5)
        for m, jm in zip(got, jgot):
            assert (m is None) == (jm is None)
            if m is None:
                continue
            assert (m.root, m.paths, m.sizes.tolist()) == (jm.root, jm.paths, jm.sizes.tolist())
            m.save(str(tmp_path / "a.tsv"))
            jm.save(str(tmp_path / "b.tsv"))
            assert (tmp_path / "a.tsv").read_text() == (tmp_path / "b.tsv").read_text()
        assert (got[1] is None) == (pct == 0.0)


def test_manifest_cli_matches_jax(tmp_path):
    (tmp_path / "c").mkdir()
    d = _corpus(tmp_path / "c", n=7)
    for main, dest in ((data_cli, "port"), (jax_data_cli, "jax")):
        main(["manifest", str(d), "--ext", "wav", "--valid-percent", "0.3", "--seed", "2",
              "--dest", str(tmp_path / dest)])
    for name in ("train.tsv", "valid.tsv"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert len((tmp_path / "port" / "train.tsv").read_text().splitlines()) > 1
    # the other data-prep subcommands are ported (tests/test_torch_dataprep.py):
    # they parse their own flags and reject others
    for sub in ("libri-labels", "resample", "cv-manifest"):
        with pytest.raises(SystemExit) as e:
            data_cli([sub, "--any", "x"])
        assert e.value.code == 2


# ------------------------------------------------------------ seq2seq, LM
@pytest.mark.parametrize("fixed_shapes", [True, False], ids=["fixed", "batch_by_size"])
def test_seq2seq_iterator_bit_identical_over_two_epochs(tmp_path, fixed_shapes):
    """Seq2SeqIterator's batches (eos-shifted prev_tokens, eos-terminated
    targets, target_mask, S = labels + 1 in multiples of 8) equal the JAX
    package's over two epochs, and so do the iterator states. The one
    difference is ROADMAP 3.15: JAX gives each zero-length padding row (fixed
    shapes only) one eos target, the port none."""
    from unispeech_tpu.data.dataset import Seq2SeqIterator as JSeq2SeqIterator
    from unispeech_tpu_torch.data.dataset import Seq2SeqIterator

    d = _corpus(tmp_path)
    man = Manifest.load(str(d / "train.tsv"))
    rng = np.random.default_rng(5)
    letters = Dictionary.letters().symbols[4:]
    texts = [" ".join(rng.choice(letters, max(1, int(n) * 15 // 16000))) for n in man.sizes]
    texts[3] = ""
    over = dict(max_sample_size=32000, min_sample_size=9000, max_tokens=70000, num_buckets=4,
                required_batch_size_multiple=2, fixed_shapes=fixed_shapes)
    it = Seq2SeqIterator(man, DataConfig(**over), texts, Dictionary.letters(),
                         frame_hop=FRAME_HOP, frames_fn=frames, seed=3)
    jit = JSeq2SeqIterator(JManifest.load(str(d / "train.tsv")), JDataConfig(**over), texts,
                           JDictionary.letters(), frame_hop=FRAME_HOP, frames_fn=frames, seed=3)
    n_plan = len(jit._plan(1)) + len(jit._plan(2))
    padded = 0
    for got, want in zip(iter(it), iter(jit)):
        assert sorted(want) == ["lengths", "prev_tokens", "source", "target_mask", "targets"]
        zero = want["lengths"] == 0
        padded += int(zero.sum())
        want = dict(want, target_mask=np.where(zero[:, None], 0.0,
                                               want["target_mask"]).astype(np.float32))
        _assert_batches_equal(got, want)
        assert got["targets"].shape[1] % 8 == 0
        np.testing.assert_array_equal(got["prev_tokens"][:, 0], Dictionary.letters().eos())
        n_plan -= 1
        if n_plan == 0:
            break
    assert n_plan == 0 and it.state_dict() == jit.state_dict()
    assert (padded > 0) == fixed_shapes


def _lm_corpus(tmp_path, n_lines=60, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(30)]
    lines = [" ".join(rng.choice(words, int(rng.integers(1, 12)))) for _ in range(n_lines)]
    lines[5] = ""  # an empty line is skipped
    lines[7] = "oov_word w1"
    (tmp_path / "corpus.txt").write_text("\n".join(lines) + "\n")
    d = Dictionary()
    for w in words:
        d.add_symbol(w)
    d.save(str(tmp_path / "dict.txt"))
    return tmp_path / "corpus.txt", tmp_path / "dict.txt"


def test_lm_iterator_bit_identical_over_two_epochs(tmp_path):
    """tokenize_corpus, TokenBlockDataset and LMIterator equal the JAX
    package's: the flat ids, every block, the batches over two epochs (a
    short tail block padded), the iterator state, and a resume from it."""
    from unispeech_tpu.data import lm_dataset as jlm_data
    from unispeech_tpu_torch.data import lm_dataset

    corpus, dpath = _lm_corpus(tmp_path)
    toks = lm_dataset.tokenize_corpus(str(corpus), Dictionary.load(str(dpath)))
    jtoks = jlm_data.tokenize_corpus(str(corpus), JDictionary.load(str(dpath)))
    np.testing.assert_array_equal(toks, jtoks)
    assert toks.dtype == jtoks.dtype == np.int32 and (toks == 3).any()  # <unk>
    ds, jds = lm_dataset.TokenBlockDataset(toks, 16), jlm_data.TokenBlockDataset(jtoks, 16)
    assert len(ds) == len(jds) > 8
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i], jds[i])
    it = lm_dataset.LMIterator(ds, batch_size=4, padding_idx=1, seed=7)
    jit = jlm_data.LMIterator(jds, batch_size=4, padding_idx=1, seed=7)
    n = 2 * (len(ds) // 4)
    stream, jstream = iter(it), iter(jit)
    for k in range(n):
        got, want = next(stream), next(jstream)
        _assert_batches_equal(got, want)
        np.testing.assert_array_equal(got["tokens"][:, 1:], got["targets"][:, :-1])
        assert it.state_dict() == jit.state_dict()
        if k == n // 2:
            state = it.state_dict()
            resumed = lm_dataset.LMIterator(ds, batch_size=4, padding_idx=1, seed=7)
            resumed.load_state_dict(state)
            after = next(iter(resumed))
    want_after = next(iter(_resumed(jlm_data, jds, state)))
    _assert_batches_equal(after, want_after)
    with pytest.raises(ValueError):
        next(iter(lm_dataset.LMIterator(ds, batch_size=len(ds) + 1, padding_idx=1)))


def _resumed(mod, ds, state):
    it = mod.LMIterator(ds, batch_size=4, padding_idx=1, seed=7)
    it.load_state_dict(state)
    return it


@pytest.mark.parametrize("encoder", ["none", "byte"])
def test_binarized_files_byte_identical_both_ways(tmp_path, encoder):
    """data binarize-text of the port and of the JAX package write the same
    .bin and .idx.npz bytes (through --encoder byte too), and each package's
    MMapIndexedDataset reads the other's files to the same sentences."""
    from unispeech_tpu.data.indexed_dataset import MMapIndexedDataset as JMMap
    from unispeech_tpu_torch.data.indexed_dataset import MMapIndexedDataset

    corpus, dpath = _lm_corpus(tmp_path)
    if encoder == "byte":
        from unispeech_tpu_torch.data.text_encoders import ByteEncoder

        enc = ByteEncoder()
        d = Dictionary()
        for line in corpus.read_text().splitlines():
            for tok in enc.encode(line).split():
                d.add_symbol(tok)
        dpath = tmp_path / "byte_dict.txt"
        d.save(str(dpath))
    for main, stem in ((data_cli, "port"), (jax_data_cli, "jax")):
        main(["binarize-text", "--corpus", str(corpus), "--dict", str(dpath), "--out",
              str(tmp_path / "bin" / stem), "--encoder", encoder])
    for ext in (".bin", ".idx.npz"):
        a = (tmp_path / "bin" / f"port{ext}").read_bytes()
        assert a == (tmp_path / "bin" / f"jax{ext}").read_bytes(), ext
    port, jx = MMapIndexedDataset(str(tmp_path / "bin" / "jax")), JMMap(str(tmp_path / "bin" / "port"))
    assert len(port) == len(jx) == 59  # the empty line skipped
    for i in range(len(port)):
        np.testing.assert_array_equal(port[i], jx[i])
    np.testing.assert_array_equal(port.flat, jx.flat)
    assert port[0][-1] == Dictionary().eos()
