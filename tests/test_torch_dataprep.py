"""The port's data-prep subcommands ``libri-labels``, ``resample`` and
``cv-manifest`` against the JAX package's (``python -m unispeech_tpu.data``),
on the same inputs: every file they write equal byte for byte, in the style
of tests/test_dataprep_cli.py."""

import wave

import numpy as np
import pytest

from unispeech_tpu.data.__main__ import main as jax_data_cli
from unispeech_tpu_torch.data.__main__ import main as data_cli
from unispeech_tpu_torch.data.manifest import load_audio


def _write_wav(path, samples, rate=16000):
    pcm = np.clip(samples * 32767, -32768, 32767).astype(np.int16)
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def _same_files(a, b):
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert names and names == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_libri_labels_matches_jax(tmp_path):
    """A LibriSpeech layout (<spk>/<chap>/<spk>-<chap>-<utt>.wav beside
    <spk>-<chap>.trans.txt) of two speakers, through the port's manifest:
    the same .wrd and .ltr files as the JAX subcommand."""
    rng = np.random.default_rng(0)
    corpus = tmp_path / "corpus"
    for spk, chap, n in (("19", "198", 3), ("84", "121123", 2)):
        trans = []
        for u in range(n):
            _write_wav(corpus / spk / chap / f"{spk}-{chap}-{u:04d}.wav",
                       rng.standard_normal(3000 + 100 * u) * 0.1)
            trans.append(f"{spk}-{chap}-{u:04d} HELLO WORLD {u} IT'S {spk}")
        (corpus / spk / chap / f"{spk}-{chap}.trans.txt").write_text("\n".join(trans) + "\n")
    data_cli(["manifest", str(corpus), "--ext", "wav", "--dest", str(tmp_path),
              "--valid-percent", "0"])
    for main, out in ((data_cli, "port"), (jax_data_cli, "jax")):
        main(["libri-labels", str(tmp_path / "train.tsv"), "--output-dir", str(tmp_path / out),
              "--output-name", "train"])
    _same_files(tmp_path / "port", tmp_path / "jax")
    wrd = (tmp_path / "port" / "train.wrd").read_text().splitlines()
    ltr = (tmp_path / "port" / "train.ltr").read_text().splitlines()
    assert len(wrd) == len(ltr) == 5
    assert wrd[0] == "HELLO WORLD 0 IT'S 19"
    assert ltr[0] == "H E L L O | W O R L D | 0 | I T ' S | 1 9 |"


@pytest.mark.parametrize("rate", [22050, 8000, 16000])
def test_resample_matches_jax(tmp_path, rate):
    """Files at ``rate`` (one missing from the list's sources, one in a
    subdirectory) to 16 kHz: the same wav bytes and manifest as the JAX
    subcommand; a 1 kHz tone stays a 1 kHz tone."""
    src = tmp_path / "src"
    t = np.arange(rate) / rate
    _write_wav(src / "a.wav", 0.5 * np.sin(2 * np.pi * 1000 * t), rate=rate)
    rng = np.random.default_rng(rate)
    _write_wav(src / "sub" / "b.wav", rng.standard_normal(rate // 3) * 0.2, rate=rate)
    (tmp_path / "list.txt").write_text("a.wav\nmissing.wav\n\nsub/b.wav\n")
    for main, out in ((data_cli, "port"), (jax_data_cli, "jax")):
        main(["resample", "--wav-path", str(src), "--dest-path", str(tmp_path / out / "wav"),
              "--input", str(tmp_path / "list.txt"), "--output", str(tmp_path / out / "m.tsv")])
    port, jax_ = (tmp_path / "port" / "m.tsv").read_text(), (tmp_path / "jax" / "m.tsv").read_text()
    assert port.split("\n", 1)[1] == jax_.split("\n", 1)[1]  # the first line is the dest root
    (tmp_path / "port" / "m.tsv").unlink()
    (tmp_path / "jax" / "m.tsv").unlink()
    _same_files(tmp_path / "port", tmp_path / "jax")
    rows = port.splitlines()[1:]
    assert [r.split("\t")[0] for r in rows] == ["a.wav", "sub/b.wav"]
    assert int(rows[0].split("\t")[1]) == 16000
    y = load_audio(str(tmp_path / "port" / "wav" / "a.wav"), 16_000)
    ref = 0.5 * np.sin(2 * np.pi * 1000 * np.arange(16000) / 16000.0)
    assert np.corrcoef(y[2000:14000], ref[2000:14000])[0, 1] > 0.99


def test_cv_manifest_matches_jax(tmp_path):
    (tmp_path / "dev.tsv").write_text(
        "client_id\tpath\tsentence\tup_votes\nabc\tclip1.mp3\thello there\t2\n"
        "def\tclip2.mp3\tbye now\t0\nghi\tclip3.mp3\tça va ?\t1\n")
    for main, out in ((data_cli, "port"), (jax_data_cli, "jax")):
        main(["cv-manifest", str(tmp_path / "dev.tsv"), "--dest", str(tmp_path / out)])
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert (tmp_path / "port" / "dev.list").read_text().splitlines() == [
        "clip1.mp3", "clip2.mp3", "clip3.mp3"]
    assert (tmp_path / "port" / "dev.text").read_text().splitlines()[2] == "clip3.mp3\tça va ?"
