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
