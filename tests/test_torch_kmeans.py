"""The port's k-means label pipeline against the JAX package's (CPU).

``mfcc_39`` and the k-means++ seeding are copied numpy: equal. The
mini-batch updates run in torch (fp32 matmuls, one-hot sums) against JAX's
jitted fp32 versions on the same batches in the same order: the same
assignments, so centroids within relative 1e-5 (fp32 sums of a few hundred
rows in other orders, then a running mean). Labels are compared where the
best two centroid scores differ by more than 1e-4, where fp32 rounding of
the scores cannot swap them. The CLI chain's files must be equal.
"""

import wave

import numpy as np
import pytest

from unispeech_tpu.tools import kmeans as jkm
from unispeech_tpu.tools.__main__ import main as jax_tools
from unispeech_tpu_torch.tools import kmeans as km
from unispeech_tpu_torch.tools.__main__ import main as torch_tools


def _write_wav(path, samples, rate=16000):
    pcm = np.clip(samples * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def _blobs(seed=0, n_batches=12, n=200, dim=6, k=5):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim)) * 4
    return [(centers[ids] + 0.5 * rng.standard_normal((n, dim))).astype(np.float32)
            for ids in (rng.integers(0, k, n) for _ in range(n_batches))]


@pytest.mark.parametrize("n", [399, 16000, 37123])
def test_mfcc_39_equals_jax(n):
    wav = (np.random.default_rng(n).standard_normal(n) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(km.mfcc_39(wav), jkm.mfcc_39(wav))


@pytest.mark.parametrize("subsample", [100_000, 100])
def test_kmeanspp_init_identical(subsample):
    x = np.random.default_rng(1).standard_normal((500, 5)).astype(np.float32)
    got = km._kmeanspp_init(x, 7, np.random.default_rng(3), subsample)
    want = jkm._kmeanspp_init(x, 7, np.random.default_rng(3), subsample)
    np.testing.assert_array_equal(got, want)


def test_learn_kmeans_matches_jax():
    batches = _blobs()
    got = km.learn_kmeans(batches, n_clusters=5, seed=2, epochs=2, device="cpu")
    want = jkm.learn_kmeans(batches, n_clusters=5, seed=2, epochs=2)
    assert got.centroids.dtype == np.float32
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=1e-5, atol=1e-6)


def test_apply_kmeans_matches_jax():
    batches = _blobs(seed=4)
    model = jkm.learn_kmeans(batches, n_clusters=5, seed=0, epochs=1)
    x = np.concatenate(batches)
    got = km.apply_kmeans(km.KmeansModel(model.centroids), x, device="cpu")
    want = jkm.apply_kmeans(model, x)
    c = model.centroids.astype(np.float64)
    scores = 2 * x @ c.T - (c * c).sum(-1)
    top2 = np.sort(scores, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])


def test_kmeans_model_and_label_file_round_trip(tmp_path):
    model = km.KmeansModel(np.arange(6, dtype=np.float32).reshape(3, 2))
    model.save(str(tmp_path / "km.npy"))
    np.testing.assert_array_equal(km.KmeansModel.load(str(tmp_path / "km.npy")).centroids,
                                  model.centroids)
    km.write_label_file(str(tmp_path / "a.km"), [np.asarray([1, 2, 3]), np.asarray([4])])
    jkm.write_label_file(str(tmp_path / "b.km"), [np.asarray([1, 2, 3]), np.asarray([4])])
    assert (tmp_path / "a.km").read_text() == (tmp_path / "b.km").read_text() == "1 2 3\n4\n"


def test_cli_chain_equals_jax(tmp_path):
    """dump-features --feature mfcc (2 shards) -> learn-kmeans -> dump-labels
    (2 shards), the port with --device cpu against the JAX CLI."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(5):
        n = int(rng.integers(8000, 24000))
        _write_wav(tmp_path / f"u{i}.wav", rng.standard_normal(n) * 0.1)
        rows.append(f"u{i}.wav\t{n}")
    tsv = tmp_path / "train.tsv"
    tsv.write_text(f"{tmp_path}\n" + "\n".join(rows) + "\n")

    def chain(main, side, *dev):
        d = tmp_path / side
        for rank in (0, 1):
            main(["dump-features", "--manifest", str(tsv), "--feat-dir", str(d / "feat"),
                  "--nshard", "2", "--rank", str(rank), *dev])
        main(["learn-kmeans", "--feat-dir", str(d / "feat"), "--nshard", "2",
              "--n-clusters", "8", "--percent", "0.9", "--km-path", str(d / "km.npy"), *dev])
        for rank in (0, 1):
            main(["dump-labels", "--manifest", str(tsv), "--km-path", str(d / "km.npy"),
                  "--lab-dir", str(d / "lab"), "--nshard", "2", "--rank", str(rank), *dev])
        return d

    j = chain(jax_tools, "jax")
    t = chain(torch_tools, "torch", "--device", "cpu")
    for stem in ("train_0_2", "train_1_2"):
        np.testing.assert_array_equal(np.load(t / "feat" / f"{stem}.npy"),
                                      np.load(j / "feat" / f"{stem}.npy"))
        assert (t / "feat" / f"{stem}.len").read_text() == (j / "feat" / f"{stem}.len").read_text()
        assert (t / "lab" / f"{stem}.km").read_text() == (j / "lab" / f"{stem}.km").read_text()
    np.testing.assert_allclose(np.load(t / "km.npy"), np.load(j / "km.npy"), rtol=1e-5,
                               atol=1e-5)
    lines = (t / "lab" / "train_0_2.km").read_text().splitlines()
    lens = [int(n) for n in (t / "feat" / "train_0_2.len").read_text().split()]
    assert [len(l.split()) for l in lines] == lens


def test_default_device_needs_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    np.save(tmp_path / "x_0_1.npy", np.zeros((4, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_tools(["learn-kmeans", "--feat-dir", str(tmp_path), "--split", "x",
                     "--n-clusters", "2", "--km-path", str(tmp_path / "km.npy")])
